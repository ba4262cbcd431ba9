// bounce_step.cu — one fused bounce of the regeneration pool, for sm_90a.
//
// Replaces the Pallas TPU megakernel
//     scheme_raytrace_tpu/integrator/bounce.py:as_pallas  (its body: step)
// with all of it: regeneration of fresh lanes' camera rays from PCG4D
// draws, the oriented-plane rect sweep, the sphere sweep (static and moving
// spheres, any count), the sphere trace of the Kleinian limit set and the
// bezier ribbons' Newton-on-seeds probe with the closest-hit material pick
// (each built in only for the plans that have it), constant media that
// scatter before
// the closest solid hit, the sky on a
// miss, constant, checker, hash-Perlin noise and marble and image-texel
// albedo, emission, mixture-PDF light sampling over xz-rect and sphere
// lights (or the plain cosine lobe), and the lambertian / metal /
// dielectric scatter rules.
// Its plain PyTorch twin is scheme_raytrace_torch/integrator/bounce.py:step,
// which follows the JAX step op for op.  The lane body (bounce_lane) and
// the device functions live in bounce_common.cuh, which the backward kernel
// (bounce_step_bwd.cu) shares so that it replays each lane exactly as this
// kernel ran it, and the packed and persistent kernels share so that they
// trace the same paths.
//
// Design.  A tile of w consecutive threads of a warp carries one lane (w =
// 1, 2, 4 or 8, a kernel argument: integrator/bounce.py tile_width), 256
// threads per block.  The closest-hit sweeps split over the tile: thread r
// probes rects and spheres r, r + w, ... and the r-th run of each ribbon's
// seeds, folding its share in pack order with the strict `<`, and the tile
// combines the shares with xor shuffles (bounce_common.cuh Tile): the first
// minimum of (t, pack offset) for rects and spheres, the seed records joined
// in seed order for a ribbon.  That is the sequential sweep's winner, ties
// included, so every w gives w = 1's outputs bit for bit.  The klein march,
// the media and the shading run on every thread of the tile, on the same
// values, and the tile's first thread stores.  K3 and K4 run the same tile.
// Every lane reads and writes its own SoA columns (19 in, 14 out).  The
// packed scene `pk` (P floats, 506 for Cornell) is read at plan offsets
// through the read-only data cache: every thread of a warp reads the same
// address, which the cache broadcasts; this
// takes the place of the TPU kernel's SMEM scalar view (_SmemPk).  The
// plan's statics are kernel arguments.  Rects, then spheres, are swept in
// pack order with the strict `<` of _merge_rec, so ties keep the first
// primitive as on the TPU; the sweep keeps only (t, winner offset) and reads
// the winner's material once after the loop, which gives the same values as
// the running merge.  That is the TPU kernel's slim sweep by construction:
// the winner's attributes are an indexed load of its pk row, so there is one
// sphere loop for any count (no unroll threshold, no chunking) and the
// attribute atlas is never read.  An image texel is one indexed load a
// channel from the texel atlas, for the winner only, in place of the TPU
// kernel's static loop over atlas rows with a lane gather each; the surface
// coordinates use the card's atan2 in place of its polynomial.  The Perlin
// textures hash their lattice gradients in registers, as on the TPU, and run
// only on the lanes whose winner carries one.
// Lanes that cannot scatter (dead, missed, at the bounce cap) skip the
// shading, and only the winning material's rule runs, with only the PCG4D
// column groups that rule draws from.
//
// Mosaic workarounds that are dropped: pow(u, 1/3) becomes cbrt, x^5 in
// Schlick is multiplied out, flags are plain bools, and there is no block
// row tuning.  nvcc contracts mul+add into FMA (no --use_fast_math; sqrt,
// division, sin and cos are IEEE / full-accuracy), except in the hit point
// (ray_at), which the checker texture's sign test reads on planes through
// the origin, and in the camera ray and the sphere, klein and bezier probes,
// whose comparisons read values that cancel (bounce_common.cuh).  So the
// kernel agrees with the plain step to rounding, not bitwise; the
// tolerances in chip_smoke.py and tests/test_torch_bounce.py state how far.
//
// What bounds it on an H100.  Per bounce a lane moves about 33 values of
// 4 B in and out (8.7 MB at m = 65,536 lanes, about 3 us at 3.35 TB/s).
// On Cornell the compute is about 18 rect probes (~25 flops each) plus the
// shading, about 1 kflop a lane: bytes bound it.  A sphere probe is about
// 30 flops (40 with the moving centre), so the 227 spheres of the RTOW final
// scene add about 9 kflop a lane, 0.6 Gflop a launch, about 9 us of the
// card's 67 Tflop/s: there the sweep's operations bound it, and every lane
// of a warp reads the same sphere row, which the cache broadcasts.  A marble
// hit adds 56 lattice hashes (about 3 k integer and float operations), a
// medium three slab intervals, a log and one PCG4D group per four media.
// A bezier ribbon costs a live lane bez_seeds x (bez_newton + 1)
// evaluations of g and its derivatives, about 60 unfused operations and a
// division each: 17 k operations a ribbon at 32 seeds of 8 steps, which
// bounds every bezier scene by operations.  A klein march is up to 100
// steps of up to 10 sphere inversions (about 100 unfused operations a step
// and 18 an inversion); a lane leaves it when it is done, but a warp runs at
// its slowest lane's pace, and a few lanes in a thousand march all 100
// steps: divergence, not the operations the data needs, sets its time.  The
// kernel is built per feature set (bounce_common.cuh): a variant holds the
// code of the groups its plan has.
//
// Launch geometry, and what bounds each w.  The forward pool's 65,536 lanes
// are ceil(65,536 w / 256) blocks: 256 at w = 1, where 48-75 registers let
// 3-5 blocks share an SM, so the launch is under one wave of the 132 SMs
// (about 2 blocks, 16 warps, an SM) and its time is the serial chain of its
// slowest lanes; 512 at w = 2 (one wave), 1,024 and 2,048 at w = 4 and 8 (2
// and 4 waves).  A tile shortens the sweep's chain w-fold but issues the
// lane's shading on all its w threads, so past the point where the launch
// fills the card, a wider tile is bound by the instructions it issues, not
// by the chain: on the H100, w = 2 is fastest on Cornell's 18 rects and the
// 227 spheres, w = 4 on the ribbons (whose probe is mostly issue-bound
// already), and a klein, which a tile only repeats, stays at w = 1 (PERF.md
// holds the sweep).  The block count is lane_blocks, which the wrapper
// mirrors.

#include "bounce_common.cuh"

namespace {

template <typename T>
struct Params {
  const T* pk;
  const int32_t* gitem;
  const T* px;
  const T* py;
  const bool* fresh;
  const bool* alive;
  const int32_t* depth;
  const T* in[13];     // ox oy oz dx dy dz time rx ry rz tx ty tz
  T* out[13];          // the same columns after the bounce
  bool* scattering;
  const T* atlas;      // [img_rows, 128] image texels; null without images
  Statics s;
  int w;               // threads a lane (the tile's width)
  T t_min, t_max;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
bounce_step_kernel(const Params<T> prm) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) / prm.w;
  const Statics& s = prm.s;
  if (i >= s.m) return;                 // the whole tile: i is its lane's
  const Tile tl = lane_tile(prm.w);
  const T* __restrict__ pk = prm.pk;

  V3<T> o = {prm.in[0][i], prm.in[1][i], prm.in[2][i]};
  V3<T> d = {prm.in[3][i], prm.in[4][i], prm.in[5][i]};
  T time = prm.in[6][i];
  V3<T> rad = {prm.in[7][i], prm.in[8][i], prm.in[9][i]};
  V3<T> tp = {prm.in[10][i], prm.in[11][i], prm.in[12][i]};
  const bool scattering = bounce_lane<T>(
      pk, prm.atlas, s, prm.t_min, prm.t_max, uint32_t(prm.gitem[i]), prm.px[i],
      prm.py[i], prm.fresh[i], prm.alive[i], prm.depth[i], o, d, time, rad,
      tp, tl);

  if (tl.r != 0) return;                // the tile's first thread stores
  prm.out[0][i] = o.x;  prm.out[1][i] = o.y;  prm.out[2][i] = o.z;
  prm.out[3][i] = d.x;  prm.out[4][i] = d.y;  prm.out[5][i] = d.z;
  prm.out[6][i] = time;
  prm.out[7][i] = rad.x;  prm.out[8][i] = rad.y;  prm.out[9][i] = rad.z;
  prm.out[10][i] = tp.x;  prm.out[11][i] = tp.y;  prm.out[12][i] = tp.z;
  prm.scattering[i] = scattering;
}

template <typename T>
int launch(void* const* ptrs, const Statics& s, int w, double t_min,
           double t_max, cudaStream_t stream) {
  Params<T> prm;
  prm.pk = static_cast<const T*>(ptrs[0]);
  prm.gitem = static_cast<const int32_t*>(ptrs[1]);
  prm.px = static_cast<const T*>(ptrs[2]);
  prm.py = static_cast<const T*>(ptrs[3]);
  prm.fresh = static_cast<const bool*>(ptrs[4]);
  prm.alive = static_cast<const bool*>(ptrs[5]);
  prm.depth = static_cast<const int32_t*>(ptrs[6]);
  for (int k = 0; k < 13; ++k) prm.in[k] = static_cast<const T*>(ptrs[7 + k]);
  for (int k = 0; k < 13; ++k) prm.out[k] = static_cast<T*>(ptrs[20 + k]);
  prm.scattering = static_cast<bool*>(ptrs[33]);
  prm.atlas = static_cast<const T*>(ptrs[34]);
  prm.s = s;
  prm.w = w;
  prm.t_min = T(t_min);
  prm.t_max = T(t_max);
  bounce_step_kernel<T><<<lane_blocks(s.m, w), kThreads, 0, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes by integrator/bounce.py:step_cuda.
// ptrs: 35 device pointers — pk; gitem px py fresh alive depth and the 13
// float lane columns (inputs); the 13 float columns and scattering
// (outputs); the image texel atlas (null when img_rows is 0).  w: threads a
// lane, a power of two from 1 to kMaxTile (bounce.py tile_width).  Launches
// on `stream` without synchronising and returns cudaGetLastError()
// (0 = launched), or cudaErrorInvalidValue for a plan that this variant's
// feature set does not cover or a w it does not take.
extern "C" int srt_bounce_step(int is_f64, void* const* ptrs, int m, int w,
                               SRT_SCENE_PARAMS, void* stream) {
  if (m <= 0) return 0;
  const Statics s = SRT_STATICS(m);
  if (!features_cover(s) || !tile_width_ok(w))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(ptrs, s, w, t_min, t_max, st)
                : launch<float>(ptrs, s, w, t_min, t_max, st);
}
