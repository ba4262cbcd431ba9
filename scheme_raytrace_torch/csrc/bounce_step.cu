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
// Design.  One thread per lane, 256 threads per block.  Every lane reads
// and writes its own SoA columns (19 in, 14 out), so neighbouring threads
// touch neighbouring addresses.  The packed scene `pk` (P floats, 506 for
// Cornell) is read at plan offsets through the read-only data cache: every
// thread of a warp reads the same address, which the cache broadcasts; this
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
// code of the groups its plan has.  PERF.md holds what was measured.

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
  T t_min, t_max;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
bounce_step_kernel(const Params<T> prm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const Statics& s = prm.s;
  if (i >= s.m) return;
  const T* __restrict__ pk = prm.pk;

  V3<T> o = {prm.in[0][i], prm.in[1][i], prm.in[2][i]};
  V3<T> d = {prm.in[3][i], prm.in[4][i], prm.in[5][i]};
  T time = prm.in[6][i];
  V3<T> rad = {prm.in[7][i], prm.in[8][i], prm.in[9][i]};
  V3<T> tp = {prm.in[10][i], prm.in[11][i], prm.in[12][i]};
  const bool scattering = bounce_lane<T>(
      pk, prm.atlas, s, prm.t_min, prm.t_max, uint32_t(prm.gitem[i]), prm.px[i],
      prm.py[i], prm.fresh[i], prm.alive[i], prm.depth[i], o, d, time, rad,
      tp);

  prm.out[0][i] = o.x;  prm.out[1][i] = o.y;  prm.out[2][i] = o.z;
  prm.out[3][i] = d.x;  prm.out[4][i] = d.y;  prm.out[5][i] = d.z;
  prm.out[6][i] = time;
  prm.out[7][i] = rad.x;  prm.out[8][i] = rad.y;  prm.out[9][i] = rad.z;
  prm.out[10][i] = tp.x;  prm.out[11][i] = tp.y;  prm.out[12][i] = tp.z;
  prm.scattering[i] = scattering;
}

template <typename T>
int launch(void* const* ptrs, const Statics& s, double t_min, double t_max,
           cudaStream_t stream) {
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
  prm.t_min = T(t_min);
  prm.t_max = T(t_max);
  const int blocks = (s.m + kThreads - 1) / kThreads;
  bounce_step_kernel<T><<<blocks, kThreads, 0, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes by integrator/bounce.py:step_cuda.
// ptrs: 35 device pointers — pk; gitem px py fresh alive depth and the 13
// float lane columns (inputs); the 13 float columns and scattering
// (outputs); the image texel atlas (null when img_rows is 0).  Launches on
// `stream` without synchronising and returns cudaGetLastError()
// (0 = launched), or cudaErrorInvalidValue for a plan that this variant's
// feature set does not cover.
extern "C" int srt_bounce_step(int is_f64, void* const* ptrs, int m,
                               SRT_SCENE_PARAMS, void* stream) {
  if (m <= 0) return 0;
  const Statics s = SRT_STATICS(m);
  if (!features_cover(s)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(ptrs, s, t_min, t_max, st)
                : launch<float>(ptrs, s, t_min, t_max, st);
}
