// bounce_step.cu — one fused bounce of the regeneration pool, for sm_90a.
//
// Replaces the Pallas TPU megakernel
//     scheme_raytrace_tpu/integrator/bounce.py:as_pallas  (its body: step)
// for the Cornell slice (ROADMAP B1.1): regeneration of fresh lanes' camera
// rays from PCG4D draws, the oriented-plane rect sweep with the closest-hit
// material pick, the sky on a miss, constant and checker albedo, emission,
// mixture-PDF light sampling over xz-rect and sphere lights (or the plain
// cosine lobe), and the lambertian / metal / dielectric scatter rules.
// Its plain PyTorch twin is scheme_raytrace_torch/integrator/bounce.py:step,
// which follows the JAX step op for op.  The device functions live in
// bounce_common.cuh, which the backward kernel (bounce_step_bwd.cu) shares
// so that it replays each lane exactly as this kernel ran it.
//
// Design.  One thread per lane, 256 threads per block.  Every lane reads
// and writes its own SoA columns (19 in, 14 out), so neighbouring threads
// touch neighbouring addresses.  The packed scene `pk` (P floats, 506 for
// Cornell) is read at plan offsets through the read-only data cache: every
// thread of a warp reads the same address, which the cache broadcasts; this
// takes the place of the TPU kernel's SMEM scalar view (_SmemPk).  The
// plan's statics are kernel arguments.  Rects are swept in pack order with
// the strict `<` of _merge_rec, so ties keep the first rect as on the TPU;
// the sweep keeps only (t, winner offset) and reads the winner's material
// once after the loop, which gives the same values as the running merge.
// Lanes that cannot scatter (dead, missed, at the bounce cap) skip the
// shading, and only the winning material's rule runs, with only the PCG4D
// column groups that rule draws from.
//
// Mosaic workarounds that are dropped: pow(u, 1/3) becomes cbrt, x^5 in
// Schlick is multiplied out, flags are plain bools, and there is no block
// row tuning.  nvcc contracts mul+add into FMA (no --use_fast_math; sqrt,
// division, sin and cos are IEEE / full-accuracy), except in the hit point
// (ray_at), which the checker texture's sign test reads on planes through
// the origin.  So the kernel agrees with the plain step to rounding, not
// bitwise; the tolerances in chip_smoke.py and tests/test_torch_bounce.py
// state how far.
//
// What bounds it on an H100.  Per bounce a lane moves about 33 values of
// 4 B in and out (8.7 MB at m = 65,536 lanes, about 3 us at 3.35 TB/s).
// The compute is about 18 rect probes (~25 flops each) plus the shading,
// about 1 kflop a lane or 65 Mflop a launch, well under 1 ms of the card's
// float32 rate.  At these sizes the launch and the PyTorch glue between
// launches are expected to dominate; PERF.md holds what was measured.

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

  const uint32_t item = uint32_t(prm.gitem[i]);
  const bool alive = prm.alive[i];
  const int depth = prm.depth[i];
  V3<T> o = {prm.in[0][i], prm.in[1][i], prm.in[2][i]};
  V3<T> d = {prm.in[3][i], prm.in[4][i], prm.in[5][i]};
  T time = prm.in[6][i];
  V3<T> rad = {prm.in[7][i], prm.in[8][i], prm.in[9][i]};
  V3<T> tp = {prm.in[10][i], prm.in[11][i], prm.in[12][i]};

  // --- regenerate fresh lanes (camera rays; main.scm:452-469) ------------
  if (prm.fresh[i]) {
    camera_ray<T>(pk, s, item, prm.px[i], prm.py[i], o, d, time);
    rad = {T(0), T(0), T(0)};
    tp = {T(1), T(1), T(1)};
  }

  // --- closest hit: rect sweep in pack order (geometry.scm:33-50) --------
  T best_t;
  const int best_b = closest_rect<T>(pk, s, o, d, prm.t_min, prm.t_max,
                                     best_t);
  const bool hit = best_b >= 0;
  const T t_eff = hit ? best_t : T(0);          // miss: p = o
  const V3<T> p = ray_at(o, t_eff, d);

  // --- sky on a miss (main.scm:91-98) ---------------------------------------
  if (alive && !hit) {
    T sky_t = T(0.5) * (d.y + T(1));
    V3<T> sa = ld3(pk, H_SKY_A), sb = ld3(pk, H_SKY_B);
    V3<T> sky = {(T(1) - sky_t) * sa.x + sky_t * sb.x,
                 (T(1) - sky_t) * sa.y + sky_t * sb.y,
                 (T(1) - sky_t) * sa.z + sky_t * sb.z};
    rad = add(rad, mul(tp, sky));
  }

  bool scattering = false;
  if (alive && hit) {
    const V3<T> wn = ld3(pk, best_b + R_WN);
    const T mtype = ld(pk, best_b + R_MTYPE);
    // --- albedo: constant or checker (texture.scm:12-23) ---------------
    const V3<T> alb =
        ld3(pk, best_b + (checker_odd<T>(pk, best_b, p) ? R_ALB1 : R_ALB0));
    // --- emission (material.scm:103-111) --------------------------------
    if (mtype == T(MAT_DIFFUSE_LIGHT) && dot(wn, d) < T(0))
      rad = add(rad, mul(tp, alb));

    if (depth < s.max_depth) {
      V3<T> dir, mult;
      bool sc_ok = false;
      T u[8];
      if (mtype == T(MAT_LAMBERTIAN)) {
        // material.scm:24-39, mixture pdf per pdf.scm intent
        uniforms4<T>(s.seed, item, uint32_t(depth), 0u, u);
        if (s.light_sampling) {
          uniforms4<T>(s.seed, item, uint32_t(depth), 1u, u + 4);
          dir = u[2] < T(0.5)
                    ? lights_sample<T>(pk, s, u[3], u[4], u[5], u[6], u[7], p)
                    : cosine_dir<T>(u[0], u[1], wn);
          T cv = cosine_value(wn, dir);
          T pdf = T(0.5) * cv + T(0.5) * lights_value<T>(pk, s, p, dir);
          mult = scale(alb, cv / (pdf < T(1e-12) ? T(1e-12) : pdf));
          sc_ok = pdf > T(0);
        } else {
          dir = cosine_dir<T>(u[0], u[1], wn);
          mult = alb;
          sc_ok = true;
        }
      } else if (mtype == T(MAT_METAL)) {
        // material.scm:45-57; fuzz ball from util.scm:9-15 (analytic)
        uniforms4<T>(s.seed, item, uint32_t(depth), 2u, u);
        V3<T> ball = fuzz_ball<T>(u);
        V3<T> refl = sub(d, scale(wn, T(2) * dot(d, wn)));
        V3<T> fuzzed = add(refl, scale(ball, ld(pk, best_b + R_FUZZ)));
        sc_ok = dot(fuzzed, wn) > T(0);
        dir = unit(fuzzed);
        mult = alb;
      } else if (mtype == T(MAT_DIELECTRIC)) {
        // material.scm:76-101
        uniforms4<T>(s.seed, item, uint32_t(depth), 2u, u);
        T ref_idx = ld(pk, best_b + R_REF);
        T dd = dot(d, wn);
        bool exiting = dd > T(0);
        V3<T> own = exiting ? scale(wn, T(-1)) : wn;
        T ni = exiting ? ref_idx : T(1) / (ref_idx == T(0) ? T(1) : ref_idx);
        T cosine = exiting ? dd * ref_idx : -dd;
        T dtn = dot(d, own);
        T disc = T(1) - ni * ni * (T(1) - dtn * dtn);
        bool refr_ok = disc > T(0);
        T safe = Math<T>::sqrt(refr_ok ? disc : T(1));
        V3<T> refr = sub(scale(sub(d, scale(own, dtn)), ni), scale(own, safe));
        V3<T> refl = sub(d, scale(wn, T(2) * dot(d, wn)));
        dir = unit(u[0] < schlick_prob<T>(ref_idx, cosine, refr_ok) ? refl
                                                                    : refr);
        mult = {T(1), T(1), T(1)};
        sc_ok = true;
      }
      if (sc_ok) {
        scattering = true;
        tp = mul(tp, mult);
        o = p;
        d = dir;
      }
    }
  }

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
  prm.s = s;
  prm.t_min = T(t_min);
  prm.t_max = T(t_max);
  const int blocks = (s.m + kThreads - 1) / kThreads;
  bounce_step_kernel<T><<<blocks, kThreads, 0, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes by integrator/bounce.py:step_cuda.
// ptrs: 34 device pointers — pk; gitem px py fresh alive depth and the 13
// float lane columns (inputs); the 13 float columns and scattering
// (outputs).  Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 = launched).
extern "C" int srt_bounce_step(int is_f64, void* const* ptrs, int m,
                               int n_rects, int rect_base, int n_lights,
                               int lgt_base, int light_sampling, int nx,
                               int ny, int max_depth, uint32_t seed,
                               double t_min, double t_max, void* stream) {
  if (m <= 0) return 0;
  Statics s{m, n_rects, rect_base, n_lights, lgt_base, light_sampling,
            nx, ny, max_depth, seed};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(ptrs, s, t_min, t_max, st)
                : launch<float>(ptrs, s, t_min, t_max, st);
}
