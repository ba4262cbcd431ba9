// bounce_common.cuh — the forward bounce's device code, shared by the
// forward kernel (bounce_step.cu), the backward kernel (bounce_step_bwd.cu),
// the packed-state kernel (bounce_packed.cu) and the persistent kernel
// (bounce_persist.cu).  The backward replays each lane exactly as the
// forward ran it, and the three forward kernels run one lane body
// (bounce_lane), so they trace identical paths from identical inputs.  All
// four run a lane on a tile of w threads (Tile), over which the closest-hit
// sweeps split; every w gives the one-thread search's values bit for bit.
//
// Every function here follows scheme_raytrace_torch/integrator/bounce.py:
// step, op for op, with two forms of K1's own: cbrt for the fuzz radius and
// a multiplied-out x^5 in Schlick (the JAX step keeps pow for Mosaic).
// nvcc contracts mul+add into FMA (no --use_fast_math), except where a
// comparison reads a value that cancels: a fresh lane's camera ray
// (camera_ray), the hit point (ray_at), the whole sphere probe
// (sphere_probe), the media's boundary intervals (medium_probe), the whole
// bezier probe (bezier_probe) and the whole klein probe (klein_march,
// klein_dist_grad) round every product on its own, as the plain step does.
//
// Coverage: rects, spheres (static and moving), the Kleinian limit-set
// fractal, cubic Bezier ribbons, constant media in box and sphere
// boundaries; constant, checker, hash-Perlin noise and marble, and image
// textures (texels from the atlas, an indexed load a channel).
//
// Feature sets.  The groups a plan may lack are compile-time flags, the
// SRT_* macros below, set by -D on nvcc's command line
// (utils/cuda_build.py builds one library a kernel and feature set, at first
// use, and integrator/bounce.py:kernel_features derives the set from the
// plan).  A flag that is off removes its group's code, registers and shared
// memory from the variant; counts (n_rects, n_spheres, n_beziers, ...) stay
// runtime fields, so one variant serves any count.  A kernel's C entry point
// refuses a plan its variant does not cover (features_cover).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef SRT_SPHERES
#define SRT_SPHERES 0
#endif
#ifndef SRT_MOVING
#define SRT_MOVING 0
#endif
#ifndef SRT_PERLIN
#define SRT_PERLIN 0
#endif
#ifndef SRT_IMAGE
#define SRT_IMAGE 0
#endif
#ifndef SRT_MEDIA
#define SRT_MEDIA 0
#endif
#ifndef SRT_BEZIER
#define SRT_BEZIER 0
#endif
#ifndef SRT_KLEIN
#define SRT_KLEIN 0
#endif

namespace {

// The variant's feature set (see the header comment).
constexpr bool kSpheres = SRT_SPHERES != 0;
constexpr bool kMoving = kSpheres && SRT_MOVING != 0;
constexpr bool kPerlin = SRT_PERLIN != 0;
constexpr bool kImage = SRT_IMAGE != 0;
constexpr bool kMedia = SRT_MEDIA != 0;
constexpr bool kBeziers = SRT_BEZIER != 0;
constexpr bool kKleins = SRT_KLEIN != 0;

// Packed-scene layout: the offsets of scheme_raytrace_torch/integrator/
// bounce.py (tests/test_torch_bounce.py holds each constant equal).
constexpr int H_SKY_A = 0;
constexpr int H_SKY_B = 3;
constexpr int H_CAM_O = 6;
constexpr int H_CAM_LL = 9;
constexpr int H_CAM_H = 12;
constexpr int H_CAM_V = 15;
constexpr int H_CAM_U = 18;
constexpr int H_CAM_VV = 21;
constexpr int H_LENS_R = 24;
constexpr int H_T0 = 25;
constexpr int H_DT = 26;
constexpr int HDR_SIZE = 27;

constexpr int R_WN = 0;
constexpr int R_K = 3;
constexpr int R_A = 4;
constexpr int R_KA0 = 7;
constexpr int R_KA1 = 8;
constexpr int R_B = 9;
constexpr int R_KB0 = 12;
constexpr int R_KB1 = 13;
constexpr int R_VALID = 14;
constexpr int R_MTYPE = 15;
constexpr int R_ALB0 = 16;
constexpr int R_ALB1 = 19;
constexpr int R_TEXK = 22;
constexpr int R_FUZZ = 23;
constexpr int R_REF = 24;
constexpr int R_TEXS = 25;
constexpr int RECT_SIZE = 26;

constexpr int S_C0 = 0;
constexpr int S_C1 = 3;
constexpr int S_T0 = 6;
constexpr int S_T1 = 7;
constexpr int S_R = 8;
constexpr int S_VALID = 9;
constexpr int S_MTYPE = 10;
constexpr int S_ALB0 = 11;
constexpr int S_ALB1 = 14;
constexpr int S_TEXK = 17;
constexpr int S_FUZZ = 18;
constexpr int S_REF = 19;
constexpr int S_TEXS = 20;
constexpr int SPH_SIZE = 21;

// per-medium fields: an oriented 3-slab box (3 x (axis vec3, lo, hi) from
// M_AX) or a sphere boundary; M_NID = -1 / density
constexpr int M_KIND = 0;
constexpr int M_AX = 1;
constexpr int M_C = 16;
constexpr int M_RAD = 19;
constexpr int M_NID = 20;
constexpr int M_VALID = 21;
constexpr int M_MTYPE = 22;
constexpr int M_ALB0 = 23;
constexpr int M_ALB1 = 26;
constexpr int M_TEXK = 29;
constexpr int M_FUZZ = 30;
constexpr int M_REF = 31;
constexpr int M_TEXS = 32;
constexpr int MED_SIZE = 33;

// per-bezier fields: 4 control points and the ribbon's width
constexpr int B_CP = 0;
constexpr int B_W = 12;
constexpr int B_VALID = 13;
constexpr int B_MTYPE = 14;
constexpr int B_ALB0 = 15;
constexpr int B_ALB1 = 18;
constexpr int B_TEXK = 21;
constexpr int B_FUZZ = 22;
constexpr int B_REF = 23;
constexpr int B_TEXS = 24;
constexpr int BEZ_SIZE = 25;

// per-klein fields: the fractal's centre
constexpr int K_C = 0;
constexpr int K_VALID = 3;
constexpr int K_MTYPE = 4;
constexpr int K_ALB0 = 5;
constexpr int K_ALB1 = 8;
constexpr int K_TEXK = 11;
constexpr int K_FUZZ = 12;
constexpr int K_REF = 13;
constexpr int K_TEXS = 14;
constexpr int KL_SIZE = 15;

// A rect, a sphere, a medium, a bezier and a klein block end in the same material
// record (mtype, alb0, alb1, texk, fuzz, ref, texs): the shading reads the
// winner's through its mtype slot `mat` and these offsets from it, whatever
// its group.
constexpr int kAlb0 = R_ALB0 - R_MTYPE;
constexpr int kAlb1 = R_ALB1 - R_MTYPE;
constexpr int kTexk = R_TEXK - R_MTYPE;
constexpr int kFuzz = R_FUZZ - R_MTYPE;
constexpr int kRef = R_REF - R_MTYPE;
constexpr int kTexs = R_TEXS - R_MTYPE;
static_assert(S_ALB0 - S_MTYPE == kAlb0 && S_ALB1 - S_MTYPE == kAlb1 &&
                  S_TEXK - S_MTYPE == kTexk && S_FUZZ - S_MTYPE == kFuzz &&
                  S_REF - S_MTYPE == kRef && S_TEXS - S_MTYPE == kTexs &&
                  M_ALB0 - M_MTYPE == kAlb0 && M_ALB1 - M_MTYPE == kAlb1 &&
                  M_TEXK - M_MTYPE == kTexk && M_FUZZ - M_MTYPE == kFuzz &&
                  M_REF - M_MTYPE == kRef && M_TEXS - M_MTYPE == kTexs &&
                  B_ALB0 - B_MTYPE == kAlb0 && B_ALB1 - B_MTYPE == kAlb1 &&
                  B_TEXK - B_MTYPE == kTexk && B_FUZZ - B_MTYPE == kFuzz &&
                  B_REF - B_MTYPE == kRef && B_TEXS - B_MTYPE == kTexs &&
                  K_ALB0 - K_MTYPE == kAlb0 && K_ALB1 - K_MTYPE == kAlb1 &&
                  K_TEXK - K_MTYPE == kTexk && K_FUZZ - K_MTYPE == kFuzz &&
                  K_REF - K_MTYPE == kRef && K_TEXS - K_MTYPE == kTexs,
              "rect, sphere, medium, bezier and klein blocks share one "
              "material record");

// The kind of a closest-hit winner, and its mtype slot's offset in its block.
constexpr int kRect = 0;
constexpr int kSphere = 1;
constexpr int kMedium = 2;
constexpr int kBezier = 3;
constexpr int kKlein = 4;
__device__ __forceinline__ int mat_offset(int kind) {
  return kind == kSphere   ? S_MTYPE
         : kind == kRect   ? R_MTYPE
         : kind == kMedium ? M_MTYPE
         : kind == kKlein  ? K_MTYPE
                           : B_MTYPE;
}

constexpr int L_KIND = 0;
constexpr int L_X0 = 1;
constexpr int L_X1 = 2;
constexpr int L_Z0 = 3;
constexpr int L_Z1 = 4;
constexpr int L_KY = 5;
constexpr int L_C = 6;
constexpr int L_RAD = 9;
constexpr int LGT_SIZE = 11;

// scene/objects.py MAT_* and scene/build.py TEX_*
constexpr int MAT_LAMBERTIAN = 0;
constexpr int MAT_METAL = 1;
constexpr int MAT_DIELECTRIC = 2;
constexpr int MAT_DIFFUSE_LIGHT = 3;
constexpr int TEX_CHECKER = 1;
constexpr int TEX_NOISE = 2;
constexpr int TEX_MARBLE = 3;
constexpr int TEX_IMAGE = 4;

// core/rng.py
constexpr uint32_t CAMERA_DEPTH = 0xFFFFu;
constexpr uint32_t GROUP_MEDIUM = 8u;
constexpr uint32_t PCG_MULT = 1664525u;
constexpr uint32_t PCG_ADD = 1013904223u;

constexpr double kPi = 3.141592653589793;
constexpr double kTwoPi = 2.0 * kPi;

constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;   // a whole warp

// The tile of a lane: the w consecutive threads of a warp that carry it (w
// a power of two, 1 to kMaxTile; a kernel argument of K1, K2, K3 and K4),
// this thread's rank r in it, and the tile's threads as a shuffle mask.
// The closest-hit sweeps split over the tile (each thread probes its
// share, in pack order) and the tile combines the shares with shuffles;
// everything else runs on every thread of the tile, on the same values.
// At w = 1 every split is the one-thread search itself and no shuffle runs.
constexpr int kMaxTile = 8;

struct Tile {
  int w, r;
  unsigned mask;
};

// The widths a kernel takes.
inline bool tile_width_ok(int w) {
  return w >= 1 && w <= kMaxTile && (w & (w - 1)) == 0;
}

// The blocks of kThreads threads that carry m lanes at w threads a lane
// (the launch of K1, K2, K3 and K4; integrator/bounce.py kernel_blocks).
inline int lane_blocks(int m, int w) {
  return (m * w + kThreads - 1) / kThreads;
}

// The tile of width w that holds this thread (w divides 32, so no tile
// straddles a warp).
__device__ __forceinline__ Tile lane_tile(int w) {
  const int lane = threadIdx.x & 31;
  return {w, lane & (w - 1), ((1u << w) - 1u) << (lane & ~(w - 1))};
}

// One thread a lane: K2's adjoint of one ribbon, which a thread runs alone.
__device__ __forceinline__ Tile one_thread() {
  return {1, 0, 1u << (threadIdx.x & 31)};
}

// v of the tile's thread r ^ off.
template <typename V>
__device__ __forceinline__ V tile_xor(const Tile& tl, V v, int off) {
  return __shfl_xor_sync(tl.mask, v, off, tl.w);
}

// The tile's lexicographic minimum of (t, b), on every thread of the tile:
// with b a pk offset (-1 for none), it is the first primitive in pack order
// among those at the least t, which is what a sequential fold with the
// strict `<` keeps.
template <typename T>
__device__ __forceinline__ void tile_first_min(const Tile& tl, T& t, int& b) {
  for (int off = 1; off < tl.w; off <<= 1) {
    const T ot = tile_xor(tl, t, off);
    const int ob = tile_xor(tl, b, off);
    if (ot < t || (ot == t && ob < b)) {
      t = ot;
      b = ob;
    }
  }
}

// Full-accuracy math for each precision (no implicit double promotion).
template <typename T> struct Math;
template <> struct Math<float> {
  static __device__ __forceinline__ float sqrt(float x) { return sqrtf(x); }
  static __device__ __forceinline__ float rsqrt(float x) { return rsqrtf(x); }
  static __device__ __forceinline__ float cbrt(float x) { return cbrtf(x); }
  static __device__ __forceinline__ float sin(float x) { return sinf(x); }
  static __device__ __forceinline__ float cos(float x) { return cosf(x); }
  static __device__ __forceinline__ float abs(float x) { return fabsf(x); }
  static __device__ __forceinline__ float floor(float x) { return floorf(x); }
  static __device__ __forceinline__ float log(float x) { return logf(x); }
  static __device__ __forceinline__ float atan2(float y, float x) {
    return atan2f(y, x);
  }
  static __device__ __forceinline__ float tiny() { return 1.17549435e-38f; }
  static __device__ __forceinline__ float mul_rn(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float add_rn(float a, float b) {
    return __fadd_rn(a, b);
  }
};
template <> struct Math<double> {
  static __device__ __forceinline__ double sqrt(double x) { return ::sqrt(x); }
  static __device__ __forceinline__ double rsqrt(double x) { return ::rsqrt(x); }
  static __device__ __forceinline__ double cbrt(double x) { return ::cbrt(x); }
  static __device__ __forceinline__ double sin(double x) { return ::sin(x); }
  static __device__ __forceinline__ double cos(double x) { return ::cos(x); }
  static __device__ __forceinline__ double abs(double x) { return ::fabs(x); }
  static __device__ __forceinline__ double floor(double x) { return ::floor(x); }
  static __device__ __forceinline__ double log(double x) { return ::log(x); }
  static __device__ __forceinline__ double atan2(double y, double x) {
    return ::atan2(y, x);
  }
  static __device__ __forceinline__ double tiny() {
    return 2.2250738585072014e-308;
  }
  static __device__ __forceinline__ double mul_rn(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double add_rn(double a, double b) {
    return __dadd_rn(a, b);
  }
};

template <typename T> struct V3 { T x, y, z; };

template <typename T>
__device__ __forceinline__ V3<T> add(V3<T> a, V3<T> b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
template <typename T>
__device__ __forceinline__ V3<T> sub(V3<T> a, V3<T> b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
template <typename T>
__device__ __forceinline__ V3<T> scale(V3<T> a, T s) {
  return {a.x * s, a.y * s, a.z * s};
}
template <typename T>
__device__ __forceinline__ V3<T> mul(V3<T> a, V3<T> b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}
template <typename T>
__device__ __forceinline__ T dot(V3<T> a, V3<T> b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
template <typename T>
__device__ __forceinline__ V3<T> cross(V3<T> a, V3<T> b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
// bounce.py unit3: v * rsqrt(max(v.v, 1e-12))
template <typename T>
__device__ __forceinline__ V3<T> unit(V3<T> a) {
  T dd = dot(a, a);
  T lo = T(1e-12);
  return scale(a, Math<T>::rsqrt(dd < lo ? lo : dd));
}

// Products and sums rounded on their own (never contracted into an FMA),
// for the code whose comparisons read values that cancel.
template <typename T>
__device__ __forceinline__ T mul_(T a, T b) { return Math<T>::mul_rn(a, b); }
template <typename T>
__device__ __forceinline__ T add_(T a, T b) { return Math<T>::add_rn(a, b); }
template <typename T>
__device__ __forceinline__ T sub_(T a, T b) { return Math<T>::add_rn(a, -b); }
template <typename T>
__device__ __forceinline__ T dot_rn(V3<T> a, V3<T> b) {
  return add_(add_(mul_(a.x, b.x), mul_(a.y, b.y)), mul_(a.z, b.z));
}

template <typename T>
__device__ __forceinline__ T ld(const T* __restrict__ pk, int k) {
  return __ldg(pk + k);
}
template <typename T>
__device__ __forceinline__ V3<T> ld3(const T* __restrict__ pk, int k) {
  return {__ldg(pk + k), __ldg(pk + k + 1), __ldg(pk + k + 2)};
}

// One PCG4D round (core/rng.py _pcg4d) in uint32 arithmetic.
__device__ __forceinline__ void pcg4d(uint32_t& a, uint32_t& b, uint32_t& c,
                                      uint32_t& d) {
  a = a * PCG_MULT + PCG_ADD;
  b = b * PCG_MULT + PCG_ADD;
  c = c * PCG_MULT + PCG_ADD;
  d = d * PCG_MULT + PCG_ADD;
  a += b * d; b += c * a; c += a * b; d += b * c;
  a ^= a >> 16; b ^= b >> 16; c ^= c >> 16; d ^= d >> 16;
  a += b * d; b += c * a; c += a * b; d += b * c;
}

// Column group `g` of the (seed, item, depth) stream: 4 uniforms in [0, 1)
// from the top 24 bits (core/rng.py _to_unit; exact in both precisions).
template <typename T>
__device__ __forceinline__ void uniforms4(uint32_t seed, uint32_t item,
                                          uint32_t depth, uint32_t g, T u[4]) {
  uint32_t a = item, b = depth, c = g, d = seed;
  pcg4d(a, b, c, d);
  const T inv = T(1.0 / 16777216.0);
  u[0] = T(int32_t(a >> 8)) * inv;
  u[1] = T(int32_t(b >> 8)) * inv;
  u[2] = T(int32_t(c >> 8)) * inv;
  u[3] = T(int32_t(d >> 8)) * inv;
}

// onb.scm:8-16 + local: world vector from local (x, y, zc) about w.
template <typename T>
__device__ __forceinline__ V3<T> onb_local(V3<T> w, T x, T y, T zc) {
  bool pick_y = Math<T>::abs(w.x) > T(0.9);
  V3<T> a = {pick_y ? T(0) : T(1), pick_y ? T(1) : T(0), T(0)};
  V3<T> v = unit(cross(w, a));
  V3<T> u = cross(v, w);
  return {x * u.x + y * v.x + zc * w.x, x * u.y + y * v.y + zc * w.y,
          x * u.z + y * v.z + zc * w.z};
}

// Cosine-weighted direction about w (util.scm:37-44, B4 fixed).
template <typename T>
__device__ __forceinline__ V3<T> cosine_dir(T u1, T u2, V3<T> w) {
  T phi = T(kTwoPi) * u1;
  T sr2 = Math<T>::sqrt(u2);
  T one_m = T(1) - u2;
  T zc = Math<T>::sqrt(one_m < T(0) ? T(0) : one_m);
  return unit(onb_local(w, Math<T>::cos(phi) * sr2, Math<T>::sin(phi) * sr2,
                        zc));
}

template <typename T>
__device__ __forceinline__ T cosine_value(V3<T> n, V3<T> d) {
  T c = dot(n, d);
  return (c < T(0) ? T(0) : c) * T(1.0 / kPi);
}

// The plan's statics (bounce.py scene_args, after the lane count m).
// img_rows: the atlas's 128-texel rows, 0 for a plan without image textures;
// bez_seeds and bez_newton: the bezier probe's seeds a curve and Newton
// steps a seed.
struct Statics {
  int m, n_rects, rect_base, n_spheres, sph_base, has_moving;
  int n_lights, lgt_base, light_sampling;
  int nx, ny, max_depth;
  int n_media, med_base, has_perlin, img_rows;
  int n_kleins, kl_base;
  int n_beziers, bez_base, bez_seeds, bez_newton;
  uint32_t seed, perlin_seed;
};

// True when this variant's feature set covers the plan: what the C entry
// points check before they launch.
inline bool features_cover(const Statics& s) {
  return (kSpheres || s.n_spheres == 0) &&
         (kMoving || !s.has_moving || s.n_spheres == 0) &&
         (kPerlin || !s.has_perlin) && (kImage || s.img_rows == 0) &&
         (kMedia || s.n_media == 0) && (kBeziers || s.n_beziers == 0) &&
         (kKleins || s.n_kleins == 0);
}

// The scene arguments every bounce kernel's C entry point ends in, in
// bounce.py scene_args' order, and the Statics they make for m lanes.
#define SRT_SCENE_PARAMS                                                     \
  int n_rects, int rect_base, int n_spheres, int sph_base, int has_moving,  \
      int n_lights, int lgt_base, int light_sampling, int nx, int ny,       \
      int max_depth, int n_media, int med_base, int has_perlin,             \
      int img_rows, int n_kleins, int kl_base, int n_beziers, int bez_base, \
      int bez_seeds, int bez_newton, uint32_t seed, uint32_t perlin_seed,   \
      double t_min, double t_max
#define SRT_STATICS(m)                                                       \
  Statics {                                                                  \
    m, n_rects, rect_base, n_spheres, sph_base, has_moving, n_lights,        \
        lgt_base, light_sampling, nx, ny, max_depth, n_media, med_base,      \
        has_perlin, img_rows, n_kleins, kl_base, n_beziers, bez_base,        \
        bez_seeds, bez_newton, seed, perlin_seed                             \
  }

// The light that u_pick picks (pdfs.lights_sample_u's selection).
template <typename T>
__device__ __forceinline__ int pick_light(const Statics& s, T u_pick) {
  const T scaled = u_pick * T(s.n_lights);
  int l = 0;
  while (l < s.n_lights - 1 && !(scaled >= T(l) && scaled < T(l + 1))) ++l;
  return l;
}

// pdfs.lights_sample_u: direction from p toward the light that u_pick picks.
template <typename T>
__device__ V3<T> lights_sample(const T* __restrict__ pk, const Statics& s,
                               T u_pick, T u_a, T u_b, T u_s1, T u_s2,
                               V3<T> p) {
  const int b = s.lgt_base + pick_light(s, u_pick) * LGT_SIZE;
  if (ld(pk, b + L_KIND) < T(0.5)) {            // LIGHT_XZ_RECT
    T x0 = ld(pk, b + L_X0), z0 = ld(pk, b + L_Z0);
    V3<T> target = {x0 + u_a * (ld(pk, b + L_X1) - x0), ld(pk, b + L_KY),
                    z0 + u_b * (ld(pk, b + L_Z1) - z0)};
    return unit(sub(target, p));
  }
  V3<T> oc = sub(ld3(pk, b + L_C), p);          // LIGHT_SPHERE
  T dist_sq = dot(oc, oc);
  dist_sq = dist_sq < T(1e-12) ? T(1e-12) : dist_sq;
  T radius = ld(pk, b + L_RAD);
  T inner = T(1) - radius * radius / dist_sq;
  T ctm = inner > T(0) ? Math<T>::sqrt(inner) : T(0);
  T zc = T(1) + u_s2 * (ctm - T(1));
  T phi = T(kTwoPi) * u_s1;
  T zin = T(1) - zc * zc;
  T sz = zin > T(0) ? Math<T>::sqrt(zin) : T(0);
  return unit(onb_local(unit(oc), Math<T>::cos(phi) * sz,
                        Math<T>::sin(phi) * sz, zc));
}

// pdfs.lights_value: mean hittable-PDF value of direction d over the lights.
template <typename T>
__device__ T lights_value(const T* __restrict__ pk, const Statics& s,
                          V3<T> p, V3<T> d) {
  T total = T(0);
  for (int l = 0; l < s.n_lights; ++l) {
    const int b = s.lgt_base + l * LGT_SIZE;
    if (ld(pk, b + L_KIND) < T(0.5)) {
      T ady = Math<T>::abs(d.y);
      if (!(ady > T(1e-9))) continue;
      T x0 = ld(pk, b + L_X0), x1 = ld(pk, b + L_X1);
      T z0 = ld(pk, b + L_Z0), z1 = ld(pk, b + L_Z1);
      T t = (ld(pk, b + L_KY) - p.y) / d.y;
      T hx = p.x + t * d.x;
      T hz = p.z + t * d.z;
      if (t > T(1e-3) && t < T(1e8) && hx >= x0 && hx <= x1 && hz >= z0 &&
          hz <= z1) {
        T denom = ady * ((x1 - x0) * (z1 - z0));
        total += t * t / (denom < T(1e-12) ? T(1e-12) : denom);
      }
    } else {
      V3<T> oc = sub(ld3(pk, b + L_C), p);
      T dist_sq = dot(oc, oc);
      T radius = ld(pk, b + L_RAD);
      T r2 = radius * radius;
      if (!(dist_sq > r2)) continue;
      T ratio = r2 / (dist_sq < T(1e-12) ? T(1e-12) : dist_sq);
      ratio = ratio < T(0) ? T(0) : (ratio > T(1) ? T(1) : ratio);
      T ctm = Math<T>::sqrt(T(1) - ratio);
      T solid = T(kTwoPi) * (T(1) - ctm);
      if (dot(unit(d), unit(oc)) >= ctm)
        total += T(1) / (solid < T(1e-12) ? T(1e-12) : solid);
    }
  }
  return total * T(1.0 / double(s.n_lights));
}

// The camera ray of a fresh lane (main.scm:452-469; bounce.py _camera_ray),
// every product and sum rounded on its own in the plain step's order (the
// card's rsqrt normalises it, as torch.rsqrt does there): a fused form moves
// the direction by an ulp, and a big sphere's probe amplifies that.
template <typename T>
__device__ __forceinline__ void camera_ray(const T* __restrict__ pk,
                                           const Statics& s, uint32_t item,
                                           T px, T py, V3<T>& o, V3<T>& d,
                                           T& time) {
  T u[8];
  uniforms4<T>(s.seed, item, CAMERA_DEPTH, 0u, u);
  uniforms4<T>(s.seed, item, CAMERA_DEPTH, 1u, u + 4);
  const T sx = mul_(add_(px, u[0]), T(1.0 / double(s.nx)));
  const T ty = mul_(add_(py, u[1]), T(1.0 / double(s.ny)));
  const T r = Math<T>::sqrt(u[2]);
  const T phi = mul_(T(kTwoPi), u[3]);
  const T lr = mul_(ld(pk, H_LENS_R), r);
  const T rdx = mul_(lr, Math<T>::cos(phi));
  const T rdy = mul_(lr, Math<T>::sin(phi));
  const V3<T> cu = ld3(pk, H_CAM_U), cv = ld3(pk, H_CAM_VV);
  const V3<T> off = {add_(mul_(cu.x, rdx), mul_(cv.x, rdy)),
                     add_(mul_(cu.y, rdx), mul_(cv.y, rdy)),
                     add_(mul_(cu.z, rdx), mul_(cv.z, rdy))};
  const V3<T> org = ld3(pk, H_CAM_O);
  const V3<T> ll = ld3(pk, H_CAM_LL), hor = ld3(pk, H_CAM_H),
              ver = ld3(pk, H_CAM_V);
  o = {add_(org.x, off.x), add_(org.y, off.y), add_(org.z, off.z)};
  const V3<T> dv = {
      sub_(sub_(add_(add_(ll.x, mul_(sx, hor.x)), mul_(ty, ver.x)), org.x),
           off.x),
      sub_(sub_(add_(add_(ll.y, mul_(sx, hor.y)), mul_(ty, ver.y)), org.y),
           off.y),
      sub_(sub_(add_(add_(ll.z, mul_(sx, hor.z)), mul_(ty, ver.z)), org.z),
           off.z)};
  const T q = dot_rn(dv, dv);
  const T inv = Math<T>::rsqrt(q < T(1e-12) ? T(1e-12) : q);
  d = {mul_(dv.x, inv), mul_(dv.y, inv), mul_(dv.z, inv)};
  time = add_(ld(pk, H_T0), mul_(u[4], ld(pk, H_DT)));
}

// Closest hit: the rect sweep in pack order (geometry.scm:33-50).  Returns
// the winner's pk offset (-1 on a miss) and its t in best_t.  The strict <
// keeps the first of equal-t rects, as _merge_rec does.  Thread r of the
// tile sweeps rects r, r + w, ...; the tile's first minimum of (t, offset)
// is the sequential sweep's winner, ties included.
template <typename T>
__device__ __forceinline__ int closest_rect(const T* __restrict__ pk,
                                            const Statics& s, V3<T> o,
                                            V3<T> d, T t_min, T t_max,
                                            T& best_t, const Tile& tl) {
  best_t = t_max;
  int best_b = -1;
  for (int r = tl.r; r < s.n_rects; r += tl.w) {
    const int b = s.rect_base + r * RECT_SIZE;
    V3<T> wn = ld3(pk, b + R_WN);
    T dn = dot(d, wn);
    if (dn == T(0)) continue;                   // ray in the rect plane
    T t = (ld(pk, b + R_K) - dot(o, wn)) / dn;  // geometry.scm:378-379
    if (!(t >= t_min && t <= t_max && t < best_t)) continue;
    if (!(ld(pk, b + R_VALID) > T(0.5))) continue;
    V3<T> av = ld3(pk, b + R_A), bv = ld3(pk, b + R_B);
    T pa = dot(o, av) + t * dot(d, av);
    T pb = dot(o, bv) + t * dot(d, bv);
    if (pa >= ld(pk, b + R_KA0) && pa <= ld(pk, b + R_KA1) &&
        pb >= ld(pk, b + R_KB0) && pb <= ld(pk, b + R_KB1)) {
      best_t = t;
      best_b = b;
    }
  }
  tile_first_min(tl, best_t, best_b);
  return best_b;
}

// --- spheres (geometry.scm:149-153; bounce.py _sphere_hit) -----------------
// The quadratic cancels: cq = oc.oc - r*r loses up to seven digits on a
// ground sphere (radius 100 or 1000), and disc > 0, t > t_min and the
// closest-hit `<` read the result.  So every product here that feeds a sum
// is rounded on its own (mul_rn results are never contracted), in the plain
// step's order, and the probe's t is bitwise the plain step's on the same
// inputs; sqrt and division are IEEE.

// What a sphere probe leaves for its caller: the forward keeps t, the
// backward replays the winner's probe and reads the rest.
template <typename T>
struct SphereHit {
  V3<T> c, oc;       // the centre at the lane's time, and o - c
  T frac, sp;        // the moving centre's (time - t0) / sp
  T bq, sq, t;
  bool near;         // t is the near root -bq - sq (else -bq + sq)
};

// The centre of sphere block b at `time`: c0 + frac (c1 - c0), with the
// span == 0 guard of the plain step; c0 itself in a scene with no moving
// sphere.
template <typename T>
__device__ __forceinline__ void sphere_centre(const T* __restrict__ pk,
                                              const Statics& s, int b, T time,
                                              SphereHit<T>& h) {
  const V3<T> c0 = ld3(pk, b + S_C0);
  if (!(kMoving && s.has_moving)) {
    h.c = c0;
    h.frac = T(0);
    h.sp = T(1);
    return;
  }
  const T t0 = ld(pk, b + S_T0);
  const T span = ld(pk, b + S_T1) - t0;
  h.sp = span == T(0) ? T(1) : span;
  h.frac = (time - t0) / h.sp;
  const V3<T> c1 = ld3(pk, b + S_C1);
  h.c = {Math<T>::add_rn(c0.x, Math<T>::mul_rn(h.frac, c1.x - c0.x)),
         Math<T>::add_rn(c0.y, Math<T>::mul_rn(h.frac, c1.y - c0.y)),
         Math<T>::add_rn(c0.z, Math<T>::mul_rn(h.frac, c1.z - c0.z))};
}

// The JAX sphere_probe's candidate: true when the sphere at block b is hit
// in (t_min, t_max), near root before far root, both bounds strict (rects
// use >= and <=).
template <typename T>
__device__ __forceinline__ bool sphere_probe(const T* __restrict__ pk,
                                             const Statics& s, int b, V3<T> o,
                                             V3<T> d, T time, T t_min,
                                             T t_max, SphereHit<T>& h) {
  sphere_centre<T>(pk, s, b, time, h);
  const T rr = ld(pk, b + S_R);
  h.oc = sub(o, h.c);
  h.bq = dot_rn(h.oc, d);
  const T cq = Math<T>::add_rn(dot_rn(h.oc, h.oc), -Math<T>::mul_rn(rr, rr));
  const T disc = Math<T>::add_rn(Math<T>::mul_rn(h.bq, h.bq), -cq);
  if (!(disc > T(0))) return false;
  h.sq = Math<T>::sqrt(disc);
  const T t0 = -h.bq - h.sq;
  const T t1 = -h.bq + h.sq;
  h.near = t0 > t_min && t0 < t_max;
  if (!h.near && !(t1 > t_min && t1 < t_max)) return false;
  h.t = h.near ? t0 : t1;
  return ld(pk, b + S_VALID) > T(0.5);
}

// The sphere sweep, after the rects, in pack order: one loop for any sphere
// count.  It carries (best_t, winner) only; the winner's attributes are a
// plain indexed load of its pk row afterwards, so no attribute atlas is
// read.  best_t comes in as the rect sweep's; the strict < keeps a rect, or
// an earlier sphere, at a tie.  Returns the winning sphere's pk offset, or
// -1 when no sphere beats best_t.  The probe reads t_max, not best_t, so
// thread r of the tile probes spheres r, r + w, ... against the same
// best_t, and the tile's first minimum of (t, offset) is the sequential
// sweep's winner (a thread that beats nothing keeps (best_t, -1), above
// every sphere that does).
template <typename T>
__device__ __forceinline__ int closest_sphere(const T* __restrict__ pk,
                                              const Statics& s, V3<T> o,
                                              V3<T> d, T time, T t_min,
                                              T t_max, T& best_t,
                                              const Tile& tl) {
  int best_b = -1;
  for (int k = tl.r; k < s.n_spheres; k += tl.w) {
    const int b = s.sph_base + k * SPH_SIZE;
    SphereHit<T> h;
    if (sphere_probe<T>(pk, s, b, o, d, time, t_min, t_max, h) &&
        h.t < best_t) {
      best_t = h.t;
      best_b = b;
    }
  }
  tile_first_min(tl, best_t, best_b);
  return best_b;
}

// --- constant media (geometry.scm:545-578; bounce.py _media_scatter) -------
// A medium scatters at t = t1 + nid log(xi) inside its boundary interval
// [t1, t2], clipped to the closest solid hit.  en < ex, t1 < t2, hit_dist <
// t2 - t1 and the closest-hit `<` read these values, so the products that
// feed them are rounded on their own, in the plain step's order; division,
// sqrt and log are the card's full-accuracy ones, as PyTorch's are there.

// What a medium probe leaves for the backward: t = t1 + nid * lx.
template <typename T>
struct MediumHit {
  T lx;              // log(max(xi, tiny))
};

// The entry of the ray into medium block b's boundary, with the exit in
// `exit_`; false when the ray misses the boundary.  A box is three slabs
// with a guard for rays parallel to a slab; a sphere is its quadratic.
template <typename T>
__device__ __forceinline__ bool medium_interval(const T* __restrict__ pk,
                                                int b, V3<T> o, V3<T> d,
                                                T big, T& entry, T& exit_) {
  if (ld(pk, b + M_KIND) < T(0.5)) {
    entry = -big;
    exit_ = big;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int ab = b + M_AX + a * 5;
      const V3<T> ax = ld3(pk, ab);
      const T lo = ld(pk, ab + 3), hi = ld(pk, ab + 4);
      const T pa = dot_rn(o, ax), da = dot_rn(d, ax);
      T lo_t, hi_t;
      if (Math<T>::abs(da) > T(1e-12)) {
        const T inv = T(1) / da;
        const T ta = Math<T>::mul_rn(lo - pa, inv);
        const T tb = Math<T>::mul_rn(hi - pa, inv);
        lo_t = ta < tb ? ta : tb;
        hi_t = ta < tb ? tb : ta;
      } else {
        const bool inside = pa >= lo && pa <= hi;
        lo_t = inside ? -big : big;
        hi_t = inside ? big : -big;
      }
      entry = entry < lo_t ? lo_t : entry;
      exit_ = exit_ < hi_t ? exit_ : hi_t;
    }
    return entry < exit_;
  }
  const V3<T> oc = sub(o, ld3(pk, b + M_C));
  const T rr = ld(pk, b + M_RAD);
  const T bq = dot_rn(oc, d);
  const T cq = Math<T>::add_rn(dot_rn(oc, oc), -Math<T>::mul_rn(rr, rr));
  const T disc = Math<T>::add_rn(Math<T>::mul_rn(bq, bq), -cq);
  if (!(disc > T(0))) return false;
  const T sq = Math<T>::sqrt(disc);
  entry = -bq - sq;
  exit_ = -bq + sq;
  return true;
}

// t1 = max(max(entry, eps), 0) of the plain step.
template <typename T>
__device__ __forceinline__ T medium_t1(T entry, T eps) {
  const T a = entry < eps ? eps : entry;
  return a < T(0) ? T(0) : a;
}

// The media, after the solid sweep, in pack order with the strict `<`.
// best_t comes in as the solid winner's t (t_max on a miss), which also
// clips every medium's interval; medium mi draws column mi of the
// GROUP_MEDIUM stream of (seed, item, depth).  Returns the winning medium's
// pk offset, or -1 when no medium scatters before best_t.
template <typename T>
__device__ __forceinline__ int closest_medium(const T* __restrict__ pk,
                                              const Statics& s, uint32_t item,
                                              int depth, V3<T> o, V3<T> d,
                                              T t_min, T t_max, T& best_t,
                                              MediumHit<T>& h) {
  const T t_clip = best_t;
  int best_b = -1;
  T u[4];
  for (int mi = 0; mi < s.n_media; ++mi) {
    if ((mi & 3) == 0)
      uniforms4<T>(s.seed, item, uint32_t(depth),
                   GROUP_MEDIUM + uint32_t(mi >> 2), u);
    const int b = s.med_base + mi * MED_SIZE;
    T entry, exit_;
    if (!medium_interval<T>(pk, b, o, d, t_max, entry, exit_)) continue;
    if (!(ld(pk, b + M_VALID) > T(0.5))) continue;
    const T t1 = medium_t1(entry, t_min);
    const T t2 = exit_ < t_clip ? exit_ : t_clip;      // geometry.scm:556-557
    if (!(t1 < t2)) continue;
    const T xi = u[mi & 3] < Math<T>::tiny() ? Math<T>::tiny() : u[mi & 3];
    const T lx = Math<T>::log(xi);
    const T hit_dist = Math<T>::mul_rn(ld(pk, b + M_NID), lx);
    if (!(hit_dist < t2 - t1)) continue;               // geometry.scm:562-564
    const T t_med = Math<T>::add_rn(t1, hit_dist);
    if (t_med < best_t) {
      best_t = t_med;
      best_b = b;
      h.lx = lx;
    }
  }
  return best_b;
}

// --- cubic Bezier ribbons (bezier.scm:161-166 as redesigned in
// ops/bezier.py; bounce.py _bezier_hit) ---------------------------------------
// A ribbon is hit where the curve, projected into the plane across the ray,
// passes within half its width of the ray: Newton on g'(s) = 0, g = |c(s)|^2,
// from bez_seeds fixed seeds, bez_newton steps each, and the closest accepted
// root.  g < hw2, zc > t_min and the minimum over seeds read values that a
// fused form would move by an ulp, and a ribbon's edge flips on an ulp.  So
// every product and sum of the probe, the frame and the march included, is
// rounded on its own, in the plain step's order: t is the plain step's bit
// for bit wherever rsqrt and the division agree (they are the card's own in
// both).  Each thread of the lane's tile runs its run of seeds, all steps in
// registers, and the tile joins the runs' records (tile_join).

template <typename T>
__device__ __forceinline__ V3<T> cross_rn(V3<T> a, V3<T> b) {
  return {sub_(mul_(a.y, b.z), mul_(a.z, b.y)),
          sub_(mul_(a.z, b.x), mul_(a.x, b.z)),
          sub_(mul_(a.x, b.y), mul_(a.y, b.x))};
}

// The ray-space frame of the probe: v = unit(d x a), u = v x d, with a the
// x axis, or the y axis for a ray along x (`pick`); cr = d x a before it is
// normalised (the adjoint reads it).
template <typename T>
struct BezierFrame {
  V3<T> u, v, cr;
  bool pick;
};

template <typename T>
__device__ __forceinline__ BezierFrame<T> bezier_frame(V3<T> d) {
  BezierFrame<T> f;
  f.pick = Math<T>::abs(d.x) > T(0.9);
  const V3<T> a = {f.pick ? T(0) : T(1), f.pick ? T(1) : T(0), T(0)};
  f.cr = cross_rn(d, a);
  const T q = dot_rn(f.cr, f.cr);
  const T inv = Math<T>::rsqrt(q < T(1e-12) ? T(1e-12) : q);
  f.v = {mul_(f.cr.x, inv), mul_(f.cr.y, inv), mul_(f.cr.z, inv)};
  f.u = cross_rn(f.v, d);
  return f;
}

// Bernstein control values -> power-basis coefficients (bounce.py
// _bezier_power).
template <typename T>
__device__ __forceinline__ void bezier_power(T p0, T p1, T p2, T p3, T a[4]) {
  a[0] = p0;
  a[1] = mul_(T(3), sub_(p1, p0));
  a[2] = mul_(T(3), add_(sub_(p0, mul_(T(2), p1)), p2));
  a[3] = add_(sub_(add_(-p0, mul_(T(3), p1)), mul_(T(3), p2)), p3);
}

// The curve of bezier block b in the frame of ray (o, d): the power-basis
// coefficients of its projections on u, v (across the ray) and d (along it).
template <typename T>
struct BezierCurve {
  T ax[4], ay[4], az[4];
};

template <typename T>
__device__ __forceinline__ void bezier_curve(const T* __restrict__ pk, int b,
                                             V3<T> o, V3<T> d,
                                             const BezierFrame<T>& f,
                                             BezierCurve<T>& c) {
  T cx[4], cy[4], cz[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const V3<T> rel = sub(ld3(pk, b + B_CP + 3 * k), o);
    cx[k] = dot_rn(rel, f.u);
    cy[k] = dot_rn(rel, f.v);
    cz[k] = dot_rn(rel, d);
  }
  bezier_power(cx[0], cx[1], cx[2], cx[3], c.ax);
  bezier_power(cy[0], cy[1], cy[2], cy[3], c.ay);
  bezier_power(cz[0], cz[1], cz[2], cz[3], c.az);
}

// a0 + s (a1 + s (a2 + s a3)), each step rounded.
template <typename T>
__device__ __forceinline__ T horner_rn(const T a[4], T s) {
  return add_(a[0], mul_(s, add_(a[1], mul_(s, add_(a[2], mul_(s, a[3]))))));
}

// g(s) = |c(s)|^2 of the projection c = (cx, cy), its first two derivatives
// and 2 |c'|^2 (bounce.py _bezier_g_derivs, term for term).
template <typename T>
struct BezierG {
  T cx, cy, cx1, cy1, cx2, cy2;
  T g, dg, d2g, speed2;
};

template <typename T>
__device__ __forceinline__ BezierG<T> bezier_g(const BezierCurve<T>& c, T s) {
  BezierG<T> r;
  r.cx = horner_rn(c.ax, s);
  r.cy = horner_rn(c.ay, s);
  r.cx1 = add_(c.ax[1], mul_(s, add_(mul_(T(2), c.ax[2]),
                                     mul_(s, mul_(T(3), c.ax[3])))));
  r.cy1 = add_(c.ay[1], mul_(s, add_(mul_(T(2), c.ay[2]),
                                     mul_(s, mul_(T(3), c.ay[3])))));
  r.cx2 = add_(mul_(T(2), c.ax[2]), mul_(s, mul_(T(6), c.ax[3])));
  r.cy2 = add_(mul_(T(2), c.ay[2]), mul_(s, mul_(T(6), c.ay[3])));
  r.g = add_(mul_(r.cx, r.cx), mul_(r.cy, r.cy));
  r.dg = mul_(T(2), add_(mul_(r.cx, r.cx1), mul_(r.cy, r.cy1)));
  r.speed2 = mul_(T(2), add_(mul_(r.cx1, r.cx1), mul_(r.cy1, r.cy1)));
  r.d2g = add_(r.speed2, mul_(T(2), add_(mul_(r.cx, r.cx2),
                                          mul_(r.cy, r.cy2))));
  return r;
}

// Seed k of n: the converged, clipped root s of the march from (k + 0.5) / n,
// the curve's distance zc along the ray there, and whether the ribbon is hit
// at it within (t_min, big].  The implicit-function correction of the plain
// step, s - (corr - corr.detach()), leaves s as it is, so g at the corrected
// s is g at the root.
template <typename T>
__device__ __forceinline__ bool bezier_seed(const BezierCurve<T>& c, int k,
                                            int n_seeds, int n_newton, T hw2,
                                            T t_min, T big, T& s, T& zc) {
  s = mul_(T(k) + T(0.5), T(1.0 / double(n_seeds)));
  for (int it = 0; it < n_newton; ++it) {
    const BezierG<T> r = bezier_g(c, s);
    const T stepn = r.d2g > T(1e-12) ? r.dg / r.d2g : T(0);
    s = sub_(s, stepn);
    s = s < T(0) ? T(0) : s;
    s = s > T(1) ? T(1) : s;
  }
  const BezierG<T> r = bezier_g(c, s);
  zc = horner_rn(c.az, s);
  return r.g < hw2 && zc > T(1e-4) && zc > t_min && zc <= big;
}

// What a bezier probe leaves for the backward: the root of the first seed
// that reached the closest distance t, how many seeds reached that very t
// (`ties`; the plain step's minimum folds them in seed order and splits the
// cotangent at each equal pair), and whether all of them did so at that
// very s.
template <typename T>
struct BezierHit {
  T t, s;
  int ties;
  bool same_s;
};

// The record of two runs of seeds, a's before b's: the record of the seeds
// of both in seed order, as the sequential fold leaves it.  A later run
// wins only with a smaller t; at an equal t the ties add up, the first
// seed's s stays a's, and all tied seeds share it only if both runs' do and
// their first ones agree.
template <typename T>
__device__ __forceinline__ BezierHit<T> bezier_join(const BezierHit<T>& a,
                                                    const BezierHit<T>& b) {
  if (b.t < a.t) return b;
  if (!(b.t == a.t)) return a;
  return {a.t, a.s, a.ties + b.ties, a.same_s && b.same_s && b.s == a.s};
}

// The tile's record of all seeds, on every thread, from each thread's
// record of its run of seeds (thread r's run precedes thread r + 1's): the
// runs are joined pairwise, neighbours first, so every join has its earlier
// run on the left.
template <typename T>
__device__ __forceinline__ void tile_join(const Tile& tl, BezierHit<T>& h) {
  for (int off = 1; off < tl.w; off <<= 1) {
    BezierHit<T> o;
    o.t = tile_xor(tl, h.t, off);
    o.s = tile_xor(tl, h.s, off);
    o.ties = tile_xor(tl, h.ties, off);
    o.same_s = tile_xor(tl, int(h.same_s), off) != 0;
    h = (tl.r & off) ? bezier_join(o, h) : bezier_join(h, o);
  }
}

// The JAX bezier_probe's candidate: true when the ribbon at block b is hit.
// Thread r of the tile marches the r-th of w runs of consecutive seeds, and
// the tile joins the runs' records in seed order (tile_join).
template <typename T>
__device__ __forceinline__ bool bezier_probe(const T* __restrict__ pk,
                                             const Statics& st, int b,
                                             V3<T> o, V3<T> d,
                                             const BezierFrame<T>& f, T t_min,
                                             T big, BezierHit<T>& h,
                                             const Tile& tl) {
  if (!(ld(pk, b + B_VALID) > T(0.5))) return false;
  BezierCurve<T> c;
  bezier_curve<T>(pk, b, o, d, f, c);
  const T half_w = ld(pk, b + B_W) * T(0.5);
  const T hw2 = mul_(half_w, half_w);
  h.t = big;
  h.s = T(0);
  h.ties = 0;
  h.same_s = true;
  const int k_end = (tl.r + 1) * st.bez_seeds / tl.w;
  for (int k = tl.r * st.bez_seeds / tl.w; k < k_end; ++k) {
    T s, zc;
    if (!bezier_seed<T>(c, k, st.bez_seeds, st.bez_newton, hw2, t_min, big, s,
                        zc))
      continue;
    if (zc < h.t) {
      h.t = zc;
      h.s = s;
      h.ties = 1;
      h.same_s = true;
    } else if (zc == h.t) {
      ++h.ties;
      h.same_s = h.same_s && s == h.s;
    }
  }
  tile_join(tl, h);
  return h.t < big;
}

// The bezier sweep, after the spheres, in pack order with the strict `<`.
// Returns the winning ribbon's pk offset, or -1 when none beats best_t; `win`
// is then its probe's record.  Every curve's seeds are split over the tile.
template <typename T>
__device__ __forceinline__ int closest_bezier(const T* __restrict__ pk,
                                              const Statics& s, V3<T> o,
                                              V3<T> d, T t_min, T t_max,
                                              T& best_t, BezierHit<T>& win,
                                              const Tile& tl) {
  int best_b = -1;
  const BezierFrame<T> f = bezier_frame(d);
  for (int j = 0; j < s.n_beziers; ++j) {
    const int b = s.bez_base + j * BEZ_SIZE;
    BezierHit<T> h;
    if (bezier_probe<T>(pk, s, b, o, d, f, t_min, t_max, h, tl) &&
        h.t < best_t) {
      best_t = h.t;
      best_b = b;
      win = h;
    }
  }
  return best_b;
}

// --- the Kleinian limit set (geometry.scm:590-661; bounce.py _klein_dist,
// _klein_dist_grad, _klein_march, _klein_hit) ---------------------------------
// A sphere trace of a distance estimate (DE): up to kKleinIters inversions of
// the point in six spheres, then 0.7 (|P| - 125) / |dr|.  `d2 < r2` (which
// sphere inverts), the march's `dist < eps`, its t bounds, the
// backward-stuck, receding and outside tests and the precull's `disc <= 0`
// read values that an ulp moves, and an ulp can change the number of
// inversions and so the whole march.  So every product and sum of the probe
// is rounded on its own, in the plain step's order, with IEEE division and
// sqrt: the march is the plain step's bit for bit.  The march is one chain
// and is not split: every thread of the lane's tile marches it in registers
// and leaves each loop when that lane is done.

constexpr int kKleinIters = 10;          // config.KLEIN_ITERATIONS
constexpr int kKleinSteps = 100;         // config.KLEIN_MAX_STEPS
constexpr double kKleinEps = 0.001;      // config.KLEIN_SURF_EPS
constexpr double kKleinDeScale = 0.7;    // config.KLEIN_DE_SCALE
constexpr double kKleinR = 125.0;        // config.KLEIN_R
constexpr double kKleinR2 = 300.0 * 300.0;   // config.KLEIN_SPHERE_R squared
// bounce.py KLEIN_PRECULL_R and KLEIN_RECEDE_R, squared
constexpr double kKleinPrecull2 = 726.0 * 726.0;
constexpr double kKleinRecede2 = 900.0 * 900.0;

// Inversion sphere i's centre, klein-local (bounce.py _KLEIN_SPHERES).
template <typename T>
__device__ __forceinline__ V3<T> klein_sphere(int i) {
  const T a = T(300.0), h = T(424.26);
  return i < 4 ? V3<T>{i < 2 ? a : -a, (i & 1) ? -a : a, T(0)}
               : V3<T>{T(0), T(0), i == 4 ? h : -h};
}

// The first of the six spheres whose interior holds P (the plain step's
// masked sequential select), with P's offset x from its centre s and
// d2 = |x|^2; -1 when none does and P has escaped.  The six offsets and
// squared distances are computed side by side, then the first that passes
// is selected from the last one back: the same values as testing the
// spheres one after another, without a chain of six dependent tests.
template <typename T>
__device__ __forceinline__ int klein_select(V3<T> P, V3<T>& x, V3<T>& sp,
                                            T& d2) {
  V3<T> xs[6];
  T d2s[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const V3<T> si = klein_sphere<T>(i);
    xs[i] = {sub_(P.x, si.x), sub_(P.y, si.y), sub_(P.z, si.z)};
    d2s[i] = dot_rn(xs[i], xs[i]);
  }
  int sel = -1;
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    if (d2s[i] < T(kKleinR2)) {
      sel = i;
      x = xs[i];
      sp = klein_sphere<T>(i);
      d2 = d2s[i];
    }
  }
  return sel;
}

// The DE of the klein at the offset P = p - c from its centre (bounce.py
// _klein_dist).
template <typename T>
__device__ __forceinline__ T klein_de(V3<T> P) {
  T dr = T(1);
  for (int it = 0; it < kKleinIters; ++it) {
    V3<T> x, sp;
    T d2;
    if (klein_select<T>(P, x, sp, d2) < 0) break;
    const T scale = T(kKleinR2) / (d2 < Math<T>::tiny() ? Math<T>::tiny()
                                                         : d2);
    P = {add_(mul_(x.x, scale), sp.x), add_(mul_(x.y, scale), sp.y),
         add_(mul_(x.z, scale), sp.z)};
    dr = mul_(dr, scale);
  }
  return mul_(T(kKleinDeScale), sub_(Math<T>::sqrt(dot_rn(P, P)), T(kKleinR))) /
         Math<T>::abs(dr);
}

// The DE at p and its exact gradient g (bounce.py _klein_dist_grad): the
// three unit tangents dP/dq_j and ddr/dq_j ride beside the primal.  Not
// inlined: K1 calls it for a klein winner's normal, K2 for its adjoint.
template <typename T>
__device__ __noinline__ T klein_dist_grad(V3<T> c, V3<T> p, V3<T>& g) {
  V3<T> P = {sub_(p.x, c.x), sub_(p.y, c.y), sub_(p.z, c.z)};
  T dr = T(1);
  V3<T> tj[3] = {{T(1), T(0), T(0)}, {T(0), T(1), T(0)}, {T(0), T(0), T(1)}};
  T dd[3] = {T(0), T(0), T(0)};
  for (int it = 0; it < kKleinIters; ++it) {
    V3<T> x, sp;
    T d2;
    if (klein_select<T>(P, x, sp, d2) < 0) break;
    const T inv = T(1) / (d2 < Math<T>::tiny() ? Math<T>::tiny() : d2);
    const T scale = mul_(T(kKleinR2), inv);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const T w = mul_(mul_(T(2), dot_rn(x, tj[j])), inv);
      tj[j] = {mul_(scale, sub_(tj[j].x, mul_(x.x, w))),
               mul_(scale, sub_(tj[j].y, mul_(x.y, w))),
               mul_(scale, sub_(tj[j].z, mul_(x.z, w)))};
      dd[j] = mul_(scale, sub_(dd[j], mul_(w, dr)));
    }
    P = {add_(mul_(x.x, scale), sp.x), add_(mul_(x.y, scale), sp.y),
         add_(mul_(x.z, scale), sp.z)};
    dr = mul_(dr, scale);
  }
  const T q = dot_rn(P, P);
  const T ln = Math<T>::sqrt(q < Math<T>::tiny() ? Math<T>::tiny() : q);
  const T adr = Math<T>::abs(dr);
  const T lr = sub_(ln, T(kKleinR));
  // d(de)/d(q_j) = K / |dr| ((P . t_j) / |P| - (|P| - R) ddr_j / dr)
  const T k = T(kKleinDeScale) / adr;
  const T rat = lr / dr;
  T gj[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    gj[j] = mul_(k, sub_(dot_rn(P, tj[j]) / ln, mul_(rat, dd[j])));
  g = {gj[0], gj[1], gj[2]};
  return mul_(T(kKleinDeScale), lr) / adr;
}

// What a lane's klein marches did in one bounce, for the persistent
// kernel's traced counters (integrator/persist.py; bounce.py
// KLEIN_COUNTERS, which the plain `_klein_march` counts alike): the marches
// that passed the precull, their DE evaluations (steps), and the marches
// still going at the kKleinSteps cap.  K1 and K2 pass no record, and the
// compiler drops the counting.
struct KleinWork {
  int marches = 0, steps = 0, capped = 0;
};

// The sphere trace of the klein at block b along (o, d) (bounce.py
// _klein_march): false when the ray misses; on a hit, t is where the DE
// fell under eps inside (t_min, t_max).  t_max is the closest hit so far,
// so the bound is exact.  The ray starts retired when it never enters the
// precull ball on (t_min, t_max); a step retires it on an accept, when it is
// backward-stuck (DE <= 0 at a parameter <= t_min), past t_max, or receding
// outside the recede ball.  The receding and outside tests read the next
// step's offset P = o + len d - c, rounded as the DE reads it, so it is
// computed once and handed on.  A march adds its work to *kw where kw is
// not null.
template <typename T>
__device__ __forceinline__ bool klein_march(const T* __restrict__ pk, int b,
                                            V3<T> o, V3<T> d, T t_min,
                                            T t_max, T& t,
                                            KleinWork* kw = nullptr) {
  const V3<T> c = ld3(pk, b + K_C);
  const V3<T> oc = {sub_(o.x, c.x), sub_(o.y, c.y), sub_(o.z, c.z)};
  const T bq = dot_rn(oc, d);
  const T cq = sub_(dot_rn(oc, oc), T(kKleinPrecull2));
  const T disc = sub_(mul_(bq, bq), cq);
  const T sq = Math<T>::sqrt(disc < T(0) ? T(0) : disc);
  if (disc <= T(0) || add_(-bq, sq) <= t_min || sub_(-bq, sq) >= t_max)
    return false;
  if (kw) ++kw->marches;
  T len = T(0);
  V3<T> P = {sub_(add_(o.x, mul_(d.x, len)), c.x),
             sub_(add_(o.y, mul_(d.y, len)), c.y),
             sub_(add_(o.z, mul_(d.z, len)), c.z)};
  for (int k = 0; k < kKleinSteps; ++k) {
    const T dist = klein_de<T>(P);
    if (kw) ++kw->steps;
    const T new_len = add_(len, dist);
    if (dist < T(kKleinEps) && new_len > t_min && new_len < t_max) {
      t = new_len;
      return true;
    }
    const bool stuck = dist <= T(0) && len <= t_min;
    len = new_len;
    P = {sub_(add_(o.x, mul_(d.x, len)), c.x),
         sub_(add_(o.y, mul_(d.y, len)), c.y),
         sub_(add_(o.z, mul_(d.z, len)), c.z)};
    const bool receding = dot_rn(P, d) > T(0);
    const bool outside = dot_rn(P, P) > T(kKleinRecede2);
    if (stuck || len >= t_max || (receding && outside)) return false;
  }
  if (kw) ++kw->capped;
  return false;
}

// A klein winner's normal at its hit point p = o + t d: unit(g), g the DE's
// gradient there.
template <typename T>
__device__ __forceinline__ V3<T> klein_normal(const T* __restrict__ pk, int b,
                                              V3<T> p) {
  V3<T> g;
  klein_dist_grad<T>(ld3(pk, b + K_C), p, g);
  return unit(g);
}

// The kleins, after the spheres, in pack order, each march bounded by the
// closest hit so far: a hit always beats best_t, so the strict `<` of the
// merge holds.  Returns the winning klein's pk offset, or -1 when none is hit
// before best_t; the marches add their work to *kw where kw is not null.
template <typename T>
__device__ __forceinline__ int closest_klein(const T* __restrict__ pk,
                                             const Statics& s, V3<T> o,
                                             V3<T> d, T t_min, T& best_t,
                                             KleinWork* kw = nullptr) {
  int best_b = -1;
  for (int k = 0; k < s.n_kleins; ++k) {
    const int b = s.kl_base + k * KL_SIZE;
    T t;
    if (klein_march<T>(pk, b, o, d, t_min, best_t, t, kw) &&
        ld(pk, b + K_VALID) > T(0.5)) {
      best_t = t;
      best_b = b;
    }
  }
  return best_b;
}

// What the closest hit leaves for the backward, beside the winner: the
// winning medium's or ribbon's probe record.
template <typename T>
struct HitExtra {
  MediumHit<T> med;
  BezierHit<T> bez;
};

// The closest hit over the groups: the winner's pk offset (-1 on a miss),
// its t in best_t and its kind (kRect, kSphere, kKlein, kBezier, kMedium).
// The kleins, the ribbons and the media are probed for live lanes only: a
// dead lane's hit is never read.  The rect and sphere sweeps and every
// ribbon's seeds are split over the lane's tile, which leaves each sweep's
// winner on every thread of it; the klein march (bounded by the winner so
// far) and the media (which read best_t) run on every thread, on the same
// values.  The klein marches add their work to *kw where kw is not null.
template <typename T>
__device__ __forceinline__ int closest_hit(const T* __restrict__ pk,
                                           const Statics& s, uint32_t item,
                                           int depth, bool alive, V3<T> o,
                                           V3<T> d, T time, T t_min, T t_max,
                                           T& best_t, int& kind,
                                           HitExtra<T>& ex, const Tile& tl,
                                           KleinWork* kw = nullptr) {
  int best_b = closest_rect<T>(pk, s, o, d, t_min, t_max, best_t, tl);
  kind = kRect;
  if constexpr (kSpheres) {
    const int sph_b =
        closest_sphere<T>(pk, s, o, d, time, t_min, t_max, best_t, tl);
    if (sph_b >= 0) {
      kind = kSphere;
      best_b = sph_b;
    }
  }
  if constexpr (kKleins) {
    if (alive) {
      const int kl_b = closest_klein<T>(pk, s, o, d, t_min, best_t, kw);
      if (kl_b >= 0) {
        kind = kKlein;
        best_b = kl_b;
      }
    }
  }
  if constexpr (kBeziers) {
    if (alive) {
      const int bez_b =
          closest_bezier<T>(pk, s, o, d, t_min, t_max, best_t, ex.bez, tl);
      if (bez_b >= 0) {
        kind = kBezier;
        best_b = bez_b;
      }
    }
  }
  if constexpr (kMedia) {
    if (alive) {
      const int med_b = closest_medium<T>(pk, s, item, depth, o, d, t_min,
                                          t_max, best_t, ex.med);
      if (med_b >= 0) {
        kind = kMedium;
        best_b = med_b;
      }
    }
  }
  return best_b;
}

// A sphere's normal at hit point p: (p - c) / r, whose sign carries the
// hollow-dielectric trick of a negative radius.
template <typename T>
__device__ __forceinline__ V3<T> sphere_normal(V3<T> p, V3<T> c, T rr) {
  return scale(sub(p, c), T(1) / rr);
}

// The hit point o + t d, rounded as the plain step rounds it: a product,
// then a sum, never fused into an FMA.  On a plane through the origin (the
// floor y = 0) the plain step gets p.y = 0 exactly where a fused form leaves
// a residual of either sign, and the checker texture's sign test reads it.
template <typename T>
__device__ __forceinline__ V3<T> ray_at(V3<T> o, T t, V3<T> d) {
  return {Math<T>::add_rn(o.x, Math<T>::mul_rn(t, d.x)),
          Math<T>::add_rn(o.y, Math<T>::mul_rn(t, d.y)),
          Math<T>::add_rn(o.z, Math<T>::mul_rn(t, d.z))};
}

// --- textures (texture.scm:12-50; bounce.py step's texture section) -------

// Checker (texture.scm:12-23): true when the winner's texture is a checker
// and the hit point lies in an odd cell.  `mat` is the winner's mtype slot.
template <typename T>
__device__ __forceinline__ bool checker_odd(const T* __restrict__ pk, int mat,
                                            V3<T> p) {
  if (ld(pk, mat + kTexk) != T(TEX_CHECKER)) return false;
  T sines = Math<T>::sin(T(10) * p.x) * Math<T>::sin(T(10) * p.y) *
            Math<T>::sin(T(10) * p.z);
  return sines < T(0);
}

// scene/perlin.py _hash_grad: one PCG4D round over (ix, iy, iz, seed) that
// returns after the second mix of a, b and c (no last xorshift, no d).
__device__ __forceinline__ void hash_grad(uint32_t& a, uint32_t& b,
                                          uint32_t& c, uint32_t d) {
  a = a * PCG_MULT + PCG_ADD;
  b = b * PCG_MULT + PCG_ADD;
  c = c * PCG_MULT + PCG_ADD;
  d = d * PCG_MULT + PCG_ADD;
  a += b * d; b += c * a; c += a * b; d += b * c;
  a ^= a >> 16; b ^= b >> 16; c ^= c >> 16;
  a += b * d; b += c * a; c += a * b;
}

// scene/perlin.py _to_sym: the top 24 bits to (-1, 1), exact in f32 and f64.
template <typename T>
__device__ __forceinline__ T to_sym(uint32_t bits) {
  return T(int32_t(bits >> 8)) * T(2.0 / 16777216.0) - T(1);
}

// scene/perlin.py noise_xyz: Hermite-smoothed lattice gradient noise, with
// the hashed gradient of each of the 8 corners normalised by
// rsqrt(max(g.g, 1e-12)).  With kGrad, g is d noise / d (x, y, z): floor and
// the hash carry none, the fade and the corner dots do.  Lattice coordinates
// are int32 read as uint32, so negative ones wrap as in the plain version.
// Not inlined: 8 hashes a call, and the callers (the lane body, the
// backward) keep their registers.
template <typename T, bool kGrad>
__device__ __noinline__ T perlin_noise(uint32_t seed, T x, T y, T z,
                                       V3<T>& g) {
  const T fx = Math<T>::floor(x), fy = Math<T>::floor(y),
          fz = Math<T>::floor(z);
  const uint32_t ix = uint32_t(int32_t(fx)), iy = uint32_t(int32_t(fy)),
                 iz = uint32_t(int32_t(fz));
  const T ux = x - fx, uy = y - fy, uz = z - fz;
  const T sx = ux * ux * (T(3) - T(2) * ux);          // perlin.scm:52-54
  const T sy = uy * uy * (T(3) - T(2) * uy);
  const T sz = uz * uz * (T(3) - T(2) * uz);
  const T dsx = T(6) * ux * (T(1) - ux);              // d fade / d u
  const T dsy = T(6) * uy * (T(1) - uy);
  const T dsz = T(6) * uz * (T(1) - uz);
  T acc = T(0);
  g = {T(0), T(0), T(0)};
#pragma unroll
  for (int di = 0; di < 2; ++di) {
#pragma unroll
    for (int dj = 0; dj < 2; ++dj) {
#pragma unroll
      for (int dk = 0; dk < 2; ++dk) {
        uint32_t a = ix + uint32_t(di), b = iy + uint32_t(dj),
                 c = iz + uint32_t(dk);
        hash_grad(a, b, c, seed);
        const T gx = to_sym<T>(a), gy = to_sym<T>(b), gz = to_sym<T>(c);
        const T q = gx * gx + gy * gy + gz * gz;
        const T inv = Math<T>::rsqrt(q < T(1e-12) ? T(1e-12) : q);
        const T dot = ((ux - T(di)) * gx + (uy - T(dj)) * gy +
                       (uz - T(dk)) * gz) * inv;
        const T wx = di ? sx : T(1) - sx;
        const T wy = dj ? sy : T(1) - sy;
        const T wz = dk ? sz : T(1) - sz;
        const T w = wx * wy * wz;
        acc = acc + w * dot;
        if (kGrad) {
          g.x += (di ? dsx : -dsx) * wy * wz * dot + w * gx * inv;
          g.y += (dj ? dsy : -dsy) * wx * wz * dot + w * gy * inv;
          g.z += (dk ? dsz : -dsz) * wx * wy * dot + w * gz * inv;
        }
      }
    }
  }
  return acc;
}

// scene/perlin.py turb_xyz: |sum over 7 octaves of 2^-k noise(2^k p)|
// (perlin.scm:92-103).  With kGrad, g is its gradient in p: each octave's
// weight and scale cancel exactly, and abs passes the sum's sign (0 at 0).
template <typename T, bool kGrad>
__device__ __forceinline__ T perlin_turb(uint32_t seed, V3<T> p, V3<T>& g) {
  T acc = T(0), weight = T(1);
  g = {T(0), T(0), T(0)};
  for (int k = 0; k < 7; ++k) {
    V3<T> gk;
    acc = acc + weight * perlin_noise<T, kGrad>(seed, p.x, p.y, p.z, gk);
    if (kGrad) g = add(g, gk);
    p = scale(p, T(2));
    weight = weight * T(0.5);
  }
  if (kGrad) {
    const T sgn = acc > T(0) ? T(1) : (acc < T(0) ? T(-1) : T(0));
    g = scale(g, sgn);
  }
  return Math<T>::abs(acc);
}

// texture.scm:25-28: gray noise(p * texs).
template <typename T>
__device__ __forceinline__ T noise_gray(const Statics& s, V3<T> p, T ts) {
  V3<T> g;
  return perlin_noise<T, false>(s.perlin_seed, p.x * ts, p.y * ts, p.z * ts,
                                g);
}

// texture.scm:30-34: the argument of marble's 0.5 (1 + sin(arg)),
// arg = texs p.z + 10 turb(p).
template <typename T>
__device__ __forceinline__ T marble_arg(const Statics& s, V3<T> p, T ts) {
  V3<T> g;
  return ts * p.z + T(10) * perlin_turb<T, false>(s.perlin_seed, p, g);
}

// The winner's surface coordinates, computed once, for the winner only: a
// rect's from its in-plane edge ranges (ops/rect.py), a sphere's from the
// outward unit normal wn sign(r) (ops/sphere.py sphere_uv, with the card's
// atan2), and (0, 0) for a ribbon or a medium.
template <typename T>
__device__ __forceinline__ void surface_uv(const T* __restrict__ pk, int kind,
                                           int b, V3<T> o, V3<T> d, T t,
                                           V3<T> wn, T rr, T& u, T& v) {
  u = v = T(0);
  if (kind == kRect) {
    const V3<T> av = ld3(pk, b + R_A), bv = ld3(pk, b + R_B);
    const T pa = dot(o, av) + t * dot(d, av);
    const T pb = dot(o, bv) + t * dot(d, bv);
    const T a0 = ld(pk, b + R_KA0), b0 = ld(pk, b + R_KB0);
    u = (pa - a0) / (ld(pk, b + R_KA1) - a0);
    v = (pb - b0) / (ld(pk, b + R_KB1) - b0);
  } else if (kSpheres && kind == kSphere) {
    const T sgn = rr > T(0) ? T(1) : (rr < T(0) ? T(-1) : T(0));
    const T nux = wn.x * sgn, nuy = wn.y * sgn, nuz = wn.z * sgn;
    const T phi = Math<T>::atan2(nuz, nux);
    const T q = T(1) - nuy * nuy;
    const T theta =
        Math<T>::atan2(nuy, Math<T>::sqrt(q < T(1e-12) ? T(1e-12) : q));
    u = T(1) - (phi + T(kPi)) / T(kTwoPi);
    v = (theta + T(kPi / 2.0)) / T(kPi);
  }
}

// texture.scm:36-50: the clamped nearest texel of (u, v), v flipped.  An
// image-textured winner carries (iw, ih, first atlas row) in its ALB0 slots;
// channel ch of the texel lies at atlas[idx[ch]].  Every index is clamped
// into the atlas, so no metadata forms an address outside it.
template <typename T>
__device__ __forceinline__ void texel_index(const T* __restrict__ pk,
                                            const Statics& s, int mat, T u,
                                            T v, int idx[3]) {
  const T iw = ld(pk, mat + kAlb0), ih = ld(pk, mat + kAlb0 + 1);
  const T iw1 = iw - T(1) < T(0) ? T(0) : iw - T(1);
  const T ih1 = ih - T(1) < T(0) ? T(0) : ih - T(1);
  T fi = u * iw;
  fi = fi < T(0) ? T(0) : fi;
  fi = fi > iw1 ? iw1 : fi;
  T fj = (T(1) - v) * ih - T(0.001);
  fj = fj < T(0) ? T(0) : fj;
  fj = fj > ih1 ? ih1 : fj;
  const int flat = int(fj) * int(iw) + int(fi);
  const int nck = (int(iw * ih) + 127) / 128;
  const int cb = int(ld(pk, mat + kAlb0 + 2));
  const int last = s.img_rows * 128 - 1;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const int i = (cb + ch * nck) * 128 + flat;
    idx[ch] = i < 0 ? 0 : (i > last ? last : i);
  }
}

// The winner's albedo by its texture kind: constant, checker, noise,
// marble or image (the step's texture section).  The procedural kinds run
// only for the winner whose texk asks for them: marble is 56 hashes a hit.
template <typename T>
__device__ __forceinline__ V3<T> albedo(const T* __restrict__ pk,
                                        const T* __restrict__ atlas,
                                        const Statics& s, int mat, int kind,
                                        int b, V3<T> o, V3<T> d, T t, V3<T> p,
                                        V3<T> wn, T rr) {
  const T texk = ld(pk, mat + kTexk);
  if (kPerlin && texk == T(TEX_NOISE)) {
    const T g = noise_gray<T>(s, p, ld(pk, mat + kTexs));
    return {g, g, g};
  }
  if (kPerlin && texk == T(TEX_MARBLE)) {
    const T g = T(0.5) * (T(1) + Math<T>::sin(
                                     marble_arg<T>(s, p, ld(pk, mat + kTexs))));
    return {g, g, g};
  }
  if (kImage && texk == T(TEX_IMAGE)) {
    T u, v;
    int idx[3];
    surface_uv<T>(pk, kind, b, o, d, t, wn, rr, u, v);
    texel_index<T>(pk, s, mat, u, v, idx);
    return {__ldg(atlas + idx[0]), __ldg(atlas + idx[1]),
            __ldg(atlas + idx[2])};
  }
  return ld3(pk, mat + (checker_odd<T>(pk, mat, p) ? kAlb1 : kAlb0));
}

// Metal's unit-ball draw (util.scm:9-15, analytic; cbrt for the radius).
template <typename T>
__device__ __forceinline__ V3<T> fuzz_ball(const T u[4]) {
  T bz = T(2) * u[1] - T(1);
  T bphi = T(kTwoPi) * u[2];
  T br = Math<T>::cbrt(u[3]);
  T one_m = T(1) - bz * bz;
  T bs = Math<T>::sqrt(one_m < T(0) ? T(0) : one_m);
  return {br * bs * Math<T>::cos(bphi), br * bs * Math<T>::sin(bphi), br * bz};
}

// Dielectric's reflect-or-refract choice (material.scm:76-101): the
// Schlick reflectance, with x^5 multiplied out.
template <typename T>
__device__ __forceinline__ T schlick_prob(T ref_idx, T cosine, bool refr_ok) {
  T r0 = (T(1) - ref_idx) / (T(1) + (ref_idx == T(-1) ? T(1) : ref_idx));
  r0 = r0 * r0;
  T x = T(1) - cosine;
  x = x < T(0) ? T(0) : x;
  T x2 = x * x;
  T schlick = r0 + (T(1) - r0) * (x2 * x2 * x);
  return refr_ok ? schlick : T(1);
}

// One bounce of one lane (bounce.py:step): regenerate a fresh lane's camera
// ray, sweep the rects, spheres, kleins and ribbons for the closest hit, let
// a medium scatter before it, add the sky on a miss and the emission on a
// hit, and scatter by the winner's material (a sphere's normal comes from its
// hit point, a klein's from its DE's gradient there, a ribbon's is -d, a
// medium's is (1, 0, 0)).  `atlas` holds the image texels (null
// for a plan without image textures).  o, d, time, rad and tp are updated in
// place; returns `scattering`.  Lanes that cannot scatter (dead, missed, at
// the bounce cap) skip the shading, and only the winning material's rule
// runs, with only the PCG4D column groups that rule draws from.  Every
// thread of the lane's tile `tl` runs it and ends with the same values.  The
// klein marches add their work to *kw where kw is not null.
template <typename T>
__device__ __forceinline__ bool bounce_lane(const T* __restrict__ pk,
                                            const T* __restrict__ atlas,
                                            const Statics& s, T t_min,
                                            T t_max, uint32_t item, T px,
                                            T py, bool fresh, bool alive,
                                            int depth, V3<T>& o, V3<T>& d,
                                            T& time, V3<T>& rad, V3<T>& tp,
                                            const Tile& tl,
                                            KleinWork* kw = nullptr) {
  // --- regenerate fresh lanes (camera rays; main.scm:452-469) ------------
  if (fresh) {
    camera_ray<T>(pk, s, item, px, py, o, d, time);
    rad = {T(0), T(0), T(0)};
    tp = {T(1), T(1), T(1)};
  }

  // --- closest hit: rects, spheres, ribbons, then media, in pack order
  // (geometry.scm:33-50, 545-578)
  T best_t;
  int kind;
  HitExtra<T> ex;
  const int best_b = closest_hit<T>(pk, s, item, depth, alive, o, d, time,
                                    t_min, t_max, best_t, kind, ex, tl, kw);
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
    V3<T> wn = {T(1), T(0), T(0)};                // a medium's
    T rr = T(1);
    if (kSpheres && kind == kSphere) {
      SphereHit<T> h;
      sphere_centre<T>(pk, s, best_b, time, h);
      rr = ld(pk, best_b + S_R);
      wn = sphere_normal(p, h.c, rr);
    } else if (kind == kRect) {
      wn = ld3(pk, best_b + R_WN);
    } else if (kBeziers && kind == kBezier) {
      wn = {-d.x, -d.y, -d.z};                    // B11: normal = -ray dir
    } else if (kKleins && kind == kKlein) {
      wn = klein_normal<T>(pk, best_b, p);
    }
    const int mat = best_b + mat_offset(kind);
    const T mtype = ld(pk, mat);
    // --- albedo by texture kind (texture.scm:12-50) ---------------------
    const V3<T> alb = albedo<T>(pk, atlas, s, mat, kind, best_b, o, d, best_t,
                                p, wn, rr);
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
        V3<T> fuzzed = add(refl, scale(ball, ld(pk, mat + kFuzz)));
        sc_ok = dot(fuzzed, wn) > T(0);
        dir = unit(fuzzed);
        mult = alb;
      } else if (mtype == T(MAT_DIELECTRIC)) {
        // material.scm:76-101
        uniforms4<T>(s.seed, item, uint32_t(depth), 2u, u);
        T ref_idx = ld(pk, mat + kRef);
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
  return scattering;
}

// --- The packed pool state (bounce.py N_PACKED; persist.py N_STATE) -------
// A lane's state is one column of a [N_PACKED, m] float32 array, one value
// per row: item (int32 bits), fresh (0/1), depth (int32 bits), o, d, time,
// rad, tp.  The int rows are only ever moved and reinterpreted
// (__float_as_int / __int_as_float), never touched by float arithmetic:
// small ints are denormal floats.
constexpr int N_PACKED = 16;

// The strided work queue of the packed and persistent pools.
struct Queue {
  int m, n_work, n_pix, pix0, total_pix;
};

// One iteration of the strided pool on a lane's packed state v
// (bounce.py:1937-1970, persist.py:69-111): the lane's work item `item`
// renders global pixel pix0 + item % n_pix of pass item / n_pix, keyed by
// gitem = (sample_base + item / n_pix) * total_pix + pix0 + item % n_pix,
// wrapped as the JAX int32 is (uint32 arithmetic here: signed overflow is
// undefined in C++).  A lane whose path terminates re-issues itself the
// item m further on.  Lanes with item >= n_work are drained and change
// nothing but their fresh and depth words (both become 0), as in the
// reference, where the step runs on them with alive = false.  Returns
// alive; `terminated` and `pix` (item % n_pix) describe the finished path.
// Every thread of the lane's tile `tl` runs it on the same v (a copy each)
// and ends with the same v; the caller stores from the first thread only.
// The klein marches add their work to *kw where kw is not null.
__device__ __forceinline__ bool packed_step(const float* __restrict__ pk,
                                            const float* __restrict__ atlas,
                                            const Statics& s, float t_min,
                                            float t_max, const Queue& q,
                                            int32_t sample_base,
                                            float v[N_PACKED],
                                            bool& terminated, int& pix,
                                            const Tile& tl,
                                            KleinWork* kw = nullptr) {
  const int32_t item = __float_as_int(v[0]);
  const bool fresh = v[1] != 0.0f;
  const int32_t depth = __float_as_int(v[2]);
  const bool alive = item < q.n_work;
  pix = item % q.n_pix;
  bool scattering = false;
  if (alive) {
    const int32_t gpix = q.pix0 + pix;
    const uint32_t gitem =
        (uint32_t(sample_base) + uint32_t(item / q.n_pix)) *
            uint32_t(q.total_pix) + uint32_t(gpix);
    V3<float> o = {v[3], v[4], v[5]};
    V3<float> d = {v[6], v[7], v[8]};
    float time = v[9];
    V3<float> rad = {v[10], v[11], v[12]};
    V3<float> tp = {v[13], v[14], v[15]};
    scattering = bounce_lane<float>(pk, atlas, s, t_min, t_max, gitem,
                                    float(gpix % s.nx), float(gpix / s.nx),
                                    fresh, true, depth, o, d, time, rad, tp,
                                    tl, kw);
    v[3] = o.x;  v[4] = o.y;  v[5] = o.z;
    v[6] = d.x;  v[7] = d.y;  v[8] = d.z;
    v[9] = time;
    v[10] = rad.x;  v[11] = rad.y;  v[12] = rad.z;
    v[13] = tp.x;  v[14] = tp.y;  v[15] = tp.z;
  }
  terminated = alive && !scattering;
  if (terminated) v[0] = __int_as_float(int32_t(uint32_t(item) + uint32_t(q.m)));
  v[1] = terminated ? 1.0f : 0.0f;
  v[2] = __int_as_float(scattering ? depth + 1 : 0);
  return alive;
}

}  // namespace
