// bounce_step_bwd.cu — the backward of one fused bounce, for sm_90a.
//
// Replaces the Pallas TPU kernel
//     scheme_raytrace_tpu/integrator/bounce.py:as_pallas_bwd
// with the coverage of bounce_step.cu (rects, spheres, moving spheres, any
// sphere count, kleins, bezier ribbons, constant media, Perlin and image
// textures), built per feature set as it is (bounce_common.cuh).  Given the
// step's INPUTS and the cotangents of its five float
// outputs (o', d', time', rad', tp'), it returns the cotangents of (pk, the
// image texels, o, d, time, rad, tp): the exact vector-Jacobian product of
// scheme_raytrace_torch/integrator/bounce.py:step, whose plain VJP
// (bounce.step_vjp, torch autograd) is its oracle.
//
// Design.  A tile of w threads per lane (w = 1, 2, 4 or 8, a kernel
// argument, as in bounce_step.cu), 256 threads per block.  Each lane replays
// the forward with the device functions of bounce_common.cuh, the same
// code bounce_step.cu runs, the closest-hit sweeps split over the tile, so
// the backward sees the lane the forward saw; the residuals are the step's
// inputs and nothing else.  Every thread of the tile runs the adjoint on
// the same values, and the tile's first thread writes the lane's
// cotangents and alone keeps its pk cotangent for the block's reductions
// (the others leave it empty), so every w gives w = 1's lane cotangents
// bit for bit and each lane enters the reductions once.  Then it runs the
// adjoint of the branch the lane took, written by hand section by section
// (camera regeneration, hit point, sky, emission, checker select, the
// mixture-PDF lambertian with its light sample and light value, metal,
// dielectric, the final selects).  Comparisons carry no gradient, so a lane
// touches only the header (camera and sky), its winner's slots and the
// light blocks.  A winning rect takes cotangent in its normal, plane
// constant, albedos, fuzz and index.  A winning sphere's normal is a
// function of the hit point, so its cotangent flows back into o, d and t;
// t's flows through the quadratic into o, d, the centres c0 and c1, the
// radius and, for a moving sphere, time, t0 and t1 (the time cotangent is
// an output, and reaches the camera header on fresh lanes).  A noise or
// marble albedo is a function of the hit point and of the winner's texture
// scale: its cotangent goes into p (and so into o, d and t) and into the
// TEXS slot; floor and the lattice hash carry none.  A winning medium's
// t = t1 + nid log(xi) sends cotangent to its M_NID and, through
// t1 = max(max(entry, eps), 0), to the entering slab's axis and bound and to
// o and d (a box) or to the centre and radius (a sphere boundary); its exit
// and the solid hit enter comparisons only.
//
// Bezier ribbons.  The march of the seeds carries no gradient.  A winning
// ribbon's t is the curve's distance zc(s) along the ray at the root s of
// g'(s) = 0, and the plain step attaches the root's implicit derivative,
// ds = -d(g' / max(g'', 0.05 |c'|^2 + 1e-12)) at fixed s.  So t's cotangent
// goes through zc's coefficients and through that quotient (the floor's
// maximum splits at a tie, max_adj) into the curve's power-basis
// coefficients, from them into the four control points, o and d, and through
// the projections into the ray-space frame u = v x d, v = unit(d x a), which
// is a function of d.  The normal -d sends its cotangent to d.  The width
// enters g < hw2 only and takes none.  Several seeds usually reach one root:
// the plain step folds the minimum over seeds in seed order, and each equal
// pair splits the cotangent, so n seeds at one t weigh 2^-(n-1), 2^-(n-1),
// 2^-(n-2), ..., 1/2 in seed order.  Where all of them sit at one s, bit for
// bit, their parts are equal and the kernel takes the first seed with weight
// one, which is exact; otherwise it marches the seeds again and weighs each
// seed at the winning t as the fold does (bezier_adj).
//
// Kleins.  The march carries no gradient.  A winning klein's t is the march's
// t_raw with the implicit-function correction t_raw - (corr - stop(corr)),
// corr = (DE - eps) / denom at p = o + t_raw d, denom = g . d kept off zero
// at +-1e-6 (a constant there), g the DE's gradient; its normal is unit(g).
// So t's cotangent reaches the DE and denom, the normal's reaches g, and
// both go into p - c, i.e. into o, d and the centre K_C (minus p's), through
// the DE's gradient g and its Hessian H: the cotangent v of g takes H v.  H
// is symmetric (g is a gradient), so H v is one more forward sweep of the
// fixed inversion loop along v, with second-order tangents beside the first
// ones (klein_hvp): no iteration state is stored, and the result equals
// autograd's reverse sweep to rounding.  A call (klein_adj), not inlined.
//
// Image texels.  The TPU kernel refuses image plans in reverse mode (its
// texel gather has no transpose there).  Here the albedo cotangent of a
// lane whose winner carries an image goes to the atlas: the texel index
// ends in an integer cast and carries no gradient, so the lane keeps its
// three flat atlas indices and its three cotangents, and the block reduces
// them as it reduces the winners' slots, into the A = img_rows * 128 entries
// that follow the P pk slots in its row of the partials.  No float atomics
// here either.
//
// The pk cotangent: each lane keeps its contributions in registers.  P
// grows with the scene (4,794 floats for the 227-sphere RTOW scene, where a
// [warps, P] array in shared memory would take 307 KB in f64, over the
// 227 KB a block may have), but a warp's lanes win at most 32 primitives.
// So each warp loops over the distinct winners of its lanes, in lane
// order, sums each winner's slots over the warp with a shuffle butterfly
// and leaves (winner, sums) in its own list in shared memory; the header
// slots and, per light, the light slots are summed the same way into small
// per-warp arrays.  Then the block adds the warps' entries in warp order
// into its row of the (blocks, P) partials in global memory (a list's
// winners are distinct, so one warp's entries go in parallel), and the
// wrapper sums the rows over blocks.  Shared memory does not depend on P
// (at most 40 KB in f64, with 18 slots a winner), no float atomics: two
// identical launches give bitwise-equal partials, and a scene without
// spheres gets the sums it got from the [warps, P] form.  Light slots are recomputed per
// light in the reduction (the light count is a runtime value) instead of
// being kept, and so are a medium's 20 geometry slots, per medium, and a
// ribbon's 12 control-point slots, per ribbon: a lane keeps its ray and its t
// cotangent, not the slots, and a medium's or a ribbon's list entry carries
// its material slots only.  A variant without moving spheres keeps 13 slots
// a winner, not 18, and one without media, ribbons or image textures leaves
// out their arrays.
//
// Conventions.  Every clamp of the plain step is a maximum (or a clip), and
// its adjoint goes through max_adj: at a tie the cotangent splits 0.5/0.5,
// as in JAX's maximum.  The adjoint guards exactly where the forward guards
// (the where-selected denominators and square roots) and adds no guard of
// its own.  One place
// differs from autograd by construction: a rect or a sphere that loses the
// closest-hit sweep gets no cotangent here, where autograd multiplies its
// (finite or, for a ray nearly in a rect's plane, overflowing) t-derivative
// by zero.
//
// What bounds it on an H100.  Per lane it reads the 19 inputs and 13
// cotangents and writes 13 cotangents, about 180 B in f32 (4.5 MB at the
// reverse pool's 24,576 lanes, plus 96 x P partials), and computes the
// forward's sweep and shading and about as much again for the adjoint: on
// Cornell bytes bound it, on the 227-sphere scene the sweep's operations.
// On a klein scene the replay's march dominates, with its divergence (see
// bounce_step.cu); a klein winner's adjoint adds two sweeps of the inversion
// loop.  The warp reductions add 5 shuffles per touched slot, distinct
// winner and warp.  The reverse pool's 24,576 lanes are ceil(24,576 w /
// 256) blocks: at w = 1 96 blocks of 98-128 registers a thread leave 36 of
// the 132 SMs idle and hold 8 warps on each of the others, so the launch
// waits for its slowest lane's chain; w = 2 fills every SM (192 blocks), and
// wider tiles repeat the adjoint's instructions on more threads than the
// card issues for free (PERF.md).  A block writes one row of partials, so
// the wrapper's sum over rows grows with w.  PERF.md holds what was
// measured.

#include "bounce_common.cuh"

namespace {

constexpr int kWarps = kThreads / 32;

// The adjoint of every clamp of the plain step, y = max(x, c): the share of
// y's cotangent g that reaches x.  All of it above c, none below, and half
// at a tie, as JAX's maximum (and torch.maximum) split it.
template <typename T>
__device__ __forceinline__ T max_adj(T x, T c, T g) {
  return x > c ? g : (x == c ? T(0.5) * g : T(0));
}

// y = min(x, c), the other side of a clip.
template <typename T>
__device__ __forceinline__ T min_adj(T x, T c, T g) {
  return max_adj(c, x, g);
}

// y = clip(x, lo, hi) = min(max(x, lo), hi).
template <typename T>
__device__ __forceinline__ T clip_adj(T x, T lo, T hi, T g) {
  return max_adj(x, lo, min_adj(x < lo ? lo : x, hi, g));
}

// Reverse of y = unit(a): dL/da from dL/dy.
template <typename T>
__device__ __forceinline__ V3<T> unit_adj(V3<T> a, V3<T> gy) {
  const T q = dot(a, a);
  const T lo = T(1e-12);
  const T s = Math<T>::rsqrt(q < lo ? lo : q);
  const T gq = max_adj(q, lo, T(-0.5) * s * s * s * dot(gy, a));
  return add(scale(gy, s), scale(a, T(2) * gq));
}

// Reverse of onb_local(w, x, y, zc): adds dL/dw to gw, returns dL/dx,
// dL/dy and dL/dzc.
template <typename T>
__device__ __forceinline__ void onb_local_adj(V3<T> w, T x, T y, T zc,
                                              V3<T> g, V3<T>& gw, T& gx,
                                              T& gy, T& gzc) {
  const bool pick_y = Math<T>::abs(w.x) > T(0.9);
  const V3<T> a = {pick_y ? T(0) : T(1), pick_y ? T(1) : T(0), T(0)};
  const V3<T> cr = cross(w, a);
  const V3<T> v = unit(cr);
  const V3<T> u = cross(v, w);
  gx = dot(g, u);
  gy = dot(g, v);
  gzc = dot(g, w);
  const V3<T> gu = scale(g, x);
  V3<T> gv = scale(g, y);
  gw = add(gw, scale(g, zc));
  gv = add(gv, cross(w, gu));                     // u = cross(v, w)
  gw = add(gw, cross(gu, v));
  gw = add(gw, cross(a, unit_adj(cr, gv)));       // v = unit(cross(w, a))
}

// Reverse of cosine_dir(u1, u2, w) in w.
template <typename T>
__device__ __forceinline__ V3<T> cosine_dir_adj(T u1, T u2, V3<T> w,
                                                V3<T> g_dir) {
  const T phi = T(kTwoPi) * u1;
  const T sr2 = Math<T>::sqrt(u2);
  const T one_m = T(1) - u2;
  const T zc = Math<T>::sqrt(one_m < T(0) ? T(0) : one_m);
  const T x = Math<T>::cos(phi) * sr2, y = Math<T>::sin(phi) * sr2;
  V3<T> gw = {T(0), T(0), T(0)};
  T gx, gy, gzc;
  onb_local_adj(w, x, y, zc, unit_adj(onb_local(w, x, y, zc), g_dir), gw, gx,
                gy, gzc);
  return gw;
}

// Reverse of refl = d - wn * (2 d.wn): adds to g_d and g_wn.
template <typename T>
__device__ __forceinline__ void reflect_adj(V3<T> d, V3<T> wn, V3<T> g,
                                            V3<T>& g_d, V3<T>& g_wn) {
  const T k = T(2) * dot(d, wn);
  const T g_dd = T(-2) * dot(g, wn);
  g_d = add(g_d, add(g, scale(wn, g_dd)));
  g_wn = add(g_wn, add(scale(g, -k), scale(d, g_dd)));
}

// Reverse of lights_sample in p and in the slots of light block b (the
// picked one), for the cotangent g_dir of the sampled direction: adds to
// g_p and to gl (indexed by the L_* offsets).
template <typename T>
__device__ void light_sample_adj(const T* __restrict__ pk, int b, T u_a,
                                 T u_b, T u_s1, T u_s2, V3<T> p, V3<T> g_dir,
                                 V3<T>& g_p, T gl[LGT_SIZE]) {
  if (ld(pk, b + L_KIND) < T(0.5)) {            // LIGHT_XZ_RECT
    const T x0 = ld(pk, b + L_X0), z0 = ld(pk, b + L_Z0);
    const V3<T> target = {x0 + u_a * (ld(pk, b + L_X1) - x0),
                          ld(pk, b + L_KY),
                          z0 + u_b * (ld(pk, b + L_Z1) - z0)};
    const V3<T> gt = unit_adj(sub(target, p), g_dir);
    g_p = sub(g_p, gt);
    gl[L_X0] += gt.x * (T(1) - u_a);
    gl[L_X1] += gt.x * u_a;
    gl[L_KY] += gt.y;
    gl[L_Z0] += gt.z * (T(1) - u_b);
    gl[L_Z1] += gt.z * u_b;
    return;
  }
  const T lo = T(1e-12);                        // LIGHT_SPHERE
  const V3<T> oc = sub(ld3(pk, b + L_C), p);
  const T q = dot(oc, oc);
  const T dist_sq = q < lo ? lo : q;
  const T radius = ld(pk, b + L_RAD);
  const T inner = T(1) - radius * radius / dist_sq;
  const bool outside = inner > T(0);
  const T ctm = outside ? Math<T>::sqrt(inner) : T(0);
  const T zc = T(1) + u_s2 * (ctm - T(1));
  const T phi = T(kTwoPi) * u_s1;
  const T zin = T(1) - zc * zc;
  const bool z_ok = zin > T(0);
  const T sz = z_ok ? Math<T>::sqrt(zin) : T(0);
  const T cph = Math<T>::cos(phi), sph = Math<T>::sin(phi);
  const V3<T> w = unit(oc);
  const V3<T> g_v1 = unit_adj(onb_local(w, cph * sz, sph * sz, zc), g_dir);
  V3<T> g_w = {T(0), T(0), T(0)};
  T gx, gy, g_zc;
  onb_local_adj(w, cph * sz, sph * sz, zc, g_v1, g_w, gx, gy, g_zc);
  const T g_sz = gx * cph + gy * sph;
  const T g_zin = z_ok ? T(0.5) * g_sz / sz : T(0);
  g_zc += T(-2) * zc * g_zin;
  const T g_ctm = g_zc * u_s2;
  const T g_inner = outside ? T(0.5) * g_ctm / ctm : T(0);
  const T g_dsq = g_inner * (radius * radius / (dist_sq * dist_sq));
  V3<T> g_oc = unit_adj(oc, g_w);
  g_oc = add(g_oc, scale(oc, T(2) * max_adj(q, lo, g_dsq)));
  gl[L_C] += g_oc.x;
  gl[L_C + 1] += g_oc.y;
  gl[L_C + 2] += g_oc.z;
  gl[L_RAD] += g_inner * (T(-2) * radius / dist_sq);
  g_p = sub(g_p, g_oc);
}

// Reverse of light block b's term of lights_value (before the mean), for
// its cotangent g_val: adds to g_p, g_d and gl.
template <typename T>
__device__ void light_value_adj(const T* __restrict__ pk, int b, V3<T> p,
                                V3<T> d, T g_val, V3<T>& g_p, V3<T>& g_d,
                                T gl[LGT_SIZE]) {
  const T lo = T(1e-12);
  if (ld(pk, b + L_KIND) < T(0.5)) {
    const T ady = Math<T>::abs(d.y);
    if (!(ady > T(1e-9))) return;
    const T x0 = ld(pk, b + L_X0), x1 = ld(pk, b + L_X1);
    const T z0 = ld(pk, b + L_Z0), z1 = ld(pk, b + L_Z1);
    const T t = (ld(pk, b + L_KY) - p.y) / d.y;
    const T hx = p.x + t * d.x;
    const T hz = p.z + t * d.z;
    if (!(t > T(1e-3) && t < T(1e8) && hx >= x0 && hx <= x1 && hz >= z0 &&
          hz <= z1))
      return;
    const T area = (x1 - x0) * (z1 - z0);
    const T den = ady * area;
    const T denom = den < lo ? lo : den;
    const T g_t = g_val * T(2) * t / denom;          // v = t * t / denom
    const T g_den = max_adj(den, lo, -g_val * t * t / (denom * denom));
    const T g_area = g_den * ady;
    gl[L_X1] += g_area * (z1 - z0);
    gl[L_X0] -= g_area * (z1 - z0);
    gl[L_Z1] += g_area * (x1 - x0);
    gl[L_Z0] -= g_area * (x1 - x0);
    const T g_num = g_t / d.y;                       // t = (ky - p.y) / d.y
    gl[L_KY] += g_num;
    g_p.y -= g_num;
    const T sgn = d.y > T(0) ? T(1) : (d.y < T(0) ? T(-1) : T(0));
    g_d.y += -g_t * t / d.y + g_den * area * sgn;
    return;
  }
  const V3<T> oc = sub(ld3(pk, b + L_C), p);
  const T dist_sq = dot(oc, oc);
  const T radius = ld(pk, b + L_RAD);
  const T r2 = radius * radius;
  if (!(dist_sq > r2)) return;
  const T mdsq = dist_sq < lo ? lo : dist_sq;
  const T x = r2 / mdsq;
  const T ratio = x < T(0) ? T(0) : (x > T(1) ? T(1) : x);
  const T ctm = Math<T>::sqrt(T(1) - ratio);
  const T solid = T(kTwoPi) * (T(1) - ctm);
  if (!(dot(unit(d), unit(oc)) >= ctm)) return;
  const T ms = solid < lo ? lo : solid;              // v = 1 / ms
  const T g_solid = max_adj(solid, lo, -g_val / (ms * ms));
  const T g_ctm = -T(kTwoPi) * g_solid;
  const T g_ratio = -T(0.5) * g_ctm / ctm;
  const T g_x = clip_adj(x, T(0), T(1), g_ratio);
  const T g_mdsq = -g_x * r2 / (mdsq * mdsq);
  gl[L_RAD] += g_x / mdsq * T(2) * radius;
  const V3<T> g_oc = scale(oc, T(2) * max_adj(dist_sq, lo, g_mdsq));
  gl[L_C] += g_oc.x;
  gl[L_C + 1] += g_oc.y;
  gl[L_C + 2] += g_oc.z;
  g_p = sub(g_p, g_oc);
}

// The geometry slots of a medium block that take cotangent, M_AX .. M_NID,
// as one array indexed from M_AX.
constexpr int kMedSlots = M_NID - M_AX + 1;

// Reverse of a winning medium's t = t1 + nid lx in o, d and the slots of
// medium block b, for t's cotangent g_t: adds to g_o, g_d and gm (indexed
// from M_AX).  Replays medium_interval; every max and min of the plain step
// splits its cotangent at a tie (max_adj).
template <typename T>
__device__ void medium_adj(const T* __restrict__ pk, int b, V3<T> o, V3<T> d,
                           T eps, T big, T lx, T g_t, V3<T>& g_o, V3<T>& g_d,
                           T gm[kMedSlots]) {
  gm[M_NID - M_AX] += g_t * lx;
  const bool box = ld(pk, b + M_KIND) < T(0.5);
  // t1 = max(max(entry, eps), 0): the cotangent of entry
  T entry, exit_;
  medium_interval<T>(pk, b, o, d, big, entry, exit_);
  const T m1 = entry < eps ? eps : entry;
  T g = max_adj(entry, eps, max_adj(m1, T(0), g_t));
  if (!box) {
    // entry = -bq - sq, sq = sqrt(disc), disc = bq bq - cq,
    // cq = oc.oc - r r, bq = oc.d, oc = o - c
    const V3<T> oc = sub(o, ld3(pk, b + M_C));
    const T rr = ld(pk, b + M_RAD);
    const T bq = dot(oc, d);
    const T disc = bq * bq - (dot(oc, oc) - rr * rr);
    const T sq = Math<T>::sqrt(disc);
    const T g_disc = T(-0.5) * g / sq;
    const T g_bq = T(2) * bq * g_disc - g;
    const V3<T> g_oc = add(scale(oc, T(-2) * g_disc), scale(d, g_bq));
    g_d = add(g_d, scale(oc, g_bq));
    g_o = add(g_o, g_oc);
    gm[M_C - M_AX] -= g_oc.x;
    gm[M_C - M_AX + 1] -= g_oc.y;
    gm[M_C - M_AX + 2] -= g_oc.z;
    gm[M_RAD - M_AX] += T(2) * rr * g_disc;
    return;
  }
  // entry = max(max(max(-big, lo_0), lo_1), lo_2): replay, then reverse
  T lo_t[3], pre[3];
  T en = -big;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int ab = b + M_AX + a * 5;
    const V3<T> ax = ld3(pk, ab);
    const T lo = ld(pk, ab + 3), hi = ld(pk, ab + 4);
    const T pa = dot_rn(o, ax), da = dot_rn(d, ax);
    if (Math<T>::abs(da) > T(1e-12)) {
      const T inv = T(1) / da;
      const T ta = Math<T>::mul_rn(lo - pa, inv);
      const T tb = Math<T>::mul_rn(hi - pa, inv);
      lo_t[a] = ta < tb ? ta : tb;
    } else {
      lo_t[a] = (pa >= lo && pa <= hi) ? -big : big;
    }
    pre[a] = en;
    en = en < lo_t[a] ? lo_t[a] : en;
  }
#pragma unroll
  for (int a = 2; a >= 0; --a) {
    const T g_lo = max_adj(lo_t[a], pre[a], g);
    g = max_adj(pre[a], lo_t[a], g);
    if (g_lo == T(0)) continue;
    const int ab = b + M_AX + a * 5;
    const V3<T> ax = ld3(pk, ab);
    const T lo = ld(pk, ab + 3), hi = ld(pk, ab + 4);
    const T pa = dot_rn(o, ax), da = dot_rn(d, ax);
    if (!(Math<T>::abs(da) > T(1e-12))) continue;   // a constant there
    // lo_t = min(ta, tb), ta = (lo - pa) inv, tb = (hi - pa) inv, inv = 1/da
    const T inv = T(1) / da;
    const T ta = Math<T>::mul_rn(lo - pa, inv);
    const T tb = Math<T>::mul_rn(hi - pa, inv);
    const T g_ta = min_adj(ta, tb, g_lo), g_tb = min_adj(tb, ta, g_lo);
    const T g_pa = -(g_ta + g_tb) * inv;
    const T g_inv = g_ta * (lo - pa) + g_tb * (hi - pa);
    const T g_da = -g_inv * inv * inv;
    gm[a * 5 + 3] += g_ta * inv;
    gm[a * 5 + 4] += g_tb * inv;
    gm[a * 5] += o.x * g_pa + d.x * g_da;
    gm[a * 5 + 1] += o.y * g_pa + d.y * g_da;
    gm[a * 5 + 2] += o.z * g_pa + d.z * g_da;
    g_o = add(g_o, scale(ax, g_pa));
    g_d = add(g_d, scale(ax, g_da));
  }
}

// The cotangents of a ribbon's power-basis coefficients from one seed: the
// cotangent g of zc(s) at the seed's root s, through zc's own coefficients
// and, for an interior root, through the implicit derivative of the root,
// s - (corr - stop(corr)) with corr = g' / max(g'', 0.05 |c'|^2 + 1e-12).
template <typename T>
__device__ __forceinline__ void bezier_seed_adj(const BezierCurve<T>& c, T s,
                                                T g, T gax[4], T gay[4],
                                                T gaz[4]) {
  const T s2 = s * s, s3 = s2 * s;
  gaz[0] += g;
  gaz[1] += g * s;
  gaz[2] += g * s2;
  gaz[3] += g * s3;
  if (!(s > T(0) && s < T(1))) return;          // corr is the constant 0
  const T g_corr =
      -g * (c.az[1] + s * (T(2) * c.az[2] + T(3) * s * c.az[3]));
  const BezierG<T> r = bezier_g(c, s);          // at the root, s fixed
  const T floor_ = add_(mul_(T(0.05), r.speed2), T(1e-12));
  const T safe = r.d2g < floor_ ? floor_ : r.d2g;
  const T g_dg = g_corr / safe;
  const T g_safe = -g_corr * r.dg / (safe * safe);
  const T g_d2g = max_adj(r.d2g, floor_, g_safe);
  const T g_sp = T(0.05) * max_adj(floor_, r.d2g, g_safe) + g_d2g;
  // g' = 2 c.c', |c'|^2 term 2 c'.c', g'' = that + 2 c.c''; per axis
  const T cv[2][3] = {{r.cx, r.cx1, r.cx2}, {r.cy, r.cy1, r.cy2}};
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    T* ga = a == 0 ? gax : gay;
    const T g_c = T(2) * (g_d2g * cv[a][2] + g_dg * cv[a][1]);
    const T g_c1 = T(4) * g_sp * cv[a][1] + T(2) * g_dg * cv[a][0];
    const T g_c2 = T(2) * g_d2g * cv[a][0];
    ga[0] += g_c;
    ga[1] += g_c * s + g_c1;
    ga[2] += g_c * s2 + T(2) * s * g_c1 + T(2) * g_c2;
    ga[3] += g_c * s3 + T(3) * s2 * g_c1 + T(6) * s * g_c2;
  }
}

// The control-point slots of a bezier block, B_CP .. B_CP + 11.
constexpr int kBezSlots = 12;

// Reverse of a winning ribbon's t in o, d and the control points of bezier
// block b, for t's cotangent g_t: adds to g_o, g_d and gb (indexed from
// B_CP).  h is the probe's record of the winner (t, the first seed's root,
// the seeds tied at t).  Replays the frame and the curve, and the march as
// well where tied seeds sit at different roots: the tile marches w seeds
// side by side, one a thread, and every thread of it then takes their
// roots in seed order, so the tied seeds' parts are added in the order of
// the one-thread loop and every w gives the same sums bit for bit.
template <typename T>
__device__ __noinline__ void bezier_adj(const T* __restrict__ pk,
                                        const Statics& st, int b, V3<T> o,
                                        V3<T> d, T t_min, T big,
                                        BezierHit<T> h, T g_t, V3<T>& g_o,
                                        V3<T>& g_d, T gb[kBezSlots],
                                        const Tile tl) {
  const BezierFrame<T> f = bezier_frame(d);
  BezierCurve<T> c;
  bezier_curve<T>(pk, b, o, d, f, c);
  T ga[3][4];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int k = 0; k < 4; ++k) ga[a][k] = T(0);
  if (h.ties <= 1 || h.same_s) {
    bezier_seed_adj(c, h.s, g_t, ga[0], ga[1], ga[2]);
  } else {
    // the fold's weights, in seed order: 2^-(n-1), 2^-(n-1), ..., 1/4, 1/2
    const T half_w = ld(pk, b + B_W) * T(0.5);
    const T hw2 = mul_(half_w, half_w);
    int seen = 0;
    for (int k0 = 0; k0 < st.bez_seeds; k0 += tl.w) {
      const int k = k0 + tl.r;
      T s = T(0), zc = T(0);
      const bool tied =
          k < st.bez_seeds &&
          bezier_seed<T>(c, k, st.bez_seeds, st.bez_newton, hw2, t_min, big,
                         s, zc) &&
          zc == h.t;
      for (int q = 0; q < tl.w && k0 + q < st.bez_seeds; ++q) {
        const T sq = tl.w == 1 ? s : __shfl_sync(tl.mask, s, q, tl.w);
        const bool tq =
            tl.w == 1 ? tied : __shfl_sync(tl.mask, int(tied), q, tl.w) != 0;
        if (!tq) continue;
        ++seen;
        T w = T(1);
        for (int e = h.ties - (seen < 2 ? 2 : seen) + 1; e > 0; --e)
          w *= T(0.5);
        bezier_seed_adj(c, sq, g_t * w, ga[0], ga[1], ga[2]);
      }
    }
  }
  // power basis -> Bernstein control values (bezier_power), per axis; then
  // the projections rel_k . u, rel_k . v, rel_k . d with rel_k = cp_k - o
  V3<T> g_u = {T(0), T(0), T(0)}, g_v = g_u;
  T gp[3][4];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    gp[a][0] = ga[a][0] - T(3) * ga[a][1] + T(3) * ga[a][2] - ga[a][3];
    gp[a][1] = T(3) * ga[a][1] - T(6) * ga[a][2] + T(3) * ga[a][3];
    gp[a][2] = T(3) * ga[a][2] - T(3) * ga[a][3];
    gp[a][3] = ga[a][3];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const V3<T> rel = sub(ld3(pk, b + B_CP + 3 * k), o);
    const V3<T> g_rel = add(add(scale(f.u, gp[0][k]), scale(f.v, gp[1][k])),
                            scale(d, gp[2][k]));
    gb[3 * k] += g_rel.x;
    gb[3 * k + 1] += g_rel.y;
    gb[3 * k + 2] += g_rel.z;
    g_o = sub(g_o, g_rel);
    g_u = add(g_u, scale(rel, gp[0][k]));
    g_v = add(g_v, scale(rel, gp[1][k]));
    g_d = add(g_d, scale(rel, gp[2][k]));
  }
  // the frame: u = v x d, v = unit(cr), cr = d x a
  g_v = add(g_v, cross(d, g_u));
  g_d = add(g_d, cross(g_u, f.v));
  const V3<T> a = {f.pick ? T(0) : T(1), f.pick ? T(1) : T(0), T(0)};
  g_d = add(g_d, cross(a, unit_adj(f.cr, g_v)));
}

// H v for the klein centred at c at the point p: the derivative of the DE's
// gradient g (klein_dist_grad) along v.  The inversion loop again, each of
// its values carried with its derivative along v (a primed name): the
// primal P, dr, the tangents t_j and dd_j, and P', dr', t_j', dd_j', 32
// values in registers; the selected spheres are the primal's.
template <typename T>
__device__ __forceinline__ V3<T> klein_hvp(V3<T> c, V3<T> p, V3<T> v) {
  const T tiny = Math<T>::tiny();
  // the primal rounded as klein_dist_grad rounds it: the same spheres invert
  V3<T> P = {sub_(p.x, c.x), sub_(p.y, c.y), sub_(p.z, c.z)}, Pp = v;
  T dr = T(1), drp = T(0);
  V3<T> tj[3] = {{T(1), T(0), T(0)}, {T(0), T(1), T(0)}, {T(0), T(0), T(1)}};
  V3<T> tp[3] = {{T(0), T(0), T(0)}, {T(0), T(0), T(0)}, {T(0), T(0), T(0)}};
  T dd[3] = {T(0), T(0), T(0)}, ddp[3] = {T(0), T(0), T(0)};
  for (int it = 0; it < kKleinIters; ++it) {
    V3<T> x, sp;
    T d2;
    if (klein_select<T>(P, x, sp, d2) < 0) break;
    const V3<T> xp = Pp;
    const T inv = T(1) / (d2 < tiny ? tiny : d2);
    const T invp = d2 > tiny ? -inv * inv * (T(2) * dot(x, xp)) : T(0);
    const T sc = mul_(T(kKleinR2), inv), scp = T(kKleinR2) * invp;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const T a = dot(x, tj[j]);
      const T ap = dot(xp, tj[j]) + dot(x, tp[j]);
      const T w = T(2) * a * inv;
      const T wp = T(2) * (ap * inv + a * invp);
      const V3<T> e = sub(tj[j], scale(x, w));
      tp[j] = add(scale(e, scp),
                  scale(sub(sub(tp[j], scale(xp, w)), scale(x, wp)), sc));
      tj[j] = scale(e, sc);
      const T f = dd[j] - w * dr;
      ddp[j] = scp * f + sc * (ddp[j] - wp * dr - w * drp);
      dd[j] = sc * f;
    }
    Pp = add(scale(xp, sc), scale(x, scp));
    P = {add_(mul_(x.x, sc), sp.x), add_(mul_(x.y, sc), sp.y),
         add_(mul_(x.z, sc), sp.z)};
    drp = drp * sc + dr * scp;
    dr = mul_(dr, sc);
  }
  const T q = dot(P, P);
  const T ln = Math<T>::sqrt(q < tiny ? tiny : q);
  const T lnp = q > tiny ? dot(P, Pp) / ln : T(0);
  const T k = T(kKleinDeScale) / Math<T>::abs(dr);
  const T kp = -k * drp / dr;
  const T rat = (ln - T(kKleinR)) / dr;
  const T ratp = (lnp - rat * drp) / dr;
  T hv[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const T e = dot(P, tj[j]) / ln;
    const T ep = (dot(Pp, tj[j]) + dot(P, tp[j])) / ln - e * lnp / ln;
    hv[j] = kp * (e - rat * dd[j]) + k * (ep - ratp * dd[j] - rat * ddp[j]);
  }
  return {hv[0], hv[1], hv[2]};
}

// Reverse of a winning klein's t and normal wn in o, d and its centre, for
// their cotangents g_t and g_wn: adds to g_o, g_d and g_c (the K_C slots).
// t_raw is the march's t (best_t), which carries no gradient.
template <typename T>
__device__ __noinline__ void klein_adj(const T* __restrict__ pk, int b,
                                       V3<T> o, V3<T> d, T t_raw, T g_t,
                                       V3<T> g_wn, V3<T>& g_o, V3<T>& g_d,
                                       V3<T>& g_c) {
  const V3<T> c = ld3(pk, b + K_C);
  const V3<T> p = ray_at(o, t_raw, d);
  V3<T> g;
  const T dist = klein_dist_grad<T>(c, p, g);
  const T ddt = dot(g, d);
  const bool wide = Math<T>::abs(ddt) > T(1e-6);
  const T denom = wide ? ddt : (ddt >= T(0) ? T(1e-6) : T(-1e-6));
  // t = t_raw - corr + stop(corr), corr = (dist - eps) / denom
  const T g_dist = -g_t / denom;
  const T g_ddt = wide ? g_t * (dist - T(kKleinEps)) / (denom * denom) : T(0);
  // wn = unit(g), ddt = g . d
  const V3<T> g_g = add(unit_adj(g, g_wn), scale(d, g_ddt));
  g_d = add(g_d, scale(g, g_ddt));
  // dist = DE(q), g = grad DE(q), q = o + t_raw d - c
  const V3<T> g_q = add(scale(g, g_dist), klein_hvp<T>(c, p, g_g));
  g_o = add(g_o, g_q);
  g_d = add(g_d, scale(g_q, t_raw));
  g_c = sub(g_c, g_q);
}

// Sum over the warp in a fixed butterfly order; every lane gets the sum.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

template <typename T>
struct BwdParams {
  const T* pk;
  const int32_t* gitem;
  const T* px;
  const T* py;
  const bool* fresh;
  const bool* alive;
  const int32_t* depth;
  const T* in[13];     // ox oy oz dx dy dz time rx ry rz tx ty tz
  const T* ct[13];     // cotangents of the same columns after the bounce
  T* dpk_part;         // [blocks, P + img_rows * 128]: pk, then the atlas
  T* out[13];          // cotangents of the input columns
  const T* atlas;      // [img_rows, 128] image texels; null without images
  Statics s;
  int P;
  int w;               // threads a lane (the tile's width)
  T t_min, t_max;
};

// A lane's pk cotangent, kept for the block reduction: the header slots,
// its winner's slots, and what the light and medium slots' recomputation
// needs.  The winner's kind follows from its offset (win_kind).
template <typename T>
struct LaneGrads {
  T hdr[HDR_SIZE];
  bool cam, sky;     // the camera / sky slots are touched
  int win;           // the winner's pk offset (-1: none)
  bool odd;          // its checker picked ALB1
  V3<T> wn;          // -> R_WN; a sphere's S_C0
  T k;               // -> R_K; a sphere's S_R
  V3<T> c1;          // -> a moving scene's sphere: S_C1
  T st0, st1;        // -> and S_T0, S_T1
  V3<T> alb;         // -> the material's ALB0, or ALB1 when odd
  T fuzz, ref, texs; // -> its FUZZ, REF and TEXS
  bool med;          // the winner is a medium whose t takes cotangent
  V3<T> mo, md;      // its ray (a winning ribbon's too)
  T m_lx, m_gt;      // its log(xi) and t's cotangent (a ribbon's t's too)
  bool bez;          // the winner is a ribbon
  BezierHit<T> bh;   // its probe's record
  bool lam_ls;       // a light-sampled lambertian scatter
  V3<T> lp, ldir;    // its hit point and direction
  T g_lv;            // the cotangent of each light's lights_value term
  int l_pick;        // the sampled light (-1: the cosine lobe)
  T lu[4];           // the light sample's uniforms
  V3<T> g_ls;        // the cotangent of the sampled direction
  int tex[3];        // the texel's atlas index a channel (tex[0] -1: none)
  V3<T> g_tex;       // the texel's cotangent
};

// The adjoint of lane i: replays the forward, writes the lane's 13 input
// cotangents and leaves its pk cotangent in c (zeroed, win = l_pick =
// tex[0] = -1, by the caller).  Every thread of the lane's tile runs it on
// the same values (the replayed sweeps split over the tile); the tile's
// first thread writes the cotangents.
template <typename T>
__device__ __forceinline__ void lane_adjoint(const BwdParams<T>& prm, int i,
                                             LaneGrads<T>& c,
                                             const Tile& tl) {
  const Statics& s = prm.s;
  const T* __restrict__ pk = prm.pk;
  const T lo = T(1e-12);
  const uint32_t item = uint32_t(prm.gitem[i]);
  const bool fresh = prm.fresh[i];
  const bool alive = prm.alive[i];
  const int depth = prm.depth[i];
  V3<T> o = {prm.in[0][i], prm.in[1][i], prm.in[2][i]};
  V3<T> d = {prm.in[3][i], prm.in[4][i], prm.in[5][i]};
  T time = prm.in[6][i];
  V3<T> tp = {prm.in[10][i], prm.in[11][i], prm.in[12][i]};
  const V3<T> go = {prm.ct[0][i], prm.ct[1][i], prm.ct[2][i]};
  const V3<T> gd = {prm.ct[3][i], prm.ct[4][i], prm.ct[5][i]};
  T g_time = prm.ct[6][i];
  const V3<T> g_rad = {prm.ct[7][i], prm.ct[8][i], prm.ct[9][i]};
  const V3<T> gtp = {prm.ct[10][i], prm.ct[11][i], prm.ct[12][i]};

  // --- forward replay: regeneration and the closest hit --------------
  if (fresh) {
    camera_ray<T>(pk, s, item, prm.px[i], prm.py[i], o, d, time);
    tp = {T(1), T(1), T(1)};
  }
  T best_t;
  int kind;
  HitExtra<T> ex;
  const int b = closest_hit<T>(pk, s, item, depth, alive, o, d, time,
                               prm.t_min, prm.t_max, best_t, kind, ex, tl);
  const bool hit = b >= 0;
  const bool sph = kSpheres && hit && kind == kSphere;
  const bool bez = kBeziers && hit && kind == kBezier;
  const bool kl = kKleins && hit && kind == kKlein;
  const T t_eff = hit ? best_t : T(0);
  const V3<T> p = ray_at(o, t_eff, d);
  // the winner's normal; a sphere's probe is replayed for the adjoint
  SphereHit<T> sh;
  T rr = T(1);
  V3<T> wn = {T(0), T(1), T(0)};
  if (sph) {
    sphere_probe<T>(pk, s, b, o, d, time, prm.t_min, prm.t_max, sh);
    rr = ld(pk, b + S_R);
    wn = sphere_normal(p, sh.c, rr);
  } else if (hit && kind == kRect) {
    wn = ld3(pk, b + R_WN);
  } else if (bez) {
    wn = {-d.x, -d.y, -d.z};                    // a ribbon's: -ray dir
  } else if (kl) {
    wn = klein_normal<T>(pk, b, p);             // a klein's: unit(grad DE)
  } else if (hit) {
    wn = {T(1), T(0), T(0)};                    // a medium's
  }
  const int mat = b + mat_offset(kind);
  // the winner's texture kind: noise, marble and image albedos are not pk
  // slots, and their cotangent goes elsewhere (below)
  const T texk = hit ? ld(pk, mat + kTexk) : T(0);
  const bool noise = kPerlin && texk == T(TEX_NOISE);
  const bool marble = kPerlin && texk == T(TEX_MARBLE);
  const bool image = kImage && texk == T(TEX_IMAGE);

  // --- the scatter and its adjoint (material.scm), then the selects ----
  // rad' = rad + sky + emission, so rad's cotangent passes through.
  V3<T> g_o = {T(0), T(0), T(0)}, g_d = {T(0), T(0), T(0)};
  V3<T> g_p = {T(0), T(0), T(0)}, g_tp = {T(0), T(0), T(0)};
  V3<T> g_wn = {T(0), T(0), T(0)};            // the normal's cotangent
  bool scattering = false;
  if (alive && hit) {
    c.win = b;
    const T mtype = ld(pk, mat);
    c.odd = checker_odd<T>(pk, mat, p);
    const V3<T> alb = albedo<T>(pk, prm.atlas, s, mat, kind, b, o, d, best_t,
                                p, wn, rr);
    // emission (material.scm:103-111)
    if (mtype == T(MAT_DIFFUSE_LIGHT) && dot(wn, d) < T(0)) {
      g_tp = add(g_tp, mul(g_rad, alb));
      c.alb = add(c.alb, mul(g_rad, tp));
    }
    if (depth < s.max_depth) {
      T u[8];
      if (mtype == T(MAT_LAMBERTIAN)) {
        uniforms4<T>(s.seed, item, uint32_t(depth), 0u, u);
        if (s.light_sampling) {
          uniforms4<T>(s.seed, item, uint32_t(depth), 1u, u + 4);
          const bool use_light = u[2] < T(0.5);
          const V3<T> dir =
              use_light
                  ? lights_sample<T>(pk, s, u[3], u[4], u[5], u[6], u[7], p)
                  : cosine_dir<T>(u[0], u[1], wn);
          const T cw = dot(wn, dir);
          const T cv = (cw < T(0) ? T(0) : cw) * T(1.0 / kPi);
          const T pdf = T(0.5) * cv + T(0.5) * lights_value<T>(pk, s, p, dir);
          const T den = pdf < lo ? lo : pdf;
          const T ratio = cv / den;
          if (pdf > T(0)) {
            scattering = true;                // tp' = tp * alb * ratio
            const V3<T> g_mult = mul(gtp, tp);
            g_tp = add(g_tp, mul(gtp, scale(alb, ratio)));
            c.alb = add(c.alb, scale(g_mult, ratio));
            const T g_ratio = dot(g_mult, alb);
            const T g_pdf = max_adj(pdf, lo, -g_ratio * cv / (den * den));
            const T g_cv = g_ratio / den + T(0.5) * g_pdf;
            const T g_c = max_adj(cw, T(0), g_cv * T(1.0 / kPi));
            g_p = go;
            V3<T> g_dir = add(gd, scale(wn, g_c));
            g_wn = add(g_wn, scale(dir, g_c));
            c.lam_ls = true;
            c.lp = p;
            c.ldir = dir;
            c.g_lv = T(0.5) * g_pdf * T(1.0 / double(s.n_lights));
            T gl[LGT_SIZE];                   // the reduction redoes these
#pragma unroll
            for (int k = 0; k < LGT_SIZE; ++k) gl[k] = T(0);
            for (int l = 0; l < s.n_lights; ++l)
              light_value_adj<T>(pk, s.lgt_base + l * LGT_SIZE, p, dir,
                                 c.g_lv, g_p, g_dir, gl);
            if (use_light) {
              c.l_pick = pick_light(s, u[3]);
              c.lu[0] = u[4]; c.lu[1] = u[5]; c.lu[2] = u[6]; c.lu[3] = u[7];
              c.g_ls = g_dir;
              light_sample_adj<T>(pk, s.lgt_base + c.l_pick * LGT_SIZE, u[4],
                                  u[5], u[6], u[7], p, g_dir, g_p, gl);
            } else {
              g_wn = add(g_wn, cosine_dir_adj<T>(u[0], u[1], wn, g_dir));
            }
          }
        } else {
          scattering = true;                  // tp' = tp * alb
          g_tp = add(g_tp, mul(gtp, alb));
          c.alb = add(c.alb, mul(gtp, tp));
          g_p = go;
          g_wn = add(g_wn, cosine_dir_adj<T>(u[0], u[1], wn, gd));
        }
      } else if (mtype == T(MAT_METAL)) {
        uniforms4<T>(s.seed, item, uint32_t(depth), 2u, u);
        const V3<T> ball = fuzz_ball<T>(u);
        const T fuzz = ld(pk, mat + kFuzz);
        const V3<T> fuzzed =
            add(sub(d, scale(wn, T(2) * dot(d, wn))), scale(ball, fuzz));
        if (dot(fuzzed, wn) > T(0)) {
          scattering = true;                  // tp' = tp * alb
          g_tp = add(g_tp, mul(gtp, alb));
          c.alb = add(c.alb, mul(gtp, tp));
          g_p = go;
          const V3<T> g_f = unit_adj(fuzzed, gd);
          c.fuzz = dot(g_f, ball);
          reflect_adj(d, wn, g_f, g_d, g_wn);
        }
      } else if (mtype == T(MAT_DIELECTRIC)) {
        uniforms4<T>(s.seed, item, uint32_t(depth), 2u, u);
        scattering = true;                    // tp' = tp
        g_tp = add(g_tp, gtp);
        g_p = go;
        const T ref_idx = ld(pk, mat + kRef);
        const T dd = dot(d, wn);
        const bool exiting = dd > T(0);
        const V3<T> own = exiting ? scale(wn, T(-1)) : wn;
        const T q = ref_idx == T(0) ? T(1) : ref_idx;
        const T ni = exiting ? ref_idx : T(1) / q;
        const T cosine = exiting ? dd * ref_idx : -dd;
        const T dtn = dot(d, own);
        const T disc = T(1) - ni * ni * (T(1) - dtn * dtn);
        const bool refr_ok = disc > T(0);
        const T safe = Math<T>::sqrt(refr_ok ? disc : T(1));
        const V3<T> refr =
            sub(scale(sub(d, scale(own, dtn)), ni), scale(own, safe));
        const V3<T> refl = sub(d, scale(wn, T(2) * dot(d, wn)));
        if (u[0] < schlick_prob<T>(ref_idx, cosine, refr_ok)) {
          reflect_adj(d, wn, unit_adj(refl, gd), g_d, g_wn);
        } else {
          // refr = ni (d - own dtn) - own safe
          const V3<T> g_r = unit_adj(refr, gd);
          T g_ni = dot(g_r, sub(d, scale(own, dtn)));
          T g_dtn = -ni * dot(g_r, own);
          V3<T> g_own = scale(g_r, -(ni * dtn) - safe);
          g_d = add(g_d, scale(g_r, ni));
          const T g_safe = -dot(g_r, own);
          const T g_disc = refr_ok ? T(0.5) * g_safe / safe : T(0);
          g_ni += g_disc * (T(-2) * ni * (T(1) - dtn * dtn));
          g_dtn += g_disc * (T(2) * ni * ni * dtn);
          g_d = add(g_d, scale(own, g_dtn));       // dtn = d . own
          g_own = add(g_own, scale(d, g_dtn));
          g_wn = exiting ? sub(g_wn, g_own) : add(g_wn, g_own);
          if (exiting) {
            c.ref += g_ni;
          } else if (ref_idx != T(0)) {
            c.ref += -g_ni / (q * q);
          }
        }
      }
    }
  }
  if (!scattering) {                          // o', d', tp' pass through
    g_o = go;
    g_d = add(g_d, gd);
    g_tp = add(g_tp, gtp);
  }

  // --- the albedo of a noise, marble or image texture -------------------
  // (c.alb is the albedo's cotangent here; for these kinds it leaves ALB0)
  if (alive && hit && (noise || marble)) {
    const T g_gray = c.alb.x + c.alb.y + c.alb.z;
    c.alb = {T(0), T(0), T(0)};
    const T ts = ld(pk, mat + kTexs);
    V3<T> g;
    if (noise) {                              // gray = noise(p ts)
      perlin_noise<T, true>(s.perlin_seed, p.x * ts, p.y * ts, p.z * ts, g);
      g_p = add(g_p, scale(g, ts * g_gray));
      c.texs = dot(g, p) * g_gray;
    } else {                // gray = 0.5 (1 + sin(ts p.z + 10 turb(p)))
      const T arg =
          ts * p.z + T(10) * perlin_turb<T, true>(s.perlin_seed, p, g);
      const T g_arg = T(0.5) * Math<T>::cos(arg) * g_gray;
      g_p = add(g_p, scale(g, T(10) * g_arg));
      g_p.z += ts * g_arg;
      c.texs = p.z * g_arg;
    }
  }
  if (alive && hit && image) {
    T u, v;
    surface_uv<T>(pk, kind, b, o, d, best_t, wn, rr, u, v);
    texel_index<T>(pk, s, mat, u, v, c.tex);
    c.g_tex = c.alb;
    c.alb = {T(0), T(0), T(0)};
  }

  // --- sky on a miss (main.scm:91-98) ---------------------------------
  if (alive && !hit) {
    c.sky = true;
    const T sky_t = T(0.5) * (d.y + T(1));
    const V3<T> sa = ld3(pk, H_SKY_A), sb = ld3(pk, H_SKY_B);
    const V3<T> sky = {(T(1) - sky_t) * sa.x + sky_t * sb.x,
                       (T(1) - sky_t) * sa.y + sky_t * sb.y,
                       (T(1) - sky_t) * sa.z + sky_t * sb.z};
    g_tp = add(g_tp, mul(g_rad, sky));
    const V3<T> g_sky = mul(g_rad, tp);
    c.hdr[H_SKY_A] = g_sky.x * (T(1) - sky_t);
    c.hdr[H_SKY_A + 1] = g_sky.y * (T(1) - sky_t);
    c.hdr[H_SKY_A + 2] = g_sky.z * (T(1) - sky_t);
    c.hdr[H_SKY_B] = g_sky.x * sky_t;
    c.hdr[H_SKY_B + 1] = g_sky.y * sky_t;
    c.hdr[H_SKY_B + 2] = g_sky.z * sky_t;
    g_d.y += T(0.5) * dot(g_sky, sub(sb, sa));
  }

  // --- a sphere's normal wn = (p - c) / r: back into p, c and r ---------
  // (a dead lane's g_p and g_wn are zero: it scatters nothing)
  V3<T> g_c = {T(0), T(0), T(0)};
  T g_r = T(0);
  if (alive && sph) {
    const T inv_r = T(1) / rr;
    const V3<T> g_pc = scale(g_wn, inv_r);
    g_p = add(g_p, g_pc);
    g_c = scale(g_pc, T(-1));
    g_r = -dot(g_wn, sub(p, sh.c)) * inv_r * inv_r;
  }

  // --- hit point p = o + t d --------------------------------------------
  g_o = add(g_o, g_p);
  if (alive && hit) {
    g_d = add(g_d, scale(g_p, t_eff));
    const T g_t = dot(g_p, d);
    if (sph) {
      // t = -bq -/+ sq, sq = sqrt(disc), disc = bq bq - cq,
      // cq = oc.oc - r r, bq = oc.d, oc = o - c (geometry.scm:149-153)
      const T g_sq = sh.near ? -g_t : g_t;
      const T g_disc = T(0.5) * g_sq / sh.sq;
      const T g_bq = T(2) * sh.bq * g_disc - g_t;
      const V3<T> g_oc =
          add(scale(sh.oc, T(-2) * g_disc), scale(d, g_bq));
      g_r += T(2) * rr * g_disc;
      g_d = add(g_d, scale(sh.oc, g_bq));
      g_o = add(g_o, g_oc);
      g_c = sub(g_c, g_oc);
      c.k = g_r;
      if (kMoving && s.has_moving) {
        // c = c0 + frac (c1 - c0), frac = (time - t0) / sp, sp = span or 1
        const V3<T> dc = sub(ld3(pk, b + S_C1), ld3(pk, b + S_C0));
        c.wn = scale(g_c, T(1) - sh.frac);
        c.c1 = scale(g_c, sh.frac);
        const T g_num = dot(g_c, dc) / sh.sp;
        g_time += g_num;
        c.st0 = -g_num;
        if (ld(pk, b + S_T1) - ld(pk, b + S_T0) != T(0)) {
          const T g_sp = -g_num * sh.frac;
          c.st1 = g_sp;
          c.st0 -= g_sp;
        }
      } else {
        c.wn = g_c;
      }
    } else if (kMedia && kind == kMedium) {
      // t = t1 + nid log(xi); its slots are redone in the block reduction
      c.med = true;
      c.mo = o;
      c.md = d;
      c.m_lx = ex.med.lx;
      c.m_gt = g_t;
      T gm[kMedSlots];
#pragma unroll
      for (int k = 0; k < kMedSlots; ++k) gm[k] = T(0);
      medium_adj<T>(pk, b, o, d, prm.t_min, prm.t_max, ex.med.lx, g_t, g_o,
                    g_d, gm);
    } else if (kl) {
      // t = t_raw - corr, wn = unit(g) at p = o + t_raw d: into o, d and the
      // centre (the entry's geometry vector)
      V3<T> g_c = {T(0), T(0), T(0)};
      klein_adj<T>(pk, b, o, d, best_t, g_t, g_wn, g_o, g_d, g_c);
      c.wn = g_c;
    } else if (bez) {
      // the normal -d; t = zc(s) at the root of g'.  The control points'
      // slots are redone in the block reduction
      g_d = sub(g_d, g_wn);
      c.bez = true;
      c.mo = o;
      c.md = d;
      c.m_gt = g_t;
      c.bh = ex.bez;
      T gb[kBezSlots];
#pragma unroll
      for (int k = 0; k < kBezSlots; ++k) gb[k] = T(0);
      bezier_adj<T>(pk, s, b, o, d, prm.t_min, prm.t_max, ex.bez, g_t, g_o,
                    g_d, gb, tl);
    } else {
      // t = (K - o.wn) / (d.wn); the normal is a pk leaf
      const T dn = dot(d, wn);
      const T g_num = g_t / dn;
      const T g_dn = -g_t * best_t / dn;
      c.k = g_num;
      g_o = sub(g_o, scale(wn, g_num));
      g_d = add(g_d, scale(wn, g_dn));
      c.wn = add(g_wn, add(scale(o, -g_num), scale(d, g_dn)));
    }
  }

  // --- regeneration: a fresh lane's cotangents go to the camera --------
  if (fresh) {
    c.cam = true;
    T u[8];
    uniforms4<T>(s.seed, item, CAMERA_DEPTH, 0u, u);
    uniforms4<T>(s.seed, item, CAMERA_DEPTH, 1u, u + 4);
    const T sx = (prm.px[i] + u[0]) * T(1.0 / double(s.nx));
    const T ty = (prm.py[i] + u[1]) * T(1.0 / double(s.ny));
    const T r = Math<T>::sqrt(u[2]);
    const T phi = T(kTwoPi) * u[3];
    const T lens = ld(pk, H_LENS_R);
    const T rdx = lens * r * Math<T>::cos(phi);
    const T rdy = lens * r * Math<T>::sin(phi);
    const V3<T> cu = ld3(pk, H_CAM_U), cv = ld3(pk, H_CAM_VV);
    const V3<T> off = add(scale(cu, rdx), scale(cv, rdy));
    const V3<T> org = ld3(pk, H_CAM_O);
    const V3<T> ll = ld3(pk, H_CAM_LL), hor = ld3(pk, H_CAM_H),
                ver = ld3(pk, H_CAM_V);
    const V3<T> dv = {ll.x + sx * hor.x + ty * ver.x - org.x - off.x,
                      ll.y + sx * hor.y + ty * ver.y - org.y - off.y,
                      ll.z + sx * hor.z + ty * ver.z - org.z - off.z};
    const V3<T> g_dv = unit_adj(dv, g_d);
    const V3<T> g_org = sub(g_o, g_dv);               // o = org + off
    const V3<T> g_off = sub(g_o, g_dv);
    const T g_rdx = dot(g_off, cu), g_rdy = dot(g_off, cv);
    const V3<T> gs[6] = {g_org, g_dv, scale(g_dv, sx), scale(g_dv, ty),
                         scale(g_off, rdx), scale(g_off, rdy)};
#pragma unroll
    for (int k = 0; k < 6; ++k) {       // H_CAM_O .. H_CAM_VV, 3 apart
      c.hdr[H_CAM_O + 3 * k] = gs[k].x;
      c.hdr[H_CAM_O + 3 * k + 1] = gs[k].y;
      c.hdr[H_CAM_O + 3 * k + 2] = gs[k].z;
    }
    c.hdr[H_LENS_R] = g_rdx * (r * Math<T>::cos(phi)) +
                      g_rdy * (r * Math<T>::sin(phi));
    c.hdr[H_T0] = g_time;
    c.hdr[H_DT] = g_time * u[4];
    g_o = g_d = g_tp = V3<T>{T(0), T(0), T(0)};
  }

  if (tl.r != 0) return;
  const bool keep = !fresh;
  prm.out[0][i] = g_o.x;  prm.out[1][i] = g_o.y;  prm.out[2][i] = g_o.z;
  prm.out[3][i] = g_d.x;  prm.out[4][i] = g_d.y;  prm.out[5][i] = g_d.z;
  prm.out[6][i] = keep ? g_time : T(0);
  prm.out[7][i] = keep ? g_rad.x : T(0);
  prm.out[8][i] = keep ? g_rad.y : T(0);
  prm.out[9][i] = keep ? g_rad.z : T(0);
  prm.out[10][i] = g_tp.x;  prm.out[11][i] = g_tp.y;  prm.out[12][i] = g_tp.z;
}

// The pk slots a winner's cotangent touches, in the order of its list entry:
// the geometry vector (R_WN, a sphere's S_C0, a klein's K_C), the geometry
// scalar (R_K, S_R; a klein has none), ALB0, ALB1, FUZZ, REF, TEXS, and for a
// sphere of a moving scene S_C1, S_T0 and S_T1.  A rect, or a sphere of a
// static scene, uses the first kRectSlots, a klein all of them but the
// geometry scalar; a medium or a ribbon the material slots among them, from
// kGeomSlots on (their geometry slots are redone per medium and per ribbon,
// see medium_adj and bezier_adj).  A variant without moving spheres keeps
// the first kRectSlots only.
constexpr int kAllSlots = 18;
constexpr int kRectSlots = 13;
constexpr int kGeomSlots = 4;
constexpr int kSlots = kMoving ? kAllSlots : kRectSlots;

// The per-warp sums of one medium's or one ribbon's geometry slots share an
// array.
static_assert(kBezSlots <= kMedSlots, "a ribbon's slots fit a medium's array");

// The kind of the winner at pk offset b (pack order: rects, spheres,
// lights, media, kleins, ribbons).
__device__ __forceinline__ int win_kind(const Statics& s, int b) {
  if (kBeziers && b >= s.bez_base) return kBezier;
  if (kKleins && b >= s.kl_base) return kKlein;
  if (kMedia && b >= s.med_base) return kMedium;
  return kSpheres && b >= s.sph_base ? kSphere : kRect;
}

// True for the winners whose list entry carries material slots only.
__device__ __forceinline__ bool material_only(int kind) {
  return kind == kMedium || kind == kBezier;
}

// Entry slot j of a winner of `kind` -> its offset in the winner's pk block.
__device__ __forceinline__ int win_slot(int kind, int j) {
  const bool sph = kind == kSphere;
  if (j < 3) return (sph ? S_C0 : (kind == kKlein ? K_C : R_WN)) + j;
  if (j == 3) return sph ? S_R : R_K;
  if (j < kRectSlots) {
    const int mat = mat_offset(kind);
    if (j < 7) return mat + kAlb0 + (j - 4);
    if (j < 10) return mat + kAlb1 + (j - 7);
    return mat + (j == 10 ? kFuzz : (j == 11 ? kRef : kTexs));
  }
  if (j < 16) return S_C1 + (j - 13);
  return j == 16 ? S_T0 : S_T1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bounce_step_bwd_kernel(const BwdParams<T> prm) {
  __shared__ T s_hdr[kWarps][HDR_SIZE];        // warp sums of the header
  __shared__ T s_lgt[kWarps][LGT_SIZE];        // and of one light's slots
  // and of one medium's or one ribbon's geometry slots
  __shared__ T s_med[kMedia || kBeziers ? kWarps : 1][kMedSlots];
  __shared__ T s_val[kWarps][32][kSlots];      // each warp's winner list,
  __shared__ int s_win[kWarps][32];            // and then its texel list
  // a texel's channels 1 and 2
  __shared__ int s_tix[kImage ? kWarps : 1][32][2];
  __shared__ int s_n[kWarps];
  const Statics& s = prm.s;
  const T* __restrict__ pk = prm.pk;
  const int P = prm.P;
  const int A = kImage ? s.img_rows * 128 : 0;   // the atlas's texels
  T* part = prm.dpk_part + size_t(blockIdx.x) * (P + A);   // this block's row
  for (int k = threadIdx.x; k < P + A; k += kThreads) part[k] = T(0);

  // w threads a lane; only the tile's first thread keeps its lane's pk
  // cotangent, so every lane enters the reductions once
  const int i = (blockIdx.x * kThreads + threadIdx.x) / prm.w;
  const Tile tl = lane_tile(prm.w);
  LaneGrads<T> c = {};
  c.win = c.l_pick = c.tex[0] = -1;
  if (i < s.m) lane_adjoint(prm, i, c, tl);
  if (tl.r != 0) {
    c = LaneGrads<T>{};
    c.win = c.l_pick = c.tex[0] = -1;
  }

  // --- warp sums: the header, then one list entry per distinct winner ----
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (__any_sync(kFullMask, c.cam || c.sky)) {
#pragma unroll
    for (int k = 0; k < HDR_SIZE; ++k) {
      const T v = warp_sum(c.hdr[k]);
      if (lane == 0) s_hdr[warp][k] = v;
    }
  } else if (lane < HDR_SIZE) {
    s_hdr[warp][lane] = T(0);
  }
  int n = 0;
  unsigned todo = __ballot_sync(kFullMask, c.win >= 0);
  while (todo) {                       // winners in order of their first lane
    const int b = __shfl_sync(kFullMask, c.win, __ffs(todo) - 1);
    const bool mine = c.win == b;
    todo &= ~__ballot_sync(kFullMask, mine);
    const bool moving = kMoving && win_kind(s, b) == kSphere && s.has_moving;
    const T z = T(0);
    const V3<T> a0 = mine && !c.odd ? c.alb : V3<T>{z, z, z};
    const V3<T> a1 = mine && c.odd ? c.alb : V3<T>{z, z, z};
    const T vals[kAllSlots] = {
        mine ? c.wn.x : z, mine ? c.wn.y : z, mine ? c.wn.z : z,
        mine ? c.k : z, a0.x, a0.y, a0.z, a1.x, a1.y, a1.z,
        mine ? c.fuzz : z, mine ? c.ref : z, mine ? c.texs : z,
        mine ? c.c1.x : z, mine ? c.c1.y : z, mine ? c.c1.z : z,
        mine ? c.st0 : z, mine ? c.st1 : z};
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (j < kRectSlots || moving) {
        const T v = warp_sum(vals[j]);
        if (lane == 0) s_val[warp][n][j] = v;
      }
    }
    if (lane == 0) s_win[warp][n] = b;
    ++n;
  }
  if (lane == 0) s_n[warp] = n;
  __syncthreads();                     // the row is zeroed, the lists stand

  // --- this block's row of the partials: the warps added in order -------
  if (threadIdx.x < HDR_SIZE) {
    T acc = s_hdr[0][threadIdx.x];
    for (int w = 1; w < kWarps; ++w) acc += s_hdr[w][threadIdx.x];
    part[threadIdx.x] = acc;
  }
  for (int w = 0; w < kWarps; ++w) {   // one list's winners are distinct
    for (int e = threadIdx.x; e < s_n[w] * kSlots; e += kThreads) {
      const int b = s_win[w][e / kSlots], j = e % kSlots;
      const int kind = win_kind(s, b);
      if (material_only(kind) ? (j >= kGeomSlots && j < kRectSlots)
          : kind == kKlein    ? (j != kGeomSlots - 1 && j < kRectSlots)
                              : (j < kRectSlots ||
                                 (kind == kSphere && s.has_moving)))
        part[b + win_slot(kind, j)] += s_val[w][e / kSlots][j];
    }
    __syncthreads();
  }

  // --- the atlas's texels: a list of distinct texels per warp, as above ---
  if (kImage && A > 0 && __syncthreads_or(c.tex[0] >= 0)) {
    n = 0;
    todo = __ballot_sync(kFullMask, c.tex[0] >= 0);
    while (todo) {                     // texels in order of their first lane
      const int first = __ffs(todo) - 1;
      const int key = __shfl_sync(kFullMask, c.tex[0], first);
      const bool mine = c.tex[0] == key;
      todo &= ~__ballot_sync(kFullMask, mine);
      const T z = T(0);
      const T vals[3] = {mine ? c.g_tex.x : z, mine ? c.g_tex.y : z,
                         mine ? c.g_tex.z : z};
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const T v = warp_sum(vals[ch]);
        if (lane == 0) s_val[warp][n][ch] = v;
      }
      if (lane == first) {
        s_win[warp][n] = key;
        s_tix[warp][n][0] = c.tex[1];
        s_tix[warp][n][1] = c.tex[2];
      }
      ++n;
    }
    if (lane == 0) s_n[warp] = n;
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) { // one list's texels are distinct
      for (int e = threadIdx.x; e < s_n[w] * 3; e += kThreads) {
        const int q = e / 3, ch = e % 3;
        part[P + (ch == 0 ? s_win[w][q] : s_tix[w][q][ch - 1])] +=
            s_val[w][q][ch];
      }
      __syncthreads();
    }
  }

  // --- the media's geometry slots, one medium at a time -------------------
  if (kMedia && s.n_media > 0 && __syncthreads_or(c.med)) {
    for (int mi = 0; mi < s.n_media; ++mi) {
      const int b = s.med_base + mi * MED_SIZE;
      const bool mine = c.med && c.win == b;
      if (__any_sync(kFullMask, mine)) {
        T gm[kMedSlots];
#pragma unroll
        for (int k = 0; k < kMedSlots; ++k) gm[k] = T(0);
        V3<T> scratch_o = {T(0), T(0), T(0)}, scratch_d = scratch_o;
        if (mine)
          medium_adj<T>(pk, b, c.mo, c.md, prm.t_min, prm.t_max, c.m_lx,
                        c.m_gt, scratch_o, scratch_d, gm);
#pragma unroll
        for (int k = 0; k < kMedSlots; ++k) {
          const T v = warp_sum(gm[k]);
          if (lane == 0) s_med[warp][k] = v;
        }
      } else if (lane < kMedSlots) {
        s_med[warp][lane] = T(0);
      }
      __syncthreads();
      if (threadIdx.x < kMedSlots) {
        T acc = s_med[0][threadIdx.x];
        for (int w = 1; w < kWarps; ++w) acc += s_med[w][threadIdx.x];
        part[b + M_AX + threadIdx.x] = acc;
      }
      __syncthreads();
    }
  }

  // --- the ribbons' control points, one ribbon at a time ------------------
  if (kBeziers && s.n_beziers > 0 && __syncthreads_or(c.bez)) {
    for (int j = 0; j < s.n_beziers; ++j) {
      const int b = s.bez_base + j * BEZ_SIZE;
      const bool mine = c.bez && c.win == b;
      if (__any_sync(kFullMask, mine)) {
        T gb[kBezSlots];
#pragma unroll
        for (int k = 0; k < kBezSlots; ++k) gb[k] = T(0);
        V3<T> scratch_o = {T(0), T(0), T(0)}, scratch_d = scratch_o;
        if (mine)
          bezier_adj<T>(pk, s, b, c.mo, c.md, prm.t_min, prm.t_max, c.bh,
                        c.m_gt, scratch_o, scratch_d, gb, one_thread());
#pragma unroll
        for (int k = 0; k < kBezSlots; ++k) {
          const T v = warp_sum(gb[k]);
          if (lane == 0) s_med[warp][k] = v;
        }
      } else if (lane < kBezSlots) {
        s_med[warp][lane] = T(0);
      }
      __syncthreads();
      if (threadIdx.x < kBezSlots) {
        T acc = s_med[0][threadIdx.x];
        for (int w = 1; w < kWarps; ++w) acc += s_med[w][threadIdx.x];
        part[b + B_CP + threadIdx.x] = acc;
      }
      __syncthreads();
    }
  }

  // --- the light slots, one light at a time ------------------------------
  if (!__syncthreads_or(c.lam_ls)) return;
  for (int l = 0; l < s.n_lights; ++l) {
    const int b = s.lgt_base + l * LGT_SIZE;
    if (__any_sync(kFullMask, c.lam_ls)) {
      T gl[LGT_SIZE];
#pragma unroll
      for (int k = 0; k < LGT_SIZE; ++k) gl[k] = T(0);
      V3<T> scratch_p = {T(0), T(0), T(0)}, scratch_d = scratch_p;
      if (c.lam_ls)
        light_value_adj<T>(pk, b, c.lp, c.ldir, c.g_lv, scratch_p, scratch_d,
                           gl);
      if (l == c.l_pick)
        light_sample_adj<T>(pk, b, c.lu[0], c.lu[1], c.lu[2], c.lu[3], c.lp,
                            c.g_ls, scratch_p, gl);
#pragma unroll
      for (int k = L_X0; k <= L_RAD; ++k) {     // L_KIND is compared only
        const T v = warp_sum(gl[k]);
        if (lane == 0) s_lgt[warp][k] = v;
      }
    } else if (lane < LGT_SIZE) {
      s_lgt[warp][lane] = T(0);
    }
    __syncthreads();
    if (threadIdx.x >= L_X0 && threadIdx.x <= L_RAD) {
      T acc = s_lgt[0][threadIdx.x];
      for (int w = 1; w < kWarps; ++w) acc += s_lgt[w][threadIdx.x];
      part[b + threadIdx.x] = acc;
    }
    __syncthreads();
  }
}

template <typename T>
int launch_bwd(void* const* ptrs, const Statics& s, int P, int w,
               double t_min, double t_max, cudaStream_t stream) {
  BwdParams<T> prm;
  prm.pk = static_cast<const T*>(ptrs[0]);
  prm.gitem = static_cast<const int32_t*>(ptrs[1]);
  prm.px = static_cast<const T*>(ptrs[2]);
  prm.py = static_cast<const T*>(ptrs[3]);
  prm.fresh = static_cast<const bool*>(ptrs[4]);
  prm.alive = static_cast<const bool*>(ptrs[5]);
  prm.depth = static_cast<const int32_t*>(ptrs[6]);
  for (int k = 0; k < 13; ++k) prm.in[k] = static_cast<const T*>(ptrs[7 + k]);
  for (int k = 0; k < 13; ++k) prm.ct[k] = static_cast<const T*>(ptrs[20 + k]);
  prm.dpk_part = static_cast<T*>(ptrs[33]);
  for (int k = 0; k < 13; ++k) prm.out[k] = static_cast<T*>(ptrs[34 + k]);
  prm.atlas = static_cast<const T*>(ptrs[47]);
  prm.s = s;
  prm.P = P;
  prm.w = w;
  prm.t_min = T(t_min);
  prm.t_max = T(t_max);
  bounce_step_bwd_kernel<T><<<lane_blocks(s.m, w), kThreads, 0, stream>>>(
      prm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes by integrator/bounce.py:step_cuda_bwd.
// ptrs: 48 device pointers — pk; gitem px py fresh alive depth and the 13
// float lane columns (the step's inputs); the 13 cotangents of its float
// outputs; the (lane_blocks(m, w), P + img_rows * 128) partials of the pk and
// atlas cotangents, one row a block; the 13 lane cotangents (outputs); the
// image texel atlas (null when img_rows is 0).  w: threads a lane, a power of
// two from 1 to kMaxTile (bounce.py tile_width).  Launches on `stream`
// without synchronising and returns the CUDA error (0 = launched;
// cudaErrorInvalidValue for a plan that this variant's feature set does not
// cover or a w it does not take).
extern "C" int srt_bounce_step_bwd(int is_f64, void* const* ptrs, int m,
                                   int P, int w, SRT_SCENE_PARAMS,
                                   void* stream) {
  if (m <= 0) return 0;
  const Statics s = SRT_STATICS(m);
  if (!features_cover(s) || !tile_width_ok(w))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch_bwd<double>(ptrs, s, P, w, t_min, t_max, st)
                : launch_bwd<float>(ptrs, s, P, w, t_min, t_max, st);
}
