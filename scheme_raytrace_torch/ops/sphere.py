"""Batched ray x sphere intersection sweep (geometry.scm:146-215).

The port of scheme_raytrace_tpu/ops/sphere.py.  Static and moving spheres
share one parameter layout (centre lerped by ray time,
geometry.scm:188-193); a negative radius keeps the reference's
hollow-dielectric normal flip.  UV is the canonical Shirley form on the
outward unit normal (bug B1 fixed).

Below LOOP_MAX spheres the sweep is a Python loop of [N]-shaped ops, above
it one [N, S] masked sweep, as in JAX (the split is the JAX package's TPU
value; re-sweeping it on the card is queued).  `intersect_bvh` walks the
flat threaded BVH (ops/traverse.py).
"""

from __future__ import annotations

import math

import torch

from ..core import vecmath as vm

_PI = math.pi

# Below this sphere count the sweep unrolls to a per-sphere loop (the JAX
# package's TPU split, kept so both packages take the same branch).
LOOP_MAX = 48


def sphere_uv(n_unit):
    """Canonical Shirley sphere UV from the outward unit normal (B1 fixed)."""
    y = n_unit[..., 1]
    phi = torch.atan2(n_unit[..., 2], n_unit[..., 0])
    theta = torch.atan2(y, torch.sqrt(vm.maximum(1.0 - y * y, 1e-12)))
    u = 1.0 - (phi + _PI) / (2.0 * _PI)
    v = (theta + _PI / 2.0) / _PI
    return u, v


def intersect(o, d, time, scene, t_min, t_max):
    """Closest valid sphere hit per ray.

    o, d: [N,3] (d unit); time: [N]; returns
    (hit [N] bool, t [N], normal [N,3], mat [N] i32, u [N], v [N]).
    """
    if scene.sph_r.shape[0] <= LOOP_MAX:
        return _intersect_loop(o, d, time, scene, t_min, t_max)
    return _intersect_sweep(o, d, time, scene, t_min, t_max)


def _quadratic(oc, d, r, ok_mask=None):
    """Nearest root in (t_min, t_max) of |oc + t d| = |r| per lane (inf
    where none); oc / d broadcast, ok_mask gates the discriminant."""
    b = vm.dot(oc, d)
    cq = vm.sq_len(oc) - r * r
    disc = b * b - cq
    ok = disc > 0.0
    if ok_mask is not None:
        ok = ok_mask & ok
    sq = torch.sqrt(torch.where(ok, disc, 1.0))      # double-where (grads)
    t0 = -b - sq
    t1 = -b + sq
    return ok, t0, t1


def _finish(o, d, time, scene, hit, best_t, j, t_max):
    """The hit record of winner j: t, normal (p - c)/r, material, uv."""
    tb = torch.where(hit, best_t, t_max)
    cj = _center_at(scene, j, time)
    rj = vm.take(scene.sph_r, j)
    p = o + tb[:, None] * d
    normal = (p - cj) / rj[:, None]                  # sign(r) flips (hollow)
    u, v = sphere_uv(normal * torch.sign(rj)[:, None])
    return hit, tb, normal, scene.sph_mat[j], u, v


def _intersect_loop(o, d, time, scene, t_min, t_max):
    """Unrolled per-sphere running-min merge (geometry.scm:146-215)."""
    n = o.shape[0]
    best_t = torch.full((n,), math.inf, dtype=o.dtype, device=o.device)
    best_j = torch.zeros(n, dtype=torch.int64, device=o.device)
    for s in range(scene.sph_r.shape[0]):
        if scene.has_moving:
            span = scene.sph_t1[s] - scene.sph_t0[s]
            frac = (time - scene.sph_t0[s]) / torch.where(span == 0.0, 1.0,
                                                          span)
            c = scene.sph_c0[s] + frac[:, None] * (scene.sph_c1[s]
                                                   - scene.sph_c0[s])
        else:
            c = scene.sph_c0[s]
        ok, t0, t1 = _quadratic(o - c, d, scene.sph_r[s])
        in0 = ok & (t0 > t_min) & (t0 < t_max)
        in1 = ok & (t1 > t_min) & (t1 < t_max)
        t = torch.where(in0, t0, torch.where(in1, t1, math.inf))
        closer = (t < best_t) & scene.sph_valid[s]
        best_t = torch.where(closer, t, best_t)
        best_j = torch.where(closer, s, best_j)
    return _finish(o, d, time, scene, torch.isfinite(best_t), best_t, best_j,
                   t_max)


def _intersect_sweep(o, d, time, scene, t_min, t_max):
    """[N, S] masked sweep (large scenes).  Keeps the JAX shapes: every
    [N, S, 3] intermediate is materialised."""
    c0, c1 = scene.sph_c0, scene.sph_c1          # [S,3]
    if scene.has_moving:
        # geometry.scm:188-193 — lerp centre by ray time
        span = scene.sph_t1 - scene.sph_t0
        frac = (time[:, None] - scene.sph_t0) / torch.where(span == 0.0, 1.0,
                                                            span)
        c = c0 + frac[..., None] * (c1 - c0)     # [N,S,3]
        oc = o[:, None, :] - c
    else:
        oc = o[:, None, :] - c0[None, :, :]       # [N,S,3]
    # Half-b quadratic (geometry.scm:149-153); a == 1 for unit d.
    ok, t0, t1 = _quadratic(oc, d[:, None, :], scene.sph_r)
    in0 = ok & (t0 > t_min) & (t0 < t_max)
    in1 = ok & (t1 > t_min) & (t1 < t_max)
    t = torch.where(in0, t0, torch.where(in1, t1, math.inf))
    t = torch.where(scene.sph_valid[None, :], t, math.inf)

    tb, j = torch.min(t, dim=1)                   # first minimum, as argmin
    return _finish(o, d, time, scene, torch.isfinite(tb), tb, j, t_max)


def _center_at(scene, j, time):
    """Centre of sphere j [N] at ray time [N] (geometry.scm:188-193)."""
    c0, c1 = vm.take(scene.sph_c0, j), vm.take(scene.sph_c1, j)
    if not scene.has_moving:
        return c0
    t0 = vm.take(scene.sph_t0, j)
    span = vm.take(scene.sph_t1, j) - t0
    frac = (time - t0) / torch.where(span == 0.0, 1.0, span)
    return c0 + frac[:, None] * (c1 - c0)


def _center_at_slots(scene, pj, time):
    """Centres for [N, L] prim slots at ray time [N]."""
    c0, c1 = scene.sph_c0[pj], scene.sph_c1[pj]       # [N,L,3]
    if not scene.has_moving:
        return c0
    span = scene.sph_t1[pj] - scene.sph_t0[pj]
    frac = (time[:, None] - scene.sph_t0[pj]) / torch.where(span == 0.0, 1.0,
                                                            span)
    return c0 + frac[..., None] * (c1 - c0)


def intersect_bvh(o, d, time, scene, t_min, t_max):
    """Closest sphere hit via the flat threaded BVH (scene/bvh.py) of a
    scene of spheres: on such a tree the mixed walk of ops/traverse.py is
    this function of the JAX package, value for value."""
    from . import traverse                      # traverse imports this module
    return traverse.intersect_bvh_mixed(o, d, time, scene, t_min, t_max)
