"""Batched ray x axis-aligned-rect sweep (geometry.scm:376-431) with
per-primitive rigid instancing (translate geometry.scm:465-481, rotate-y
geometry.scm:483-543).

The port of scheme_raytrace_tpu/ops/rect.py: every rect carries an
object->world rotation and translation baked at scene compile, and the
sweep takes each ray into each rect's object space; `flip` (+1/-1) folds
flip-normals and the box min-faces into a sign.  Below LOOP_MAX rects the
sweep is a Python loop of [N]-shaped ops, above it one [N, R] sweep.
"""

from __future__ import annotations

import math

import torch

from ..core import vecmath as vm

# The JAX package's TPU split, kept so both packages take the same branch.
LOOP_MAX = 48


def intersect(o, d, time, scene, t_min, t_max):
    """Closest valid rect hit per ray; see sphere.intersect for the contract."""
    if scene.rect_k.shape[0] <= LOOP_MAX:
        return _intersect_loop(o, d, time, scene, t_min, t_max)
    return _intersect_sweep(o, d, time, scene, t_min, t_max)


def selectors(axis, dtype):
    """One-hot rows of the normal axis and the two in-plane axes (ascending
    index order, Rect's (a0,a1)/(b0,b1) convention) for int axes [...]."""
    eye = torch.eye(3, dtype=dtype, device=axis.device)
    axis = axis.long()
    ia = torch.where(axis == 0, 1, 0)
    ib = torch.where(axis == 2, 1, 2)
    return eye[axis], eye[ia], eye[ib]


def _finish(scene, hit, best_t, j, pa, pb, t_max, dtype):
    """Hit record of winner rect j: world normal R (one-hot(axis) flip),
    material and the in-plane uv."""
    tb = torch.where(hit, best_t, t_max)
    n_sel, _, _ = selectors(scene.rect_axis[j], dtype)
    n_obj = n_sel * vm.take(scene.rect_flip, j)[:, None]
    if scene.has_rect_xform:
        normal = torch.einsum("nij,nj->ni", vm.take(scene.rect_rot, j),
                              n_obj)
    else:
        normal = n_obj
    a0, b0 = vm.take(scene.rect_a0, j), vm.take(scene.rect_b0, j)
    u = (pa - a0) / (vm.take(scene.rect_a1, j) - a0)
    v = (pb - b0) / (vm.take(scene.rect_b1, j) - b0)
    return hit, tb, normal, scene.rect_mat[j], u, v


def _intersect_loop(o, d, time, scene, t_min, t_max):
    """Unrolled per-rect running-min merge: R x [N]-shaped ops."""
    n = o.shape[0]
    dt = o.dtype
    n_sel, a_sel, b_sel = selectors(scene.rect_axis, dt)     # [R,3] each
    best_t = torch.full((n,), math.inf, dtype=dt, device=o.device)
    best_j = torch.zeros(n, dtype=torch.int64, device=o.device)
    best_pa = torch.zeros(n, dtype=dt, device=o.device)
    best_pb = torch.zeros(n, dtype=dt, device=o.device)
    for r in range(scene.rect_k.shape[0]):
        if scene.has_rect_xform:
            o_l = (o - scene.rect_trans[r]) @ scene.rect_rot[r]   # R^T x
            d_l = d @ scene.rect_rot[r]
        else:
            o_l, d_l = o, d
        dn = d_l @ n_sel[r]
        # guard: rays exactly parallel to the plane (dn == 0) would put
        # 0/0 = NaN into the where-VJP even though the lane is masked
        dn_ok = dn != 0.0
        dn = torch.where(dn_ok, dn, 1.0)
        t = (scene.rect_k[r] - o_l @ n_sel[r]) / dn    # geometry.scm:378-379
        pa = o_l @ a_sel[r] + t * (d_l @ a_sel[r])
        pb = o_l @ b_sel[r] + t * (d_l @ b_sel[r])
        ok = (dn_ok & (t >= t_min) & (t <= t_max) & scene.rect_valid[r]
              & (pa >= scene.rect_a0[r]) & (pa <= scene.rect_a1[r])
              & (pb >= scene.rect_b0[r]) & (pb <= scene.rect_b1[r])
              & (t < best_t))
        best_t = torch.where(ok, t, best_t)
        best_j = torch.where(ok, r, best_j)
        best_pa = torch.where(ok, pa, best_pa)
        best_pb = torch.where(ok, pb, best_pb)
    return _finish(scene, torch.isfinite(best_t), best_t, best_j, best_pa,
                   best_pb, t_max, dt)


def _intersect_sweep(o, d, time, scene, t_min, t_max):
    """[N, R] masked sweep (many rects)."""
    rot, trans = scene.rect_rot, scene.rect_trans        # [R,3,3], [R,3]
    if scene.has_rect_xform:
        # x_o = R^T (x_w - t);  d_o = R^T d_w
        o_l = torch.einsum("rji,nrj->nri", rot, o[:, None, :] - trans[None])
        d_l = torch.einsum("rji,nj->nri", rot, d)
    else:
        o_l = o[:, None, :]
        d_l = d[:, None, :]
    n_sel, a_sel, b_sel = selectors(scene.rect_axis, o.dtype)

    on = torch.sum(o_l * n_sel[None], dim=-1)            # [N,R]
    dn = torch.sum(d_l * n_sel[None], dim=-1)
    dn_ok = dn != 0.0            # parallel-ray guard (see _intersect_loop)
    dn = torch.where(dn_ok, dn, 1.0)
    t = (scene.rect_k[None] - on) / dn                   # geometry.scm:378-379
    pa = (torch.sum(o_l * a_sel[None], dim=-1)
          + t * torch.sum(d_l * a_sel[None], dim=-1))
    pb = (torch.sum(o_l * b_sel[None], dim=-1)
          + t * torch.sum(d_l * b_sel[None], dim=-1))

    inside = ((pa >= scene.rect_a0[None]) & (pa <= scene.rect_a1[None])
              & (pb >= scene.rect_b0[None]) & (pb <= scene.rect_b1[None]))
    ok = (dn_ok & (t >= t_min) & (t <= t_max) & inside
          & scene.rect_valid[None])
    t = torch.where(ok, t, math.inf)

    tb, j = torch.min(t, dim=1)
    ga = lambda x: torch.gather(x, 1, j[:, None])[:, 0]
    return _finish(scene, torch.isfinite(tb), tb, j, ga(pa), ga(pb), t_max,
                   o.dtype)
