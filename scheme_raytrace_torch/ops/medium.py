"""Constant-density participating media (geometry.scm:545-578).

The port of scheme_raytrace_tpu/ops/medium.py.  Boundaries are convex
(boxes, in the medium's object space, or spheres), so the entry/exit
interval comes from one analytic line test.  Semantics as the reference:
t1 = max(max(entry, t_min), 0), t2 = min(exit, t_max), scatter iff
-1/rho ln(xi) < t2 - t1; the hit record has normal (1,0,0), u = v = 0 and
the medium's phase material.  t_max is the closest solid hit so far (the
integrator resolves solids first).
"""

from __future__ import annotations

import math

import torch

from . import aabb
from ..core import vecmath as vm
from ..scene import build as sb


def intersect(o, d, time, scene, t_min, t_max, xi):
    """Scatter events inside media, clipped to per-ray t_max [N].

    xi: [N, n_media] uniform draws in [0,1) (exponential distance sampling
    from the counter hash).  Returns (hit, t, normal, mat, u, v).
    """
    rot, trans = scene.med_rot, scene.med_trans          # [M,3,3], [M,3]
    o_l = torch.einsum("mji,nmj->nmi", rot, o[:, None, :] - trans[None])
    d_l = torch.einsum("mji,nj->nmi", rot, d)

    # Box boundary interval (object space)
    box_en, box_ex = aabb.slab_interval(o_l, d_l, scene.med_pmin[None],
                                        scene.med_pmax[None])
    box_ok = box_en < box_ex
    # Sphere boundary interval (world space; sphere media are never rotated)
    oc = o[:, None, :] - scene.med_center[None]
    b = vm.dot(oc, d[:, None, :])
    cq = vm.sq_len(oc) - scene.med_radius * scene.med_radius
    disc = b * b - cq
    sph_ok = disc > 0.0
    sq = torch.sqrt(torch.where(sph_ok, disc, 1.0))   # double-where for grads

    is_box = scene.med_kind[None] == sb.MED_BOX
    entry = torch.where(is_box, box_en, -b - sq)
    exit_ = torch.where(is_box, box_ex, -b + sq)
    ok = torch.where(is_box, box_ok, sph_ok) & scene.med_valid[None]

    t1 = torch.clamp(torch.clamp(entry, min=t_min), min=0.0)  # geometry.scm:556,560
    t2 = torch.minimum(exit_, t_max[:, None])                # geometry.scm:557
    ok = ok & (t1 < t2)

    xi = torch.clamp(xi, min=torch.finfo(o.dtype).tiny)      # log(0) guard
    hit_dist = scene.med_neg_inv_d[None] * torch.log(xi)     # geometry.scm:562-564
    ok = ok & (hit_dist < (t2 - t1))
    t = torch.where(ok, t1 + hit_dist, math.inf)

    tb, j = torch.min(t, dim=1)
    hit = torch.isfinite(tb)
    tb = torch.where(hit, tb, t_max)
    normal = o.new_tensor([1.0, 0.0, 0.0]).expand(o.shape)
    zero = torch.zeros_like(tb)
    return hit, tb, normal, scene.med_mat[j], zero, zero
