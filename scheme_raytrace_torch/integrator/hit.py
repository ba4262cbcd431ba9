"""Scene-level closest-hit query: masked sweeps over every primitive group.

The port of scheme_raytrace_tpu/integrator/hit.py: per-group batched
intersectors combined by a running min (the reference's `hit-obj-list`
walk, geometry.scm:33-50).  Constant media are resolved after the solid
groups, so their scatter interval is clipped to the closest solid hit
(geometry.scm:556-557).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import bezier, klein, medium, rect, sphere, traverse


class HitRec(NamedTuple):
    """SoA hit record (ray.scm:27-54): [t, p, normal, material, u, v] + mask."""
    hit: torch.Tensor      # [N] bool
    t: torch.Tensor        # [N]
    p: torch.Tensor        # [N,3]
    normal: torch.Tensor   # [N,3]
    mat: torch.Tensor      # [N] int
    u: torch.Tensor        # [N]
    v: torch.Tensor        # [N]


def _merge(best, cand):
    """Keep the closer of two group results (hit, t, n, mat, u, v)."""
    bh, bt, bn, bm, bu, bv = best
    ch, ct, cn, cm, cu, cv = cand
    closer = ch & (~bh | (ct < bt))
    c3 = closer[:, None]
    return (bh | ch, torch.where(closer, ct, bt), torch.where(c3, cn, bn),
            torch.where(closer, cm.long(), bm), torch.where(closer, cu, bu),
            torch.where(closer, cv, bv))


def scene_hit(o, d, time, scene, t_min, t_max, xi_medium, config) -> HitRec:
    """Closest hit over all groups; o/d [N,3], d unit; t_max scalar.

    xi_medium: [N, n_media] uniforms for exponential scatter distances
    (None allowed when the scene has no constant media).
    """
    n = o.shape[0]
    dt, dev = o.dtype, o.device
    best = (torch.zeros(n, dtype=torch.bool, device=dev),
            torch.full((n,), t_max, dtype=dt, device=dev),
            torch.zeros((n, 3), dtype=dt, device=dev),
            torch.zeros(n, dtype=torch.int64, device=dev),
            torch.zeros(n, dtype=dt, device=dev),
            torch.zeros(n, dtype=dt, device=dev))

    # The flat threaded BVH (geometry.scm:217-374) when compiled into the
    # scene and selected: one tree spans both analytic groups.  The
    # traversal is forward-only, so the differentiable path keeps the sweeps.
    use_bvh = (config.traversal == "bvh" and scene.has_bvh
               and not config.differentiable)
    if use_bvh and (scene.has_spheres or scene.has_rects):
        best = _merge(best, traverse.intersect_bvh_mixed(
            o, d, time, scene, t_min, t_max))
    else:
        if scene.has_spheres:
            best = _merge(best, sphere.intersect(o, d, time, scene,
                                                 t_min, t_max))
        if scene.has_rects:
            best = _merge(best, rect.intersect(o, d, time, scene,
                                               t_min, t_max))
    if scene.has_beziers:
        best = _merge(best, bezier.intersect(
            o, d, time, scene, t_min, t_max,
            n_seeds=config.bezier_seeds, n_newton=config.bezier_newton))
    if scene.has_klein:
        best = _merge(best, klein.intersect(o, d, time, scene, t_min, t_max))
    if scene.has_media:
        # t clipped to the closest solid hit (or t_max on miss)
        hit0, t0 = best[0], best[1]
        t_clip = torch.where(hit0, t0, t_max)
        best = _merge(best, medium.intersect(o, d, time, scene, t_min,
                                             t_clip, xi_medium))

    hit, t, normal, mat, u, v = best
    # Sanitize miss lanes: shading runs masked over the whole batch.
    #   p = o (not o + t_max*d ~ 1e12, which overflows f32 light-PDF math);
    #   normal = +y (not the zero vector, which NaNs onb.from_w).
    p = torch.where(hit[:, None], o + t[:, None] * d, o)
    normal = torch.where(hit[:, None], normal, normal.new_tensor([0.0, 1.0,
                                                                 0.0]))
    return HitRec(hit, t, p, normal, mat, u, v)
