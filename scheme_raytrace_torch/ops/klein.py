"""Kleinian limit-set fractal: distance-estimated sphere inversions
(geometry.scm:580-664), sphere-traced with fixed-trip-count loops.

The port of scheme_raytrace_tpu/ops/klein.py.  The six inversion spheres'
interiors are disjoint, so the reference's rescan from index 0 after every
inversion is a masked select of the unique containing sphere.  The march
(100 steps) and the inversions (10) are Python loops of fixed length with
no host sync; the normal is the exact DE gradient (three forward-mode
tangents through `dist_func`, `torch.func.jvp`), as in JAX.
"""

from __future__ import annotations

import math

import torch

from .. import config as cfg
from ..core import vecmath as vm

# geometry.scm:591-599
_SPHERE_POS = [[300.0, 300.0, 0.0], [300.0, -300.0, 0.0],
               [-300.0, 300.0, 0.0], [-300.0, -300.0, 0.0],
               [0.0, 0.0, 424.26], [0.0, 0.0, -424.26]]


def dist_func(center, pos):
    """Batched DE (geometry.scm:602-624): <=10 inversions, 0.7*(|p|-125)/|dr|."""
    sph = pos.new_tensor(_SPHERE_POS)                         # [6,3]
    r2 = cfg.KLEIN_SPHERE_R * cfg.KLEIN_SPHERE_R
    tiny = torch.finfo(pos.dtype).tiny
    p = pos - center
    dr = torch.ones(pos.shape[:-1], dtype=pos.dtype, device=pos.device)
    active = torch.ones(pos.shape[:-1], dtype=torch.bool, device=pos.device)
    for _ in range(cfg.KLEIN_ITERATIONS):
        diff = p[..., None, :] - sph                          # [...,6,3]
        d2 = vm.sq_len(diff)
        inside = (d2 < r2) & active[..., None]
        any_in = torch.any(inside, dim=-1)
        k = torch.argmax(inside.to(torch.int32), dim=-1)      # unique when any
        dk = torch.take_along_dim(diff, k[..., None, None], dim=-2)[..., 0, :]
        d2k = torch.clamp(
            torch.take_along_dim(d2, k[..., None], dim=-1)[..., 0], min=tiny)
        scale = r2 / d2k                                      # geometry.scm:615
        p_inv = dk * scale[..., None] + sph[k]                # geometry.scm:616-618
        p = torch.where(any_in[..., None], p_inv, p)
        dr = torch.where(any_in, dr * scale, dr)
        active = active & any_in
    return cfg.KLEIN_DE_SCALE * (vm.length(p) - cfg.KLEIN_R) / torch.abs(dr)


def _de_grad(center, p):
    """The DE's gradient at p [...,3]: one forward-mode tangent an axis."""
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    return torch.stack(
        [torch.func.jvp(lambda q: dist_func(center, q), (p,),
                        (eye[ax].expand(p.shape),))[1] for ax in range(3)],
        dim=-1)


def get_normal(center, p):
    """Exact DE gradient, normalised (the reference's central differences,
    geometry.scm:626-632, replaced as in the JAX package)."""
    return vm.unit(_de_grad(center, p))


def _march_one(o, d, center, t_min, t_max):
    """Sphere trace one klein instance (geometry.scm:646-661): from
    ray_length 0, evaluating at the pre-advance position each step and
    accepting on the post-advance length."""
    ray_len = torch.zeros(o.shape[:-1], dtype=o.dtype, device=o.device)
    done = torch.zeros(o.shape[:-1], dtype=torch.bool, device=o.device)
    hit = done
    for _ in range(cfg.KLEIN_MAX_STEPS):
        pos = o + d * ray_len[..., None]
        dist = dist_func(center, pos)
        new_len = ray_len + dist
        accept = ((dist < cfg.KLEIN_SURF_EPS) & (new_len > t_min)
                  & (new_len < t_max))
        ray_len = torch.where(done, ray_len, new_len)
        hit = hit | (accept & ~done)
        done = done | accept
    return hit, torch.where(hit, ray_len, math.inf)


def intersect(o, d, time, scene, t_min, t_max):
    """Closest klein hit per ray (usually one instance a scene).

    The march carries no gradient; the hit's t is differentiated by the
    implicit function, t -= (DE(o + t d) - eps) / dDE/dt at the converged
    root, a primal-zero correction (the fused step's convention).  Miss
    lanes evaluate the DE at a benign point outside every inversion sphere.
    """
    best_t = torch.full(o.shape[:-1], math.inf, dtype=o.dtype,
                        device=o.device)
    best_mat = torch.zeros(o.shape[:-1], dtype=torch.int32, device=o.device)
    best_c = torch.zeros_like(o)
    for i in range(scene.kl_center.shape[0]):
        with torch.no_grad():
            h, t = _march_one(o, d, scene.kl_center[i], t_min, t_max)
        h = h & scene.kl_valid[i]
        closer = h & (t < best_t)
        best_t = torch.where(closer, t, best_t)
        best_mat = torch.where(closer, scene.kl_mat[i], best_mat)
        best_c = vm.where3(closer, scene.kl_center[i].expand(o.shape), best_c)
    hit = torch.isfinite(best_t)
    t_raw = torch.where(hit, best_t, t_max).detach()
    p_raw = o + t_raw[..., None] * d                  # differentiable in o, d
    safe = o.new_tensor([200.0, 0.0, 0.0])            # outside every
    p_eval = torch.where(hit[..., None], p_raw,
                         best_c.detach() + safe)      # inversion sphere
    de = dist_func(best_c, p_eval)
    g = _de_grad(best_c, p_eval)
    ddt = torch.sum(g * d, dim=-1)
    eps = ddt.new_tensor(1e-6)
    denom = torch.where(torch.abs(ddt) > 1e-6, ddt,
                        torch.where(ddt >= 0.0, eps, -eps))
    corr = torch.where(hit, (de - cfg.KLEIN_SURF_EPS) / denom, 0.0)
    t = t_raw - (corr - corr.detach())                # primal == t_raw
    normal = vm.unit(g)
    tb = torch.where(hit, t, t_max)
    zero = torch.zeros_like(tb)
    return hit, tb, normal, best_mat, zero, zero
