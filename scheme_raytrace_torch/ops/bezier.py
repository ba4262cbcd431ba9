"""Ray x cubic-Bezier-"ribbon" intersection (bezier.scm:61-223).

The port of scheme_raytrace_tpu/ops/bezier.py.  In ray space (ray = +z) a
hit is a curve parameter s where g(s) = Cx(s)^2 + Cy(s)^2 dips below
(width/2)^2: seeds uniform in s, damped Newton on g'(s) = 0 for a fixed
trip count, then the root (not the Newton tape) is differentiated by the
implicit function with a scale-relative curvature floor.  Acceptance as
bezier.scm:161-166 (g < (w/2)^2, z > 1e-4, t_min < z <= t_max); the hit
has normal -d and u = v = 0 (B11).
"""

from __future__ import annotations

import math

import torch

from . import onb
from ..core import vecmath as vm

Z_FLOOR = 0.0001  # bezier.scm:163


def power_coeffs(cp):
    """Control points [...,4,C] -> power-basis coeffs (a0..a3) [...,C]."""
    p0, p1, p2, p3 = cp[..., 0, :], cp[..., 1, :], cp[..., 2, :], cp[..., 3, :]
    a0 = p0
    a1 = 3.0 * (p1 - p0)
    a2 = 3.0 * (p0 - 2.0 * p1 + p2)
    a3 = -p0 + 3.0 * p1 - 3.0 * p2 + p3
    return a0, a1, a2, a3


def eval_bezier(cp, s):
    """De-Casteljau-equivalent evaluation at s [...] for cp [...,4,C]."""
    a0, a1, a2, a3 = power_coeffs(cp)
    s = s[..., None]
    return a0 + s * (a1 + s * (a2 + s * a3))


def tangent(cp, s):
    """bezier.scm:106-117 — cubic derivative."""
    _, a1, a2, a3 = power_coeffs(cp)
    s = s[..., None]
    return a1 + s * (2.0 * a2 + s * 3.0 * a3)


def intersect(o, d, time, scene, t_min, t_max, n_seeds: int = 32,
              n_newton: int = 8):
    """Closest bezier hit per ray.

    o, d: [N,3]; scene.bez_cp: [B,4,3]; returns the standard group tuple.
    """
    u_f, v_f, w_f = onb.from_w(d)                       # [N,3] ray-space frame
    rel = scene.bez_cp[None] - o[:, None, None, :]      # [N,B,4,3]
    cx = vm.dot(rel, u_f[:, None, None, :])             # [N,B,4]
    cy = vm.dot(rel, v_f[:, None, None, :])
    cz = vm.dot(rel, w_f[:, None, None, :])
    cp2 = torch.stack([cx, cy], dim=-1)                 # [N,B,4,2]
    # [N,B,1,2] each: broadcast over the seeds
    a0, a1, a2, a3 = (x[..., None, :] for x in power_coeffs(cp2))

    def g_and_derivs(s):
        ss = s[..., None]
        c = a0 + ss * (a1 + ss * (a2 + ss * a3))                  # [.,.,K,2]
        c1 = a1 + ss * (2.0 * a2 + ss * (3.0 * a3))
        c2 = 2.0 * a2 + ss * (6.0 * a3)
        g = torch.sum(c * c, dim=-1)
        dg = 2.0 * torch.sum(c * c1, dim=-1)
        d2g = 2.0 * torch.sum(c1 * c1 + c * c2, dim=-1)
        return g, dg, d2g

    # Seeds along the curve parameter, shared across rays and curves.
    s = torch.linspace(0.5 / n_seeds, 1.0 - 0.5 / n_seeds, n_seeds,
                       dtype=o.dtype, device=o.device)
    s = s.expand(cx.shape[:2] + (n_seeds,))             # [N,B,K]

    with torch.no_grad():
        for _ in range(n_newton):
            g, dg, d2g = g_and_derivs(s)
            step = dg / torch.where(d2g > 1e-12, d2g, 1e-12)  # damped: convex
            step = torch.where(d2g > 1e-12, step, 0.0)
            s = torch.clamp(s - step, 0.0, 1.0)

    # Differentiate the ROOT, not the iteration: ds*/dp = -(d(dg)/dp)/d2g,
    # attached by a primal-zero correction at the converged s, with the
    # curvature floor 0.05 * 2|C'(s)|^2 bounding grazing hits' estimator.
    _, dg, d2g = g_and_derivs(s)
    ss = s[..., None]
    c1 = a1 + ss * (2.0 * a2 + ss * (3.0 * a3))
    d2g_scale = 2.0 * torch.sum(c1 * c1, dim=-1)
    interior = (s > 0.0) & (s < 1.0)
    d2g_safe = torch.maximum(d2g, 0.05 * d2g_scale + 1e-12)
    corr = torch.where(interior, dg / d2g_safe, 0.0)
    s = s - (corr - corr.detach())

    g, _, _ = g_and_derivs(s)
    az0, az1, az2, az3 = (x[..., 0][..., None]
                          for x in power_coeffs(cz[..., None]))   # [N,B,1]
    z = az0 + s * (az1 + s * (az2 + s * az3))            # [N,B,K]
    half_w = (scene.bez_w * 0.5)[None, :, None]          # bezier.scm:64
    ok = ((g < half_w * half_w) & (z > Z_FLOOR)
          & (z > t_min) & (z <= t_max)
          & scene.bez_valid[None, :, None])
    t = torch.where(ok, z, math.inf)

    t_per_curve = torch.amin(t, dim=-1)                  # [N,B]
    tb, j = torch.min(t_per_curve, dim=1)
    hit = torch.isfinite(tb)
    tb = torch.where(hit, tb, t_max)
    normal = -d                                          # B11 convention
    zero = torch.zeros_like(tb)
    return hit, tb, normal, scene.bez_mat[j], zero, zero
