"""Batched 3-vector algebra on ``[..., 3]`` tensors (vec.scm:7-70).

The port of scheme_raytrace_tpu/core/vecmath.py, plus material.scm:41-43
(reflect), :59-67 (refract) and :69-74 (schlick).
"""

from __future__ import annotations

import torch


def vec3(x, y, z, dtype=None):
    """Stack three scalars/batches into a ``[..., 3]`` vector (vec.scm:7)."""
    x, y, z = torch.broadcast_tensors(torch.as_tensor(x), torch.as_tensor(y),
                                      torch.as_tensor(z))
    v = torch.stack([x, y, z], dim=-1)
    return v.to(dtype) if dtype is not None else v


def sq_len(a):
    """vec.scm:56-58."""
    return torch.sum(a * a, dim=-1)


def length(a):
    """vec.scm:54-55."""
    return torch.sqrt(sq_len(a))


def unit(a, eps: float = 0.0):
    """vec.scm:60-62 — normalize; optional eps guards 0-length."""
    n = length(a)
    if eps:
        n = torch.maximum(n, n.new_tensor(eps))    # JAX's tie gradient
    return a / n[..., None]


def cross(a, b):
    """vec.scm:64-70."""
    return torch.linalg.cross(a, b, dim=-1)


def dot(a, b):
    """vec.scm:52 — batched inner product over the trailing axis."""
    return torch.sum(a * b, dim=-1)


def reflect(v, n):
    """material.scm:41-43 — mirror reflection v - 2(v.n)n."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(v, n, ni_over_nt):
    """material.scm:59-67 — Snell refraction of *unit-ized* v about n.

    Returns (ok, refracted): ok=False marks total internal reflection, in
    which case `refracted` is zeros (the caller selects the reflection).
    """
    uv = unit(v)
    dt = dot(uv, n)
    disc = 1.0 - ni_over_nt * ni_over_nt * (1.0 - dt * dt)
    ok = disc > 0.0
    # double-where keeps sqrt' finite on the total-internal-reflection lanes
    safe = torch.sqrt(torch.where(ok, disc, 1.0))
    refr = ni_over_nt[..., None] * (uv - n * dt[..., None]) - n * safe[..., None]
    return ok, torch.where(ok[..., None], refr, 0.0)


def schlick(cosine, ref_idx):
    """material.scm:69-74 — Schlick's Fresnel approximation.

    The fifth power is three products, not `torch.pow`: on the CPU
    PyTorch's vectorised pow and its scalar tail differ in the last bit, so
    a lane's value would depend on its position in the batch, and the
    material-sorted shading (integrator/shade.shade_sorted) must equal the
    masked one bit for bit."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    x = torch.clamp(1.0 - cosine, min=0.0)
    x2 = x * x
    return r0 + (1.0 - r0) * (x2 * x2 * x)


def where3(mask, a, b):
    """Select whole vectors with a scalar-per-row mask."""
    return torch.where(mask[..., None], a, b)
