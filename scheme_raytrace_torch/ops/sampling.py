"""Batched random samplers (util.scm:9-54): the uniform-draw cores.

The port of the `*_u` functions of scheme_raytrace_tpu/ops/sampling.py:
each maps explicit U[0,1) draws to a sample (exact analytic inverse-CDF
forms of the reference's rejection loops, with `random-cosine-direction`'s
x2 bug fixed to the standard sqrt(r2) form).  The draws come from the
counter hash (core/rng.py); the key-based wrappers of the JAX module belong
to the differentiable wavefront path and are not ported yet.
"""

from __future__ import annotations

import math

import torch

from ..core import vecmath as vm

_TWO_PI = 2.0 * math.pi


def in_unit_sphere_u(r1, r2, r3):
    """Uniform point inside the unit ball from 3 U[0,1) draws
    (util.scm:9-15, analytic form)."""
    z = 2.0 * r1 - 1.0
    phi = _TWO_PI * r2
    # cbrt: torch has none, and pow's vectorised and scalar CPU paths
    # differ in the last bit (see core/vecmath.schlick); exp and log agree
    r = torch.exp(torch.log(r3) / 3.0)
    s = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return r[..., None] * vm.vec3(s * torch.cos(phi), s * torch.sin(phi), z)


def in_unit_disk_u(r1, r2):
    """Uniform point in the unit disk, z=0 (util.scm:17-23, analytic)."""
    r = torch.sqrt(r1)
    phi = _TWO_PI * r2
    return vm.vec3(r * torch.cos(phi), r * torch.sin(phi), torch.zeros_like(r))


def cosine_direction_u(r1, r2):
    """Cosine-weighted hemisphere direction about +z (util.scm:37-44,
    B4 fixed)."""
    phi = _TWO_PI * r1
    sr2 = torch.sqrt(r2)
    z = torch.sqrt(torch.clamp(1.0 - r2, min=0.0))
    return vm.vec3(torch.cos(phi) * sr2, torch.sin(phi) * sr2, z)


def hemisphere_direction_u(r1, r2):
    """Uniform hemisphere direction about +z (util.scm:25-35, analytic)."""
    z = r1                                          # cos(theta) ~ U[0,1]
    phi = _TWO_PI * r2
    s = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return vm.vec3(s * torch.cos(phi), s * torch.sin(phi), z)


def to_sphere_u(r1, r2, radius, distance_sq):
    """Solid-angle direction toward a sphere, local frame (util.scm:46-54).

    The hittable-PDF light sampler's draw; radius / distance_sq broadcast
    against the draws.
    """
    # double-where (not maximum): sqrt'(0)=inf times maximum's zero cotangent
    # is NaN in reverse mode when the shading point is inside the sphere
    inner = 1.0 - radius * radius / distance_sq
    outside = inner > 0.0
    cos_theta_max = torch.where(
        outside, torch.sqrt(torch.where(outside, inner, 1.0)), 0.0)
    z = 1.0 + r2 * (cos_theta_max - 1.0)
    phi = _TWO_PI * r1
    zin = 1.0 - z * z
    z_ok = zin > 0.0
    s = torch.where(z_ok, torch.sqrt(torch.where(z_ok, zin, 1.0)), 0.0)
    return vm.vec3(torch.cos(phi) * s, torch.sin(phi) * s, z)
