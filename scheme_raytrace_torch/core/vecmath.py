"""Batched 3-vector algebra on ``[..., 3]`` tensors (vec.scm:7-70).

The part of scheme_raytrace_tpu/core/vecmath.py that the camera and the
samplers use.
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
