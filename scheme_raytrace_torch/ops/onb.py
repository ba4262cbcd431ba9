"""Orthonormal basis from a normal (onb.scm:8-36), batched.

The port of scheme_raytrace_tpu/ops/onb.py: the reference's |w.x| > 0.9
pivot as a masked select, and the right-handed u = v x w (a documented
fix; every consumer is azimuthally symmetric or handedness-invariant).
"""

from __future__ import annotations

import torch

from ..core import vecmath as vm


def from_w(w):
    """Build (u, v, w) frames from unit normals w: [...,3] -> 3x [...,3].

    onb.scm:8-16: a = |w.x|>0.9 ? (0,1,0) : (1,0,0); v = unit(w x a);
    u = v x w.
    """
    w = vm.unit(w, eps=1e-12)       # eps: masked lanes may pass junk vectors
    pick_y = torch.abs(w[..., 0]) > 0.9
    a = torch.where(pick_y[..., None],
                    w.new_tensor([0.0, 1.0, 0.0]),
                    w.new_tensor([1.0, 0.0, 0.0]))
    v = vm.unit(vm.cross(w, a), eps=1e-12)
    u = vm.cross(v, w)
    return u, v, w


def local(u, v, w, a):
    """Frame-to-world for local coords a=[...,3] (onb.scm:27-36)."""
    return a[..., 0:1] * u + a[..., 1:2] * v + a[..., 2:3] * w
