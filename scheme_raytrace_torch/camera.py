"""Thin-lens + motion-blur camera (camera.scm:63-92), batched.

The camera is a dataclass of the pose parameters themselves (0-d or [3]
tensors) and the basis is derived from them on use, as in
scheme_raytrace_tpu/camera.py; ray directions are normalized at generation.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .config import resolve_device
from .core import vecmath as vm
from .ops import sampling

CAMERA_FIELDS = ("lookfrom", "lookat", "vup", "vfov", "aspect", "aperture",
                 "focus_dist", "time0", "time1")


@dataclasses.dataclass
class Camera:
    """Camera parameters (camera.scm:63-78 argument list)."""

    lookfrom: torch.Tensor   # [3]
    lookat: torch.Tensor     # [3]
    vup: torch.Tensor        # [3]
    vfov: torch.Tensor       # degrees, vertical axis (camera.scm:65)
    aspect: torch.Tensor     # width/height
    aperture: torch.Tensor
    focus_dist: torch.Tensor
    time0: torch.Tensor
    time1: torch.Tensor


def make_camera(lookfrom, lookat, vup=(0.0, 1.0, 0.0), vfov=40.0, aspect=1.0,
                aperture=0.0, focus_dist=10.0, time0=0.0, time1=0.0,
                dtype=torch.float32, device=None) -> Camera:
    """Camera on `device` (None: the card, config.resolve_device)."""
    device = resolve_device(device)
    f = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    return Camera(f(lookfrom), f(lookat), f(vup), f(vfov), f(aspect),
                  f(aperture), f(focus_dist), f(time0), f(time1))


def camera_from_arrays(arrays: dict, device=None,
                       dtype=torch.float32) -> Camera:
    """Camera from numpy arrays of the JAX Camera's fields (same names)."""
    device = resolve_device(device)
    return Camera(**{k: torch.tensor(arrays[k], dtype=dtype, device=device)
                     for k in CAMERA_FIELDS})


def _basis(cam: Camera):
    """camera.scm:66-78 — (origin, lower_left, horizontal, vertical, u, v, w)."""
    theta = cam.vfov * (math.pi / 180.0)
    half_h = torch.tan(theta / 2.0)
    half_w = cam.aspect * half_h
    w = vm.unit(cam.lookfrom - cam.lookat)
    u = vm.unit(vm.cross(cam.vup, w))
    v = vm.cross(w, u)
    origin = cam.lookfrom
    fd = cam.focus_dist
    lower_left = origin - half_w * fd * u - half_h * fd * v - fd * w
    horizontal = 2.0 * half_w * fd * u
    vertical = 2.0 * half_h * fd * v
    return origin, lower_left, horizontal, vertical, u, v, w


def get_rays_u(cam: Camera, s, t, lens_r1, lens_r2, time_xi):
    """Batched camera.scm:80-92 — (s, t) in [0,1]^2, one ray per element.

    Returns (origin[N,3], unit dir[N,3], time[N]).
    """
    origin, lower_left, horizontal, vertical, u, v, _ = _basis(cam)
    lens_radius = cam.aperture / 2.0
    rd = lens_radius * sampling.in_unit_disk_u(lens_r1, lens_r2)
    offset = rd[..., 0:1] * u + rd[..., 1:2] * v
    time = cam.time0 + time_xi * (cam.time1 - cam.time0)
    o = origin + offset
    d = (lower_left + s[..., None] * horizontal + t[..., None] * vertical
         - origin - offset)
    return o, vm.unit(d), time
