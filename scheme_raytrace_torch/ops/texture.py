"""Batched texture evaluation (texture.scm), integer-id dispatched.

The port of scheme_raytrace_tpu/ops/texture.py: `value` evaluates one
texture id per ray with masked math over the texture types the scene has
(the `has_*_tex` flags gate whole branches).  Checker children are
constant textures, so the nested lookup is a table read.
"""

from __future__ import annotations

import torch

from ..core import vecmath as vm
from ..scene import build as sb
from ..scene import perlin


def value(scene, tex_id, u, v, p):
    """Evaluate textures: tex_id [N] i32, u/v [N], p [N,3] -> color [N,3]."""
    tex_id = tex_id.long()
    ttype = scene.tex_type[tex_id]                       # [N]
    out = vm.take(scene.tex_color, tex_id)               # constant (texture.scm:12-14)

    if scene.has_checker_tex:
        # texture.scm:16-23 — sign of sin(10x)sin(10y)sin(10z)
        sines = (torch.sin(10.0 * p[..., 0]) * torch.sin(10.0 * p[..., 1])
                 * torch.sin(10.0 * p[..., 2]))
        child = torch.where(sines < 0.0, scene.tex_child1[tex_id],
                            scene.tex_child0[tex_id])
        out = torch.where((ttype == sb.TEX_CHECKER)[..., None],
                          vm.take(scene.tex_color, child.long()), out)

    if scene.has_perlin_tex:
        scale = vm.take(scene.tex_scale, tex_id)
        # texture.scm:25-28 — raw noise (range ~[-1,1], reproduced as-is)
        gray_noise = perlin.noise(scene.perlin_seed, p * scale[..., None])
        # texture.scm:30-34 — marble: 0.5*(1+sin(sc*z + 10*turb(p)))
        gray_marble = 0.5 * (1.0 + torch.sin(
            scale * p[..., 2] + 10.0 * perlin.turb(scene.perlin_seed, p)))
        out = torch.where((ttype == sb.TEX_NOISE)[..., None],
                          gray_noise[..., None], out)
        out = torch.where((ttype == sb.TEX_MARBLE)[..., None],
                          gray_marble[..., None], out)

    if scene.has_image_tex:
        # texture.scm:36-50 — clamped nearest lookup, v flipped
        nx = scene.tex_iw[tex_id].to(p.dtype)
        ny = scene.tex_ih[tex_id].to(p.dtype)
        i = torch.clamp(torch.clamp(u * nx, min=0.0), max=nx - 1.0).long()
        j = torch.clamp(torch.clamp((1.0 - v) * ny - 0.001, min=0.0),
                        max=ny - 1.0).long()
        img = scene.tex_image[tex_id].long()
        _, h, w, _ = scene.images.shape
        texel = vm.take(scene.images.reshape(-1, 3),      # [N,3]
                        (img * h + j) * w + i)
        out = torch.where((ttype == sb.TEX_IMAGE)[..., None], texel, out)

    return out
