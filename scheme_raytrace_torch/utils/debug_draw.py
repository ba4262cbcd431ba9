"""Debug rasterizers for the Bézier machinery (main.scm:575-608).

The port of scheme_raytrace_tpu/utils/debug_draw.py: the curve goes
through the port's ops/bezier on float32 CPU tensors.

The reference plots a curve's points (`draw-bezier`, main.scm:583-594)
and a tangent ray (`draw-tan-vec`, main.scm:596-608) directly into the
u8 framebuffer as dev scaffolding for the ray/Bézier intersector.  Same
capability here, vectorized: sample all parameters at once, evaluate the
cubic in one batched call (ops/bezier.py power basis), scatter RGB into
the image.  Host-side numpy — a debug visualizer, not a hot path.

Conventions reproduced: image row 0 = bottom (the framebuffer layout,
main.scm:445); `draw_bezier` centers coordinates on the frame
(main.scm:586-588); `draw_tan_vec` plots 500 steps of 0.1 along the
tangent without the center offset (main.scm:598-608 — its quirk).  Out-
of-bounds points are dropped (the reference would corrupt adjacent rows
via its flat-index write; clipping is strictly safer scaffolding).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import bezier as bz


def _f32(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


def _eval_np(cp, t):
    """Batched cubic evaluation: cp [4,3], t [K] -> [K,3] (numpy)."""
    pts = bz.eval_bezier(_f32(cp)[None], _f32(t)[:, None])
    return pts[:, 0, :].numpy()


def _scatter(img, xs, ys, color):
    ny, nx = img.shape[:2]
    xs = np.floor(xs).astype(np.int64)
    ys = np.floor(ys).astype(np.int64)
    ok = (xs >= 0) & (xs < nx) & (ys >= 0) & (ys < ny)
    img[ys[ok], xs[ok]] = np.asarray(color, img.dtype)
    return img


def draw_bezier(img, cp, color=(255, 0, 0), step=0.01):
    """Rasterize a curve's points into img [ny,nx,3] u8 (main.scm:583-594).

    Coordinates are the curve's (x, y) offset by the frame center, one
    point per `step` of the parameter — the reference's loop, batched.
    Returns img (modified in place) for chaining.
    """
    ny, nx = img.shape[:2]
    t = np.arange(0.0, 1.0, step)
    p = _eval_np(cp, t)
    return _scatter(img, nx / 2 + p[:, 0], ny / 2 + p[:, 1], color)


def draw_tan_vec(img, cp, t, color=(0, 255, 0), length=50.0, step=0.1):
    """Rasterize the tangent ray at parameter t (main.scm:596-608).

    Points p(t) + s * tangent(t) for s in [0, length) — the reference's
    500-step loop, batched; no center offset (its convention).
    """
    cp_t = _f32(cp)[None]
    t_t = _f32([t])
    p0 = bz.eval_bezier(cp_t, t_t[:, None])[0, 0].numpy()
    tan = bz.tangent(cp_t, t_t[:, None])[0, 0].numpy()
    s = np.arange(0.0, length, step)
    pts = p0[None, :] + s[:, None] * tan[None, :]
    return _scatter(img, pts[:, 0], pts[:, 1], color)
