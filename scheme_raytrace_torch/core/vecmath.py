"""Batched 3-vector algebra on ``[..., 3]`` tensors (vec.scm:7-70).

The port of scheme_raytrace_tpu/core/vecmath.py, plus material.scm:41-43
(reflect), :59-67 (refract) and :69-74 (schlick), and `maximum` / `clip`,
JAX's `jnp.maximum` / `jnp.clip` against a constant with JAX's gradient at
a tie, which every port of such a line uses.
"""

from __future__ import annotations

import torch


def maximum(x, c):
    """jnp.maximum(x, c) for a constant c: at a tie the gradient splits
    0.5 / 0.5 between the two sides, as in JAX (torch.clamp would pass all
    of it to x)."""
    return torch.maximum(x, x.new_tensor(c))


def minimum(x, c):
    """jnp.minimum(x, c) for a constant c, with JAX's tie gradient."""
    return torch.minimum(x, x.new_tensor(c))


def clip(x, lo, hi):
    """jnp.clip(x, lo, hi) with JAX's tie gradients (see `maximum`)."""
    return minimum(maximum(x, lo), hi)


# Tables of up to this many rows sum a gather's cotangents by a one-hot
# product, in chunks of TAKE_CHUNK rows; larger ones (an image atlas) by
# embedding's backward.
TAKE_ROWS_MAX = 1024
TAKE_CHUNK = 256


class _Take(torch.autograd.Function):
    """flat[idx] for a [T, D] table and an index per lane; the backward sums
    each row's cotangents as a one-hot [T, N] by [N, D] product."""

    @staticmethod
    def forward(ctx, flat, idx):
        ctx.save_for_backward(idx)
        ctx.rows = flat.shape[0]
        return flat[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        g = g.reshape(-1, g.shape[-1])
        lanes = idx.reshape(1, -1)
        parts = []
        for r0 in range(0, ctx.rows, TAKE_CHUNK):
            rows = torch.arange(r0, min(r0 + TAKE_CHUNK, ctx.rows),
                                device=idx.device)
            parts.append((rows[:, None] == lanes).to(g.dtype) @ g)
        return torch.cat(parts), None


def take(table, idx):
    """table[idx] over the table's first axis, for an integer index per lane:
    the same values as indexing, with a backward that is fast and bitwise
    repeatable on the card.  The advanced index's own backward (index_put_
    with accumulate) walks a row's duplicates one after another on CUDA,
    which held a 512x512 training step's card busy for most of its 30 s,
    and embedding's or index_select's add through float atomics, whose
    order changes a float32 sum from run to run; here a table of up to
    TAKE_ROWS_MAX rows sums by a one-hot matrix product.  A larger table
    (an image atlas) takes embedding's backward."""
    flat = table.reshape(table.shape[0], -1)
    if flat.shape[0] <= TAKE_ROWS_MAX:
        out = _Take.apply(flat, idx.long())
    else:
        out = torch.nn.functional.embedding(idx, flat)
    return out.reshape(idx.shape + table.shape[1:])


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
    x = maximum(1.0 - cosine, 0.0)
    x2 = x * x
    return r0 + (1.0 - r0) * (x2 * x2 * x)


def where3(mask, a, b):
    """Select whole vectors with a scalar-per-row mask."""
    return torch.where(mask[..., None], a, b)
