"""The counter-based PCG4D stream of the path tracer, written out again.

A path's every draw is keyed by (seed, work item, depth, column group):
four uint32 counters through one PCG4D round, the top 24 bits of each
output as a uniform in [0, 1).  This is the published PCG4D hash (Jarzynski
and Olano, "Hash Functions for GPU Rendering", JCGT 2020) with the salts
the renderer uses; uint32 values live in int64 tensors masked to 32 bits.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
PCG_MULT = 1664525
PCG_ADD = 1013904223
INV_2_24 = 1.0 / float(1 << 24)

CAMERA_DEPTH = 0xFFFF     # the `depth` counter of a camera ray's draws


def _mul32(a, b):
    """(a * b) mod 2**32, each product split so no int64 overflows."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def pcg4d(a, b, c, d):
    a = (a * PCG_MULT + PCG_ADD) & M32
    b = (b * PCG_MULT + PCG_ADD) & M32
    c = (c * PCG_MULT + PCG_ADD) & M32
    d = (d * PCG_MULT + PCG_ADD) & M32
    a = (a + _mul32(b, d)) & M32
    b = (b + _mul32(c, a)) & M32
    c = (c + _mul32(a, b)) & M32
    d = (d + _mul32(b, c)) & M32
    a, b, c, d = a ^ (a >> 16), b ^ (b >> 16), c ^ (c >> 16), d ^ (d >> 16)
    a = (a + _mul32(b, d)) & M32
    b = (b + _mul32(c, a)) & M32
    c = (c + _mul32(a, b)) & M32
    d = (d + _mul32(b, c)) & M32
    return a, b, c, d


def uniforms(seed: int, item, depth, ncols: int, dtype):
    """`ncols` columns of [N] uniforms for work items `item` (int tensor)
    at `depth` (int or int tensor): column group g holds columns 4g..4g+3."""
    it = item.to(torch.int64) & M32
    dp = torch.broadcast_to(torch.as_tensor(depth, device=it.device)
                            .to(torch.int64) & M32, it.shape)
    sd = torch.full_like(it, seed & M32)
    cols = []
    for g in range((ncols + 3) // 4):
        cols.extend(pcg4d(it, dp, torch.full_like(it, g), sd))
    return [((c >> 8).to(torch.float64) * INV_2_24).to(dtype)
            for c in cols[:ncols]]
