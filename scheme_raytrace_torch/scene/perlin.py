"""Perlin gradient noise, hash-based (table-free).

The port of scheme_raytrace_tpu/scene/perlin.py.  The reference hashes
lattice points through shuffled permutation tables (perlin.scm:10-36,
69-90); here the gradient at lattice point (i, j, k) is the unit vector
derived from one truncated PCG4D round over (i, j, k, seed), computed in
registers: the same recurrence as the renderer's RNG (core/rng.py) up to its
second mix, without the last xorshift and without the fourth output.  The
CUDA kernels (csrc/bounce_common.cuh: perlin_noise, perlin_turb) run the
same recurrence in uint32, so the plain step and the kernels see one noise
field, and an f64 CPU run equals the JAX package's to round-off.

Integer arithmetic as core/rng.py does it: each uint32 lives in an int64
masked to 32 bits.  A lattice coordinate is an int32 whose bit pattern is
read as uint32, so negative coordinates wrap as two's complement.

`seed` is a Python int fixed at scene build (Scene.perlin_seed).
"""

from __future__ import annotations

import torch

from ..core.rng import _M32, _PCG_ADD, _PCG_MULT, _mul32

_INV_2_24 = 1.0 / float(1 << 24)


def _hash_grad(ix, iy, iz, seed: int):
    """The three uint32 words (as int64) of the gradient at an integer
    lattice point: one PCG4D round over (ix, iy, iz, seed) that returns
    after the second mix of a, b and c.

    ix/iy/iz: integer tensors of any shape holding int32 values (negative
    ones are read as their uint32 bit patterns)."""
    a = ix.to(torch.int64) & _M32
    b = iy.to(torch.int64) & _M32
    c = iz.to(torch.int64) & _M32
    d = torch.full_like(a, seed & _M32)
    a = (a * _PCG_MULT + _PCG_ADD) & _M32
    b = (b * _PCG_MULT + _PCG_ADD) & _M32
    c = (c * _PCG_MULT + _PCG_ADD) & _M32
    d = (d * _PCG_MULT + _PCG_ADD) & _M32
    a = (a + _mul32(b, d)) & _M32
    b = (b + _mul32(c, a)) & _M32
    c = (c + _mul32(a, b)) & _M32
    d = (d + _mul32(b, c)) & _M32
    a = a ^ (a >> 16)
    b = b ^ (b >> 16)
    c = c ^ (c >> 16)
    a = (a + _mul32(b, d)) & _M32
    b = (b + _mul32(c, a)) & _M32
    c = (c + _mul32(a, b)) & _M32
    return a, b, c


def _to_sym(bits, dtype):
    """uint32 (as int64) -> (-1, 1) float from the top 24 bits."""
    return (bits >> 8).to(dtype) * (2.0 * _INV_2_24) - 1.0


def noise_xyz(seed: int, x, y, z):
    """SoA gradient noise at (x, y, z), same-shape float tensors.

    Hermite-smoothed trilinear gradient interpolation (perlin.scm:51-90):
    zero at lattice points, range within [-1, 1].  floor and the hash carry
    no gradient; the fade and the corner dots do."""
    dtype = x.dtype
    fx, fy, fz = torch.floor(x), torch.floor(y), torch.floor(z)
    ix, iy, iz = (f.to(torch.int32).to(torch.int64) for f in (fx, fy, fz))
    ux, uy, uz = x - fx, y - fy, z - fz
    # Hermite fade (perlin.scm:52-54)
    sx = ux * ux * (3.0 - 2.0 * ux)
    sy = uy * uy * (3.0 - 2.0 * uy)
    sz = uz * uz * (3.0 - 2.0 * uz)
    acc = torch.zeros_like(x)
    lo = x.new_tensor(1e-12)
    for di in range(2):
        for dj in range(2):
            for dk in range(2):
                ga, gb, gc = _hash_grad(ix + di, iy + dj, iz + dk, seed)
                gx = _to_sym(ga, dtype)
                gy = _to_sym(gb, dtype)
                gz = _to_sym(gc, dtype)
                inv = torch.rsqrt(torch.maximum(
                    gx * gx + gy * gy + gz * gz, lo))
                dot = ((ux - di) * gx + (uy - dj) * gy + (uz - dk) * gz) * inv
                w = ((sx if di else 1.0 - sx)
                     * (sy if dj else 1.0 - sy)
                     * (sz if dk else 1.0 - sz))
                acc = acc + w * dot
    return acc


def turb_xyz(seed: int, x, y, z, depth: int = 7):
    """7-octave |fBm| (perlin.scm:92-103), SoA."""
    acc = torch.zeros_like(x)
    weight = 1.0
    for _ in range(depth):
        acc = acc + weight * noise_xyz(seed, x, y, z)
        x, y, z = x * 2.0, y * 2.0, z * 2.0
        weight = weight * 0.5
    return torch.abs(acc)


def noise(seed: int, p):
    """Array form: p [..., 3] -> [...]."""
    return noise_xyz(seed, p[..., 0], p[..., 1], p[..., 2])


def turb(seed: int, p, depth: int = 7):
    """Array form: p [..., 3] -> [...]."""
    return turb_xyz(seed, p[..., 0], p[..., 1], p[..., 2], depth)
