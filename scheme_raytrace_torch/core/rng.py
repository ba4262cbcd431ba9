"""The port's two random streams: the counter-based PCG4D hash of the
regeneration pool, and threefry2x32 keys of the differentiable wavefront.

PCG4D is bit-exact with scheme_raytrace_tpu/core/rng.py (`_pcg4d`, `_to_unit`,
`hash_uniforms_tuple`, `hash_uniforms`): every draw is keyed by the
(seed, work-item, depth, column-group) counter, never by pool iteration, so
renders are resumable and band/shard invariant.  The CUDA bounce kernel
(csrc/bounce_step.cu) runs the same recurrence in uint32.

torch's uint32 is only partly supported, so the host form keeps each uint32
in an int64 masked to 32 bits: `>>` on a non-negative int64 is a logical
shift, and products are split into 16-bit halves so no int64 overflows.

The threefry half (`root_key`, `fold_in`, `split`, `random_bits`,
`uniform`, `bounce_key`) is bitwise `jax.random` under JAX's
`jax_threefry_partitionable` layout (the default of JAX 0.5 on): `split` is
the fold-like split, and `random_bits` hashes the 64-bit flat index of
each element, split into its high and low 32-bit words.  A key is a `[2]`
int64 tensor of two uint32 words; a `[..., 2]` batch of keys draws as
`jax.vmap` over them would, one result per key.
"""

from __future__ import annotations

import math

import torch

from ..config import resolve_device

# Stable per-call-site salts of the wavefront's threefry draws (pixel jitter,
# lens disk, ray time, scatter, dielectric branch, medium distance, light,
# mixture, russian roulette), the JAX package's values.
SITE_PIXEL_JITTER = 1
SITE_LENS = 2
SITE_TIME = 3
SITE_SCATTER = 4
SITE_DIELECTRIC = 5
SITE_MEDIUM = 6
SITE_LIGHT = 7
SITE_MIX = 8
SITE_RR = 9

_M32 = 0xFFFFFFFF
_PCG_MULT = 1664525
_PCG_ADD = 1013904223
_INV_2_24 = 1.0 / float(1 << 24)

CAMERA_DEPTH = 0xFFFF     # `depth` tag for camera-ray generation draws
GROUP_SHADE = 0           # column groups 0..3: the shade() uniform matrix
GROUP_MEDIUM = 8          # column groups 8+: per-medium scatter distances
GROUP_RR = 0x80           # russian-roulette continuation draw


def _mul32(a, b):
    """(a * b) mod 2**32 for int64 tensors holding uint32 values."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _pcg4d(a, b, c, d):
    """One PCG4D round: 4 uint32 counters (as int64) -> 4 uint32."""
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
    d = d ^ (d >> 16)
    a = (a + _mul32(b, d)) & _M32
    b = (b + _mul32(c, a)) & _M32
    c = (c + _mul32(a, b)) & _M32
    d = (d + _mul32(b, c)) & _M32
    return a, b, c, d


def _to_unit(bits, dtype):
    """uint32 -> [0, 1) float from the top 24 bits (exact in f32 and f64)."""
    return (bits >> 8).to(dtype) * _INV_2_24


def _as_u32(x, like):
    """int32 tensor or Python int -> int64 tensor of its uint32 bit pattern."""
    x = torch.as_tensor(x, device=like.device)
    return torch.broadcast_to(x.to(torch.int64) & _M32, like.shape)


def hash_uniforms_tuple(seed: int, item, depth, ncols: int,
                        dtype=torch.float32, group_base: int = 0):
    """Tuple of `ncols` [N] uniform columns keyed by (seed, item, depth, group).

    item: int32 tensor of absolute work-item ids (negative values are their
    wrapped uint32 patterns); depth: int or int tensor (CAMERA_DEPTH for
    camera-ray draws); group_base offsets the column-group counter.
    """
    item = torch.as_tensor(item)
    it = item.to(torch.int64) & _M32
    dp = _as_u32(depth, it)
    seed_u = torch.full_like(it, seed & _M32)
    cols = []
    for g in range((ncols + 3) // 4):
        grp = torch.full_like(it, (group_base + g) & _M32)
        cols.extend(_pcg4d(it, dp, grp, seed_u))
    return tuple(_to_unit(c, dtype) for c in cols[:ncols])


def hash_uniforms(seed: int, item, depth, ncols: int, dtype=torch.float32,
                  group_base: int = 0):
    """[N, ncols] uniforms; the stacked form of `hash_uniforms_tuple`."""
    return torch.stack(hash_uniforms_tuple(seed, item, depth, ncols, dtype,
                                           group_base), dim=-1)


# ---------------------------------------------------------------------------
# threefry2x32 keys (the differentiable wavefront's stream)
# ---------------------------------------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_F64_MANTISSA = (1 << 52) - 1
_F64_ONE_BITS = 0x3FF0000000000000
_F32_ONE_BITS = 0x3F800000


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash of the counters (x0, x1) under the key (k0, k1).

    Every argument is an int64 tensor (or Python int) of uint32 values, all
    broadcast together; returns the two uint32 output words.  Five groups
    of four rounds (add, rotate left, xor) with the key schedule injected
    after each group, as jax._src.prng's lowering."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _M32
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & _M32
    return x0, x1


def root_key(seed: int, device=None):
    """jax.random.key(seed): the key (seed >> 32, seed & 0xFFFFFFFF) on
    `device` (None: the card, config.resolve_device)."""
    return torch.tensor([(seed >> 32) & _M32, seed & _M32],
                        dtype=torch.int64, device=resolve_device(device))


def fold_in(key, data):
    """jax.random.fold_in: hash `data` (an int, or an int tensor that
    broadcasts against the key batch key.shape[:-1]) under the key."""
    if torch.is_tensor(data):
        data = data.to(torch.int64) & _M32
    else:
        data &= _M32
    return torch.stack(threefry2x32(key[..., 0], key[..., 1], 0, data), -1)


def _counts(shape, device):
    """The 64-bit flat index of every element of `shape` as its (high, low)
    32-bit words (jax._src.prng.iota_2x32_shape)."""
    i = torch.arange(math.prod(shape), dtype=torch.int64,
                     device=device).reshape(shape)
    return i >> 32, i & _M32


def _hash(key, shape):
    """threefry of the flat counters of `shape` under each key of the batch
    key.shape[:-1]: two word tensors of shape key.shape[:-1] + shape."""
    hi, lo = _counts(tuple(shape), key.device)
    pad = (...,) + (None,) * len(shape)
    return threefry2x32(key[..., 0][pad], key[..., 1][pad], hi, lo)


def split(key, n: int = 2):
    """jax.random.split (fold-like): n keys, [..., n, 2]."""
    return torch.stack(_hash(key, (n,)), -1)


def random_bits(key, width: int, shape):
    """jax.random.bits: 32-bit words are bits1 ^ bits2, 64-bit words
    (bits1 << 32) | bits2 (an int64 holding the uint64's bit pattern)."""
    b1, b2 = _hash(key, shape)
    if width == 32:
        return b1 ^ b2
    if width == 64:
        return (b1 << 32) | b2
    raise ValueError(f"random_bits: width 32 or 64, got {width}")


def uniform(key, shape, dtype=torch.float32, lo=0.0, hi=1.0):
    """jax.random.uniform: the top mantissa bits of a random word ORed into
    1.0's bits, minus 1, scaled into [lo, hi) and floored at lo.  Bitwise
    JAX's on [0, 1), the range the port draws; on another range the scale
    rounds twice where XLA on the CPU fuses it into one FMA (an ulp off)."""
    shape = tuple(shape)
    if dtype == torch.float64:
        bits = random_bits(key, 64, shape)
        # `>>` on the int64 is arithmetic: mask the sign's copies off
        bits = ((bits >> 12) & _F64_MANTISSA) | _F64_ONE_BITS
        floats = bits.view(torch.float64) - 1.0
    elif dtype == torch.float32:
        bits = (random_bits(key, 32, shape) >> 9) | _F32_ONE_BITS
        floats = bits.to(torch.int32).view(torch.float32) - 1.0
    else:
        raise ValueError(f"uniform: float32 or float64, got {dtype}")
    if lo == 0.0 and hi == 1.0:
        return floats          # floats * 1 + 0, floored at 0: the same bits
    lo_t = torch.tensor(lo, dtype=dtype, device=floats.device)
    hi_t = torch.tensor(hi, dtype=dtype, device=floats.device)
    return torch.maximum(lo_t, floats * (hi_t - lo_t) + lo_t)


def bounce_key(key, bounce, site):
    """Key of one call site within one bounce: fold_in(fold_in(key,
    bounce), site).  `site` may be a [S] tensor of sites: [..., S, 2]."""
    kb = fold_in(key, bounce)
    if torch.is_tensor(site) and site.dim():
        kb = kb[..., None, :]
    return fold_in(kb, site)
