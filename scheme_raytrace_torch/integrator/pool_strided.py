"""Strided-work regeneration pool (scheme_raytrace_tpu/integrator/
pool_strided.py).

Lane L takes work items L, L+m, L+2m, ...; work item w renders pass
w // n_pix of pixel w % n_pix, so a lane re-issues itself with `item += m`
and needs no cross-lane prefix sum.  Pixel p's passes are the items
p + k n_pix (k < spp), on lanes (p + k n_pix) % m: one lane, in pass
order, only where m divides n_pix; in general the lanes congruent to p
modulo g = gcd(m, n_pix), m / g of them.  The RNG is keyed by the global
(pass, pixel) id, so the estimator is the FIFO pool's
(integrator/pool_fused.py); only the lanes' load balance differs, which
costs a longer drain tail.  This pool has no kernel of its own: each
iteration is one fused bounce (K1, `step_cuda`, on the card).  Its queue
is the one the packed and persistent pools (integrator/pool_packed.py,
integrator/persist.py) move into their kernels.

Framebuffer.  Each iteration stages one row: the pixel of every lane whose
path terminated (-1 for the others) and the lane's radiance.  Every
FLUSH_EVERY iterations (a persistent chunk: CHUNK_T) the block of rows is
added into the framebuffer one path at a time, each pixel's paths in the
reference's (iteration, lane) order, each float add with one writer: no
float atomics contend, and the image is bitwise reproducible on the card
as on the CPU.  Where g = m no two lanes of a row share a pixel: one
`index_add_` a row, lanes that finished no path adding into spill
columns past the frame, which are dropped.  Otherwise the block's
(iteration, lane) entries are ranked within their pixel by a stable sort,
and round r adds every pixel's r-th path, a gather and a masked add over
the frame.  A row holds at most m / g paths of a pixel and a pixel has
spp paths in all, so a block of T rows takes min(spp, T m / g) rounds, a
static count: no host sync.  A pixel's passes are not summed in the lane
first, as pool_fused does, so the image equals the FIFO pool's to the
grouping of the adds (rtol 1e-5 in float32), not bitwise.

`static_iters` runs ceil(static_iters / FLUSH_EVERY) blocks with no host
sync and every update out of place (the reverse-mode form): on the card
each bounce is `bounce.step_cuda_vjp` (K1 forward, K2 backward), on the
CPU the plain `step` under autograd.  The JAX module's `vary_axes` (shard
plumbing) waits for the sharded paths (ROADMAP A.14).
"""

from __future__ import annotations

import math

import torch

from . import bounce

FLUSH_EVERY = 8


def pool_size(config, n_work):
    """Lanes of a strided pool with n_work items (a multiple of 128)."""
    pool_cap = max(128, config.resolve_pool_rays() // 128 * 128)
    return max(128, min(pool_cap, (n_work + 127) // 128 * 128))


class Framebuffer:
    """The [3, n_pix] radiance sums and the ordered, race-free add of
    staged rows (see the module docstring) of a pool of m lanes over
    raw0's pixels with spp passes each."""

    def __init__(self, raw0, m, spp):
        self.n_pix = n_pix = raw0.shape[0]
        dev = raw0.device
        # lanes of one row that can finish the same pixel
        self.share = m // math.gcd(m, n_pix)
        self.spp = spp
        if self.share == 1:
            self.raw3 = torch.cat([raw0.T, raw0.new_zeros(3, m)], dim=1)
            self.spill = n_pix + torch.arange(m, device=dev)
        else:
            self.raw3 = raw0.T.contiguous()
            self.pixels = torch.arange(n_pix, device=dev)

    def rounds(self, T):
        """Adds a block of T rows takes: one a row where g = m, else the
        ranked rounds' static bound."""
        return T if self.share == 1 else min(self.spp, T * self.share)

    def add(self, pix, vals, inplace=True):
        """Add a block of T staged rows, pix [T, m] int (-1 = none) and
        vals [T, 3, m], in order; out of place (for autograd) with
        inplace=False."""
        if self.share > 1:
            self._add_ranked(pix, vals, inplace)
            return
        for p, v in zip(pix, vals):
            dest = torch.where(p >= 0, p.to(torch.int64), self.spill)
            if inplace:
                self.raw3.index_add_(1, dest, v)
            else:
                self.raw3 = self.raw3.index_add(1, dest, v)

    def _add_ranked(self, pix, vals, inplace):
        T, m = pix.shape
        n = T * m
        R = self.rounds(T)
        # entries in (iteration, lane) order, the lanes with no path last
        key = torch.where(pix >= 0, pix, self.n_pix).reshape(n)
        sk, perm = torch.sort(key, stable=True)
        # R spare slots: a round's position never runs past the block
        perm = torch.cat([perm, perm.new_zeros(R)])
        src = vals.transpose(0, 1).reshape(3, n).index_select(1, perm)
        pixels = self.pixels.to(sk.dtype)
        pos = torch.searchsorted(sk, pixels)
        end = torch.searchsorted(sk, pixels, right=True)
        raw = self.raw3
        for _ in range(R):
            # each pixel's next path, where it has one left
            more = pos < end
            if inplace:
                torch.where(more, raw + src.index_select(1, pos), raw,
                            out=raw)
            else:
                raw = torch.where(more, raw + src.index_select(1, pos), raw)
            pos = pos + 1
        self.raw3 = raw

    def image(self):
        """The [n_pix, 3] radiance sums."""
        return self.raw3[:, :self.n_pix].T.contiguous()


def render_pool_strided(scene, cam, config, raw0, sample_base, pix0=0,
                        total_pix=None, static_iters=None):
    """Trace config.spp passes over raw0's pixels; return (raw, segments,
    iters), or (raw, segments, leftover) with `static_iters`.

    raw0: [n_pix, 3] running radiance sums (the frame, or a row band whose
    first pixel is `pix0` of a `total_pix`-pixel frame); sample_base:
    passes already in raw0 (int or integer tensor).  segments: exact count
    of path segments (0-d int64 tensor); iters: pool iterations (int), a
    multiple of FLUSH_EVERY; leftover: work items not finished (0-d int64
    tensor), 0 for a whole image."""
    n_pix = raw0.shape[0]
    total_pix = config.n_pixels if total_pix is None else total_pix
    n_work = n_pix * config.spp
    m = pool_size(config, n_work)
    dev, dtype = raw0.device, raw0.dtype
    reverse = static_iters is not None
    if dev.type == "cuda":
        step = bounce.step_cuda_vjp if reverse else bounce.step_cuda
    else:
        step = bounce.step
    plan = bounce.pool_plan(scene, config)
    pk = bounce.pack(scene, cam, plan, dtype)

    item = torch.arange(m, device=dev)
    fresh = torch.ones(m, dtype=torch.bool, device=dev)
    depth = torch.zeros(m, dtype=torch.int32, device=dev)
    z = torch.zeros(m, dtype=dtype, device=dev)
    o, d, time, rad, tp = (z, z, z), (z, z, torch.ones_like(z)), z, \
        (z, z, z), (z, z, z)
    base = torch.as_tensor(sample_base, device=dev).to(torch.int64)
    fb = Framebuffer(raw0, m, config.spp)
    segments = torch.zeros((), dtype=torch.int64, device=dev)
    n_blocks = max(1, -(-int(static_iters) // FLUSH_EVERY)) if reverse else 0

    iters = 0
    while True:
        pixs, vals = [], []
        for _ in range(FLUSH_EVERY):
            alive = item < n_work
            gitem, px, py, pixl = bounce.strided_item(
                item, base, n_pix, pix0, total_pix, config.nx, dtype)
            o, d, time, rad, tp, scattering = step(
                plan, pk, gitem, px, py, fresh & alive, alive, depth,
                o, d, time, rad, tp)
            terminated = alive & ~scattering
            pixs.append(torch.where(terminated, pixl, -1))
            vals.append(torch.stack(rad))
            item = torch.where(terminated, item + m, item)
            depth = torch.where(scattering, depth + 1, 0)
            fresh = terminated
            segments = segments + alive.sum()
            iters += 1
        fb.add(torch.stack(pixs), torch.stack(vals), inplace=not reverse)
        if reverse:
            if iters >= n_blocks * FLUSH_EVERY:
                return fb.image(), segments, (item < n_work).sum()
        elif not bool((item < n_work).any()):
            return fb.image(), segments, iters
