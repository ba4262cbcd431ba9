"""Measure framebuffer-flush strategies of the regeneration pool on the
card.

The port of tools/profile_scatter.py, on the port's tensors: each variant
runs K = 50 times in a row with its carried buffer, queued between two
CUDA events (with the host's enqueue time beside, common.timed_loop).

  (a)  index_add_ of M rows into [n_pix, 3]   (the FIFO pool's flush)
  (a2) index_add_ of M/8 rows                  (cost against index count)
  (a3) index_add_ of the rows sorted (they are unique: 97 is prime to
       n_pix); XLA's sorted/unique hints have no torch counterpart
  (b)  dense one-hot flush into a [M, C, 3] per-lane sequence buffer
  (c)  dense elementwise add into [M, 3] (a lane-aligned framebuffer)
  (d)  the general pool's lane-ordered `pool.flush_add_` of the same M
       rows into [n_pix + M, 3] (ranks, then rounds of unique rows)

    python -m scheme_raytrace_torch.tools.profile_scatter [--cpu]
"""

from __future__ import annotations

import sys

import torch

from ..config import resolve_device
from ..integrator import pool
from .common import device_from, host_note, timed_loop

K = 50


def run(m=128 * 1024, n_pix=512 * 512, k=K, device=None):
    """Print a line a variant; return {variant: (seconds an iteration,
    host enqueue seconds)}."""
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    lane = torch.arange(m, dtype=torch.int64, device=dev)
    pix = (lane * 97) % n_pix
    pix_sorted = torch.sort(pix).values
    mask = lane % 7 == 0
    raw = torch.zeros((n_pix, 3), **f32)

    def a(i, raw):
        vals = torch.where(mask[:, None], 1.0 + i, 0.0).expand(m, 3)
        return raw.index_add_(0, pix, vals)

    m8 = m // 8

    def a2(i, raw):
        return raw.index_add_(0, pix[:m8], torch.full((m8, 3), 1.0 + i, **f32))

    def a3(i, raw):
        return raw.index_add_(0, pix_sorted,
                              torch.full((m, 3), 1.0 + i, **f32))

    def seq_flush(c):
        k_col = (lane * 13) % 32 % c

        def b(i, seq):
            onehot = (torch.arange(c, device=dev)[None, :]
                      == k_col[:, None]).to(torch.float32)
            vals = torch.where(mask, 1.0 + i, 0.0)
            return seq + onehot[:, :, None] * vals[:, None, None]
        return b

    def c(i, fb):
        vals = torch.where(mask[:, None], 1.0 + i, 0.0)
        return fb + vals.expand(m, 3)

    def d(i, raw):
        vals = torch.where(mask[:, None], 1.0 + i, 0.0).expand(m, 3)
        return pool.flush_add_(raw, pix, vals, mask)

    out = {}
    for name, fn, init in [
        ("(a) scatter-add M rows", a, raw),
        ("(a2) scatter-add M/8 rows", a2, raw.clone()),
        ("(a3) scatter-add sorted", a3, raw.clone()),
        ("(b) one-hot seq C=32", seq_flush(32), torch.zeros((m, 32, 3), **f32)),
        ("(b8) one-hot seq C=8", seq_flush(8), torch.zeros((m, 8, 3), **f32)),
        ("(c) dense lane add", c, torch.zeros((m, 3), **f32)),
        ("(d) pool.flush_add_ M rows", d, torch.zeros((n_pix + m, 3), **f32)),
    ]:
        dt, host = timed_loop(fn, init, k, dev)
        out[name] = (dt, host)
        print(f"{name:>28}: {dt * 1e3:8.3f} ms" + host_note(dt, host, dev),
              flush=True)
    return out


def main(argv=None):
    _, dev = device_from(sys.argv[1:] if argv is None else argv)
    run(device=dev)


if __name__ == "__main__":
    main()
