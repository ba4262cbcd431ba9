"""The strided pools' framebuffer flush at the default frame, on the card.

Cornell with light sampling at 200 x 200 spp16 depth 100 (config.py's
default frame; m = 65,536 lanes, g = gcd(m, n_pix) = 64), forward, f32,
through the FIFO pool (`pool_fused.render_pool_fused`), the strided pool
and the persistent pool: a warm-up render from zeros, then N chained
renders, each timed with a value fetched inside its window, and each image
held to the FIFO pool's (the same segments; rtol = atol = 1e-5 of its
largest value, the strided pools' rule).  Then one more render of each
strided pool with its flush counted: every `pool_strided.Framebuffer.add`
call, its staged rows, its host time and, on the card, its kernels, read
by torch.profiler (device events) around that call alone.

It prints one JSON line: the card, the frame, m and g, and per pool the
minimum, median and maximum ms, the segments and iterations, and for the
strided pools the flush's calls, rows, kernels a row and host ms a render.
It calls nothing that the pools' older form lacked, so it runs unchanged
against an older tree of the port (copied into its `tools/`).

    python -m scheme_raytrace_torch.tools.bench_flush [--cpu] [size spp N]
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import sys
import time

import torch

from ..config import RenderConfig, resolve_device
from ..integrator import persist, pool_fused, pool_strided
from .common import cornell, device_from, device_name, sync

POOLS = {"fifo": pool_fused.render_pool_fused,
         "strided": pool_strided.render_pool_strided,
         "persistent": persist.render_pool_persistent}


def _device_kernels(fn, dev):
    """fn()'s result and the device kernels it ran (None on the CPU)."""
    if dev.type != "cuda":
        return fn(), None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        sync(dev)
    return out, sum(e.device_type == DeviceType.CUDA for e in prof.events())


@contextlib.contextmanager
def counted_flush(dev, kernels=False):
    """Count every Framebuffer flush in the block: calls, rows, host
    seconds and (with `kernels`, on the card) device kernels."""
    fb = pool_strided.Framebuffer
    stats = dict(calls=0, rows=0, host_s=0.0,
                 kernels=0 if kernels and dev.type == "cuda" else None)
    add = fb.add

    def counted(self, rows, *args, **kw):
        # a [T, m] pixel block, or (an older tree) an iterable of rows
        rows = rows if torch.is_tensor(rows) else list(rows)
        stats["calls"] += 1
        stats["rows"] += len(rows)
        t0 = time.perf_counter()
        if stats["kernels"] is None:
            out = add(self, rows, *args, **kw)
        else:
            out, n = _device_kernels(lambda: add(self, rows, *args, **kw), dev)
            stats["kernels"] += n
        stats["host_s"] += time.perf_counter() - t0
        return out

    fb.add = counted
    try:
        yield stats
    finally:
        fb.add = add


def _render(fn, scene, cam, cfg, raw, base):
    out = fn(scene, cam, cfg, raw, base)
    float(out[0][0, 0])             # the value fetched inside the window
    return out


def run(size=200, spp=16, n_timed=3, device=None):
    """Print the JSON line; return it as a dict."""
    dev = resolve_device(device)
    scene, cam = cornell(dev)
    cfg = RenderConfig(nx=size, ny=size, spp=spp, max_depth=100, seed=0,
                       light_sampling=True)
    n_pix = cfg.n_pixels
    m = pool_strided.pool_size(cfg, n_pix * spp)
    out = dict(card=device_name(dev), size=size, spp=spp, m=m,
               g=math.gcd(m, n_pix), pools={})
    raw0 = torch.zeros(n_pix, 3, device=dev)
    ref = None
    for name, fn in POOLS.items():
        raw, segs, iters = _render(fn, scene, cam, cfg, raw0, 0)
        first, first_segs = raw, int(segs)
        times, base = [], 0
        for _ in range(n_timed):
            base += spp
            t0 = time.perf_counter()
            raw, segs, iters = _render(fn, scene, cam, cfg, raw, base)
            times.append((time.perf_counter() - t0) * 1e3)
        rec = dict(min_ms=min(times), median_ms=statistics.median(times),
                   max_ms=max(times), times_ms=times, segments=first_segs,
                   iters=int(iters))
        if ref is None:
            ref = (first, first_segs)
        else:
            want, want_segs = ref
            err = (first - want).abs()
            lim = 1e-5 * float(want.abs().max()) + 1e-5 * want.abs()
            rec["image_outside_1e-5"] = int((err > lim).sum())
            if first_segs != want_segs or rec["image_outside_1e-5"] or \
                    not bool(torch.isfinite(first).all()):
                raise AssertionError(f"{name}: segments {first_segs} (FIFO "
                                     f"{want_segs}), image off the FIFO "
                                     f"pool's: {rec}")
            with counted_flush(dev, kernels=True) as flush:
                _render(fn, scene, cam, cfg, raw0, 0)
            with counted_flush(dev) as host:
                _render(fn, scene, cam, cfg, raw0, 0)
            rec["flush"] = dict(
                calls=flush["calls"], rows=flush["rows"],
                kernels=flush["kernels"],
                kernels_per_row=(None if flush["kernels"] is None
                                 else flush["kernels"] / flush["rows"]),
                host_ms=host["host_s"] * 1e3)
        out["pools"][name] = rec
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    args, dev = device_from(sys.argv[1:] if argv is None else argv)
    size, spp, n = (int(a) for a in (args + ["200", "16", "3"][len(args):]))
    run(size, spp, n, dev)


if __name__ == "__main__":
    main()
