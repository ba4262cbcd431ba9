"""Headline benchmark of the port: Cornell box 512x512 with mixture-PDF
light sampling (BASELINE config 4), rays/s on the card.

The port of the repository's root `bench.py`, function for function.  It
prints ONE JSON line with bench.py's keys ("metric", "value", "unit",
"vs_baseline", "fwd_bwd_rays_per_s", "fwd_bwd_workload", "step_impl",
"fwd_bwd_step_impl", "fwd_1024_rays_per_s", "n_chips") and one more,
"card": nvidia-smi's name and power limit of the card ("CPU" under
`--cpu`).  "rays" counts traced path segments (camera rays and every
bounce), exactly, by the pool's segment counter.  Three measurements, each
a warm-up and 5 timed runs with a value fetched inside every window:

  * the forward render, 512^2 spp16 depth 100, through `render_pool_auto`
    (on the card the persistent pool, K4; on the CPU the FIFO pool), the
    renders chained through their state;
  * the training step at spp8: `render_diff_fused` (K1 forward, the
    backward kernel K2), the loss sum(raw^2)/numel and every leaf's
    gradient, the parameters chained by p - 1e-6 g between steps;
  * the forward render at 1024^2 spp16, which `render_pool_auto` splits
    into 4 row bands of 256 rows.

`vs_baseline` keeps bench.py's formula, value / (1e8 / 8 * n_chips):
BASELINE.json's north-star target of 1e8 rays/s on eight chips, prorated
per chip.  It is a target, not a rate any device has reached.  `n_chips`
is torch.cuda.device_count(), every visible card, though the bench renders
on one, as bench.py divides by jax.device_count(); 1 under `--cpu`.

It runs on the card, and on the CPU only when given `--cpu` (64^2 spp1 and
no 1024^2 render: `fwd_1024_rays_per_s` is null, as bench.py's off the
TPU).  With no card and no `--cpu` it raises.  bench.py's fallbacks are
not ported: the port has no `use_pallas` to retry without, and a kernel
that fails to build or launch, a step that does not drain, a black frame
or, on the card, a step that did not run the kernels raises, and the exit
code is non-zero.  No measurement is swallowed into a null.

    python -m scheme_raytrace_torch.bench [--cpu]
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

from . import render as R
from .config import RenderConfig
from .integrator import diff_fused, pool_fused
from .scene import build as sb
from .tools.common import cornell, device_from, fwd_bwd, sgd, sync

NORTH_STAR_PER_CHIP = 1e8 / 8  # BASELINE.json's target: 1e8 rays/s, 8 chips
N_TIMED = 5                    # timed renders or steps after the warm-up


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def _ms(times):
    return [round(t * 1e3, 1) for t in times]


def _measure_forward(scene, cam, config, label="fwd"):
    """(rays/s, segments) of the pool forward render, median of 5.

    The timed renders chain the accumulation state, as progressive
    rendering does, so every call has new inputs, and each window ends in
    a value fetched from the device.  The segments are the last render's
    exact count; the log line adds the warm-up render's (from zeros,
    sample_base 0) segments and iterations."""
    st, seg, iters = R.render_with_stats(
        scene, cam, config, R.init_state(config, device=scene.device))
    warm_seg, warm_iters = int(seg), int(iters)
    if not float(st.raw_sum.max()) > 0.0:
        raise RuntimeError("render produced a black frame")
    times = []
    for _ in range(N_TIMED):
        t0 = time.perf_counter()
        st, seg, iters = R.render_with_stats(scene, cam, config, st)
        float(st.raw_sum[0, 0, 0])
        times.append(time.perf_counter() - t0)
    if not bool(torch.isfinite(st.raw_sum).all()):
        raise RuntimeError("render produced a non-finite frame")
    seg, med = int(seg), statistics.median(times)
    _log(f"bench[{label}]: {config.nx}x{config.ny} spp{config.spp} "
         f"m={config.resolve_pool_rays()} segs={seg} iters={int(iters)} "
         f"times_ms={_ms(times)} median={med * 1e3:.1f}ms -> "
         f"{seg / med / 1e6:.1f}M rays/s; warm-up segs={warm_seg} "
         f"iters={warm_iters}")
    return seg / med, seg


def _drained(leftover, when):
    if int(leftover) != 0:
        raise RuntimeError(f"fwd+bwd pool did not drain ({when}): "
                           f"{int(leftover)} lanes or pixels left over; "
                           f"raise n_iters")


def _measure_fwd_bwd(scene, cam, config):
    """(fwd+bwd rays/s, segments): the training step through the
    reverse-mode pool (integrator/diff_fused: the forward pool's estimator
    and RNG), median of 5.  "rays" counts the step's FORWARD path segments,
    the forward bench's unit; the time includes the whole backward pass.

    slack 1.1 (below the library's 1.25): the bench renders one seed and
    moves the parameters by 1e-6 g between steps, so the calibrated trip
    count barely moves; every step's drain is checked.  The update runs
    outside the window under no_grad, and the device is synchronised
    before the timer starts, so no launch of the update lands in the
    window (bench.py blocks on the chained params for the same reason)."""
    if not diff_fused.supported(scene, config):
        raise RuntimeError("fwd+bwd bench scene not covered by the diff pool")
    n_iters = diff_fused.calibrate_iters(scene, cam, config, slack=1.1)
    params, rest = sb.partition(scene)
    dev = scene.device
    loss, (segs, leftover), grads = fwd_bwd(params, rest, cam, config,
                                            n_iters)
    float(loss)
    _drained(leftover, "warm-up")
    times, peaks = [], []
    for _ in range(N_TIMED):
        with torch.no_grad():
            params = sgd(params, grads)
        sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        loss, (segs, leftover), grads = fwd_bwd(params, rest, cam, config,
                                                n_iters)
        sync(dev)
        float(loss)
        times.append(time.perf_counter() - t0)
        if dev.type == "cuda":
            peaks.append(torch.cuda.max_memory_allocated(dev))
        _drained(leftover, "a timed step")
    # a graph kept across steps would grow each step's peak
    if peaks and peaks[-1] > 1.05 * peaks[0]:
        raise RuntimeError(f"the fifth step's peak memory {peaks[-1]} B "
                           f"exceeds the first's {peaks[0]} B")
    segs, med = int(segs), statistics.median(times)
    peak = (f"; peak_gib={[round(p / 2 ** 30, 3) for p in peaks]}"
            if peaks else "")
    _log(f"bench[fwd+bwd]: {config.nx}x{config.ny} spp{config.spp} "
         f"m={config.resolve_pool_rays(reverse=True)} segs={segs} "
         f"n_iters={n_iters} times_ms={_ms(times)} median={med * 1e3:.1f}ms"
         f" -> {segs / med / 1e6:.1f}M rays/s{peak}")
    return segs / med, segs


def card_line(dev) -> str:
    """nvidia-smi's name and power limit of the (first) card, or "CPU"."""
    if dev.type != "cuda":
        return "CPU"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def main(argv=None):
    args, dev = device_from(sys.argv[1:] if argv is None else argv)
    if args:
        raise SystemExit(f"bench: unexpected arguments {args}; usage: "
                         f"python -m scheme_raytrace_torch.bench [--cpu]")
    on_card = dev.type == "cuda"
    n_chips = torch.cuda.device_count() if on_card else 1
    size = 512 if on_card else 64
    spp = 16 if on_card else 1
    # pool_rays stays automatic (64k forward, 24k reverse lanes)
    config = RenderConfig(nx=size, ny=size, spp=spp, max_depth=100,
                          light_sampling=True, seed=0)
    scene, cam = cornell(dev)

    fwd_rays_s, _ = _measure_forward(scene, cam, config)
    step_impl = pool_fused.LAST_STEP_IMPL["forward"]

    # fwd+bwd at full frame and half spp, the full 100-bounce cap
    bwd_cfg = config.replace(spp=max(1, spp // 2))
    bwd_rays_s, _ = _measure_fwd_bwd(scene, cam, bwd_cfg)
    bwd_impl = pool_fused.LAST_STEP_IMPL["reverse"]

    # the large frame: render_pool_auto's row bands at full size
    big_rays_s = None
    if on_card:
        big_rays_s, _ = _measure_forward(
            scene, cam, config.replace(nx=1024, ny=1024), label="fwd-1024")
        if (step_impl, bwd_impl) != ("persistent", "cuda"):
            raise RuntimeError(f"the card ran the {step_impl} / {bwd_impl} "
                               f"step, not the kernels")

    print(json.dumps({
        "metric": "rays/s (path segments, Cornell 512x512 light-sampled)"
                  if on_card else "rays/s (path segments, Cornell 64x64, CPU)",
        "value": fwd_rays_s,
        "unit": "rays/s",
        "vs_baseline": fwd_rays_s / (NORTH_STAR_PER_CHIP * n_chips),
        "fwd_bwd_rays_per_s": bwd_rays_s,
        "fwd_bwd_workload": f"{bwd_cfg.nx}x{bwd_cfg.ny} spp{bwd_cfg.spp} "
                            f"depth{bwd_cfg.max_depth}",
        "step_impl": step_impl,
        "fwd_bwd_step_impl": bwd_impl,
        "fwd_1024_rays_per_s": big_rays_s,
        "n_chips": n_chips,
        "card": card_line(dev),
    }), flush=True)


if __name__ == "__main__":
    main()
