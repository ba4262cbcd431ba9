"""Diagnose the spread of the fwd+bwd step's wall on the card.

The port of tools/diag_fwdbwd_variance.py: the bench's fwd+bwd workload
(Cornell light-sampled, 512^2 spp8 depth 100, m = 24,576,
`calibrate_iters(slack=1.1)`), N reps in each of three timing modes, with
the full distribution printed:

  chained  the bench loop: params updated by params -= 1e-6 * grad
           between steps, NOT synchronised before the timer (the update's
           launches can leak into the timed window);
  blocked  the same, with the device synchronised before the timer (the
           step alone);
  fixed    the same params every rep (the loss, fetched in every window,
           shows the values stay identical).

Every window ends in a synchronisation and a fetched loss; every step
must drain (leftover == 0).

    python -m scheme_raytrace_torch.tools.diag_fwdbwd_variance [reps] [--cpu]
"""

from __future__ import annotations

import sys
import time

from ..config import RenderConfig
from ..integrator import diff_fused
from ..scene import build as sb
from .common import cornell, device_from, fwd_bwd, sgd, sync


def run(reps=10, size=512, spp=8, pool=24 * 1024, max_depth=100,
        device=None):
    """Print a line a mode; return {mode: sorted seconds}, segments and
    n_iters."""
    config = RenderConfig(nx=size, ny=size, spp=spp, max_depth=max_depth,
                          light_sampling=True, seed=0, pool_rays=pool)
    scene, cam = cornell(device)
    dev = scene.device
    n_iters = diff_fused.calibrate_iters(scene, cam, config, slack=1.1)
    params0, rest = sb.partition(scene)
    loss, (segs, leftover), grads = fwd_bwd(params0, rest, cam, config,
                                            n_iters)
    float(loss)
    assert int(leftover) == 0
    segs = int(segs)
    print(f"n_iters={n_iters} segs={segs}", flush=True)

    out = dict(segments=segs, n_iters=n_iters)
    for mode in ("chained", "blocked", "fixed"):
        params, times, losses = params0, [], []
        for _ in range(reps):
            if mode != "fixed":
                params = sgd(params, grads)
                if mode == "blocked":
                    sync(dev)
            t0 = time.perf_counter()
            loss, (_, lo), grads = fwd_bwd(params, rest, cam, config,
                                           n_iters)
            sync(dev)
            losses.append(float(loss))
            times.append(time.perf_counter() - t0)
            assert int(lo) == 0
        times.sort()
        med = times[reps // 2]
        print(f"{mode:8s} min {times[0]*1e3:6.1f}ms "
              f"({segs/times[0]/1e6:5.1f}M) med {med*1e3:6.1f}ms "
              f"({segs/med/1e6:5.1f}M) max {times[-1]*1e3:6.1f}ms  all "
              f"{[f'{t*1e3:.0f}' for t in times]}", flush=True)
        if mode == "fixed":
            assert len(set(losses)) == 1, losses
        out[mode] = times
    return out


def main(argv=None):
    args, dev = device_from(sys.argv[1:] if argv is None else argv)
    run(int(args[0]) if args else 10, device=dev)


if __name__ == "__main__":
    main()
