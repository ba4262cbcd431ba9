"""fwd+bwd rays/s on the card: the training step through the K1 forward
and K2 backward kernels.

The port of tools/bench_diff.py: Cornell with light sampling, depth 100,
`calibrate_iters`, a warm-up, then 5 steps chained by
params -= 1e-6 * grad, the parameters synchronised before each timer and
`leftover == 0` asserted on every step.  Its one mode is `auto`, the
step the pool picks for the tensors' device (K1/K2 on the card, the plain
step on the CPU).  JAX's `jnp` mode (use_pallas=False, the plain step on
the TPU) has no counterpart: the port's pool takes no step from its caller,
and the config has no field to choose one.

    python -m scheme_raytrace_torch.tools.bench_diff [size spp pool mode] \
        [--cpu]
"""

from __future__ import annotations

import sys
import time

from ..config import RenderConfig
from ..integrator import diff_fused
from ..scene import build as sb
from .common import cornell, device_from, fwd_bwd, sgd, sync


def run(size=256, spp=4, pool=24 * 1024, device=None, max_depth=100,
        n_timed=5):
    """Print the JAX tool's lines; return dict(n_iters, segments, times,
    rays_per_s)."""
    config = RenderConfig(nx=size, ny=size, spp=spp, max_depth=max_depth,
                          light_sampling=True, seed=0, pool_rays=pool)
    scene, cam = cornell(device)
    dev = scene.device

    t0 = time.perf_counter()
    n_iters = diff_fused.calibrate_iters(scene, cam, config)
    print(f"calibrated n_iters={n_iters} in {time.perf_counter()-t0:.1f}s",
          flush=True)
    params, rest = sb.partition(scene)

    t0 = time.perf_counter()
    loss, (segs, leftover), grads = fwd_bwd(params, rest, cam, config,
                                            n_iters)
    float(loss)
    print(f"compile+warmup {time.perf_counter()-t0:.1f}s  leftover={int(leftover)}"
          f"  segs={int(segs)}", flush=True)
    assert int(leftover) == 0

    times = []
    for _ in range(n_timed):
        params = sgd(params, grads)
        sync(dev)                    # the update's launches stay outside
        t0 = time.perf_counter()
        loss, (segs, lo), grads = fwd_bwd(params, rest, cam, config,
                                          n_iters)
        float(loss)
        sync(dev)
        times.append(time.perf_counter() - t0)
        assert int(lo) == 0
    med = sorted(times)[len(times) // 2]
    print(f"mode=auto size={size} spp={spp} m={pool}: "
          f"{int(segs)/med/1e6:.2f}M rays/s (times "
          f"{[f'{t:.3f}' for t in times]})", flush=True)
    return dict(n_iters=n_iters, segments=int(segs), times=times,
                rays_per_s=int(segs) / med)


def main(argv=None):
    args, dev = device_from(sys.argv[1:] if argv is None else argv)
    mode = args[3] if len(args) > 3 else "auto"
    if mode != "auto":
        raise SystemExit(f"bench_diff: mode {mode!r}: the port's one mode "
                         f"is 'auto' (the pool picks its step by device)")
    run(int(args[0]) if args else 256, int(args[1]) if len(args) > 1 else 4,
        int(args[2]) if len(args) > 2 else 24 * 1024, device=dev)


if __name__ == "__main__":
    main()
