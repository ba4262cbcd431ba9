"""On-card bound for the part of the scaling loss one card can see.

The port of tools/bench_shard_overhead.py.  One card runs a world of one
rank (NCCL takes one rank a card), so two of the three sources of scaling
loss can be measured on it, the interconnect's cannot:

  1. the sharded entry points' own overhead at world 1: render_pool_sharded
     and train_step_fused (K1 forward, K2 backward) against the unsharded
     render_with_stats and render_diff_fused step on the same card, as
     median-of-5 wall ratios (--fwd, --train);
  2. the drain-tail occupancy (--tail): a shard's work shrinks as 1/N, so
     the pool's drain tail grows relatively.  The pool reports its exact
     iteration count, so occupancy(rows) = segments / (iterations * lanes)
     is read directly by rendering the row counts SIZE/1, /2, /4, /8 of an
     N-way row split; efficiency_model(N) = occupancy(SIZE/N) /
     occupancy(SIZE) bounds the tail's share of the loss.

Cornell light-sampled 512^2 spp16 depth 100 (spp8 for the step).  Prints
one JSON line only.

    python -m scheme_raytrace_torch.tools.bench_shard_overhead \
        [--fwd] [--train] [--tail] [--cpu]
"""

from __future__ import annotations

import json
import sys
import time

import torch

from .. import render as R
from ..config import RenderConfig
from ..integrator import diff_fused, pool, pool_strided
from ..parallel import (calibrate_iters_sharded, render_pool_sharded,
                        train_step_fused)
from ..parallel import distributed as pdist
from ..scene import build as sb
from .common import cornell, device_from, device_name, fwd_bwd, sync

SIZE, SPP = 512, 16
PARTS = ("--fwd", "--train", "--tail")


def _med(fn, dev, n=5):
    fn()  # warm
    ts = []
    for _ in range(n):
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[n // 2]


def run(parts=PARTS, size=SIZE, spp=SPP, max_depth=100, device=None,
        n=5):
    """Print the JSON line and return it as a dict."""
    scene, cam = cornell(device)
    dev = scene.device
    out = {"workload": f"cornell {size}x{size} spp{spp} light-sampled, "
                       f"{device_name(dev)}"}
    config = RenderConfig(nx=size, ny=size, spp=spp, max_depth=max_depth,
                          light_sampling=True, seed=0)
    with pdist.single_process(dev) as mesh1:
        # --- forward: sharded (world 1) against unsharded -------------------
        st_box = [R.init_state(config, device=dev)]

        def fwd_unsharded():
            st_box[0], _, _ = R.render_with_stats(scene, cam, config,
                                                  st_box[0])
            float(st_box[0].raw_sum[0, 0, 0])

        def fwd_sharded():
            raw, _, _ = render_pool_sharded(scene, cam, config, mesh1)
            float(raw[0, 0, 0])
        if "--fwd" in parts:
            t_plain = _med(fwd_unsharded, dev, n)
            t_shard = _med(fwd_sharded, dev, n)
            out["fwd_sharded_over_unsharded_time"] = round(
                t_shard / t_plain, 4)

        # --- training step: train_step_fused (world 1) against one card ----
        if "--train" in parts:
            _run_train(scene, cam, config.replace(spp=spp // 2), mesh1,
                       out, n)
    if "--tail" in parts:
        _run_tail(scene, cam, config, out)
    print(json.dumps(out), flush=True)
    return out


def _run_train(scene, cam, bwd_cfg, mesh1, out, n):
    dev = scene.device
    n_iters = diff_fused.calibrate_iters(scene, cam, bwd_cfg, slack=1.1)
    params, rest = sb.partition(scene)
    target = torch.zeros((bwd_cfg.ny, bwd_cfg.nx, 3), device=dev)

    def bwd_unsharded():
        loss, (_, lo), _ = fwd_bwd(params, rest, cam, bwd_cfg, n_iters)
        float(loss)
        assert int(lo) == 0
    t_bplain = _med(bwd_unsharded, dev, n)

    n_it_sh = calibrate_iters_sharded(scene, cam, bwd_cfg, mesh1, slack=1.1)

    def bwd_sharded():
        _, loss, lo = train_step_fused(params, rest, cam, bwd_cfg, target,
                                       mesh1, n_it_sh, lr=0.0)
        float(loss)
        assert int(lo) == 0
    t_bshard = _med(bwd_sharded, dev, n)
    out["train_sharded_over_unsharded_time"] = round(t_bshard / t_bplain, 4)


def _run_tail(scene, cam, config, out):
    # occupancy(rows) from the pool's exact iteration counter at the
    # per-shard frame sizes an N-way row split would produce
    occ = {}
    for ndev in (1, 2, 4, 8):
        c = config.replace(ny=config.ny // ndev)
        stn, seg, iters = R.render_with_stats(
            scene, cam, c, R.init_state(c, device=scene.device))
        if pool.routes_to_persistent(scene.device, c.torch_dtype, scene, c):
            # the persistent pool's lanes: one work item (pass, pixel) each
            m = pool_strided.pool_size(c, c.n_pixels * c.spp)
        else:
            # the FIFO pool's lane count for this frame (one pixel a lane:
            # pool_fused.render_pool_fused)
            cap = max(128, c.resolve_pool_rays() // 128 * 128)
            m = max(128, min(cap, (c.n_pixels + 127) // 128 * 128))
        occ[ndev] = int(seg) / (int(iters) * m)
    out["drain_tail_occupancy"] = {str(k): round(v, 4)
                                   for k, v in occ.items()}
    out["drain_tail_efficiency_model"] = {str(k): round(occ[k] / occ[1], 4)
                                          for k in occ}
    out["note"] = ("world 1 on one card: ratios ~1.0 mean the sharded "
                   "entry points and their collectives cost nothing there; "
                   "the drain_tail model bounds the per-shard work-shrink "
                   "loss of an N-way row split (interconnect cost is the "
                   "only unmeasured term)")


def main(argv=None):
    args, dev = device_from(sys.argv[1:] if argv is None else argv)
    run(tuple(a for a in args if a in PARTS) or PARTS, device=dev)


if __name__ == "__main__":
    main()
