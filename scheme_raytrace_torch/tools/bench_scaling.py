"""Scaling efficiency: the sharded pool's rays/s at world 1 and world N.

The port of tools/bench_scaling.py: the Cornell light-sampled workload
through render_pool_sharded (the persistent pool, K4, on the card) on one
rank and on N ranks, efficiency = (rays/s at N) / (N * rays/s at 1).  On the
card N is the number of cards, a rank a card over NCCL (one card: N = 1,
and the line says the efficiency is trivially 1.0); with --cpu N gloo
processes on the CPU (8, the counterpart of JAX's 8-virtual-device mesh).
Both worlds run in processes of their own (`parallel.distributed.spawn`),
so that a CPU rank has one thread in each.  Each measurement is the best of 3 renders
after a warm-up, each ending in a synchronised, fetched value.  Prints one
JSON line only.

    python -m scheme_raytrace_torch.tools.bench_scaling [--cpu]
"""

from __future__ import annotations

import json
import sys
import time

import torch

from ..config import RenderConfig, resolve_device
from ..parallel import distributed as pdist
from ..parallel import render_pool_sharded
from .common import cornell, device_from, device_name, sync

CPU_WORLD = 8


def measure(scene, cam, config, mesh, repeats=3):
    raw, seg, _ = render_pool_sharded(scene, cam, config, mesh)  # warm-up
    float(raw[0, 0, 0])
    best = float("inf")
    for _ in range(repeats):
        sync(scene.device)
        t0 = time.perf_counter()
        raw, seg, _ = render_pool_sharded(scene, cam, config, mesh)
        float(raw[0, 0, 0])
        best = min(best, time.perf_counter() - t0)
    return int(seg) / best


def _measure_rank(mesh, config):
    """One rank of the world-N measurement (spawn pickles it by name)."""
    scene, cam = cornell(mesh.device)
    return measure(scene, cam, config, mesh)


def run(device=None, n_dev=None, size=None, spp=None, pool_rays=None):
    """Print the JSON line and return it as a dict.  n_dev: the world N
    (the cards here, or CPU_WORLD gloo processes)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if n_dev is None:
        n_dev = torch.cuda.device_count() if on_card else CPU_WORLD
    config = RenderConfig(
        nx=size or (512 if on_card else 64), ny=size or (512 if on_card
                                                         else 64),
        spp=spp or (16 if on_card else 2), max_depth=100,
        light_sampling=True, seed=0,
        pool_rays=pool_rays or ((128 * 1024) if on_card else 8192))
    r1 = pdist.spawn(_measure_rank, 1, config, device=dev.type)[0]
    out = {
        "metric": f"scaling efficiency, Cornell {config.nx}x{config.ny} "
                  f"light-sampled, {device_name(dev)} x{n_dev}",
        "rays_per_s_1dev": r1,
        "n_devices": n_dev,
    }
    if n_dev > 1:
        rn = pdist.spawn(_measure_rank, n_dev, config, device=dev.type)[0]
        out["rays_per_s_ndev"] = rn
        out["value"] = rn / (n_dev * r1)
        out["unit"] = "efficiency"
        out["vs_baseline"] = out["value"] / 0.90   # north star: >90%
    else:
        out["value"] = 1.0
        out["unit"] = "efficiency (single device — trivially 1.0)"
        out["vs_baseline"] = 1.0
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    _, dev = device_from(sys.argv[1:] if argv is None else argv)
    run(device=dev)


if __name__ == "__main__":
    main()
