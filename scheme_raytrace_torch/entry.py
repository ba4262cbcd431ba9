"""Entry points: the flagship forward pass and the multi-device dry run.

The port of the repository's root `__graft_entry__.py`.  `entry()` returns
the flagship workload's forward sample pass (the Cornell box with
mixture-PDF light sampling, BASELINE config 4) through
`render.render_pass`: the wavefront, which launches no kernel, as JAX's
runs no Pallas kernel.  `dryrun_multichip(n)` runs ONE sharded step on
tiny shapes over n ranks: `render_sharded`, then `train_step` (the
wavefront's forward + backward + gradient all-reduce), then
`calibrate_iters_sharded` + `train_step_fused` (the reverse-mode pool; on
the card its bounces are the K1 forward and K2 backward kernels).

JAX's dry run takes the first n devices of one process's mesh; torch runs
a rank a device (parallel/mesh.py).  n <= torch.cuda.device_count() runs
on the cards over NCCL: n = 1 in this process, more in n processes, rank r
on card r.  device="cpu" runs n gloo processes on the CPU
(`parallel.distributed.spawn`), the counterpart of JAX's virtual CPU
mesh.  Nothing falls back to the CPU by itself.

    python -m scheme_raytrace_torch.entry [n] [--cpu]
"""

from __future__ import annotations

import sys

import torch

from . import config as cfg_mod
from . import render as R
from . import scenes
from .config import RenderConfig
from .parallel import distributed as pdist
from .scene import compile_scene
from .scene.build import partition


def _flagship(nx=64, ny=64, spp=1, max_depth=8, device=None):
    spec = scenes.cornell_box()
    scene = compile_scene(spec.objects, sky=spec.sky, device=device)
    cam = spec.camera(aspect=nx / ny, device=device)
    config = RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=max_depth,
                          light_sampling=True)
    return scene, cam, config


def entry(device=None):
    """(fn, example_args): one forward sample pass on Cornell, on `device`
    (None: the card)."""
    scene, cam, config = _flagship(device=device)
    state = R.init_state(config, device=scene.device)

    def fn(scene, cam, state):
        return R.render_pass(scene, cam, config, state, 0)

    return fn, (scene, cam, state)


def _dryrun_rank(mesh, n_devices):
    """One rank's share of dryrun_multichip: its assertions, and the
    (loss, fused loss) every rank reads after the all-reduce."""
    from .parallel import (calibrate_iters_sharded, render_sharded,
                           train_step, train_step_fused)
    ny = 2 * n_devices                      # rows divide evenly over the mesh
    scene, cam, config = _flagship(nx=16, ny=ny, spp=1, max_depth=2,
                                   device=mesh.device)

    # forward sharded render
    img = render_sharded(scene, cam, config, mesh)
    assert img.shape == (ny, 16, 3), img.shape

    # full training step: grads over every float scene param, all-reduced
    params, rest = partition(scene)
    target = torch.zeros((ny, 16, 3), dtype=img.dtype, device=img.device)
    _, loss = train_step(params, rest, cam, config, target, mesh)
    assert bool(torch.isfinite(loss)), f"non-finite training loss: {loss}"

    # fast path: sharded reverse-mode pool (fwd+bwd per shard + all-reduce)
    n_iters = calibrate_iters_sharded(scene, cam, config, mesh)
    _, loss_f, leftover = train_step_fused(params, rest, cam, config,
                                           target, mesh, n_iters)
    assert bool(torch.isfinite(loss_f)), (
        f"non-finite fused training loss: {loss_f}")
    assert int(leftover) == 0, f"fused diff pool under-drained: {leftover}"
    return float(loss), float(loss_f)


def dryrun_multichip(n_devices: int, device=None):
    """Run ONE sharded training step (fwd + bwd + all-reduce) on tiny
    shapes over n_devices ranks; print the JAX line and return
    (loss, fused loss).

    device=None (or a CUDA device) runs on the cards and needs n_devices of
    them; device="cpu" runs n_devices gloo processes on the CPU."""
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if on_cpu:
        loss, loss_f = pdist.spawn(_dryrun_rank, n_devices, n_devices)[0]
    else:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_devices > cards:
            raise RuntimeError(
                f"dryrun_multichip({n_devices}): {cards} CUDA devices here; "
                f"a rank takes a card, so pass device=\"cpu\" to run "
                f"{n_devices} gloo processes on the CPU")
        if n_devices == 1:
            with pdist.single_process(cfg_mod.resolve_device(device)) as mesh:
                loss, loss_f = _dryrun_rank(mesh, 1)
        else:
            loss, loss_f = pdist.spawn(_dryrun_rank, n_devices, n_devices,
                                       device="cuda")[0]
    print(f"dryrun_multichip({n_devices}): ok, loss={loss:.6f}, "
          f"fused loss={loss_f:.6f}", flush=True)
    return loss, loss_f


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    dryrun_multichip(int(args[0]) if args else 1,
                     device="cpu" if "--cpu" in sys.argv else None)
