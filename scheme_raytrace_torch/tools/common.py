"""What the instruments of tools/ share: their device, their timed windows,
the Cornell box and bench.py's fwd+bwd step.

A tool runs on the card unless it is given `--cpu` (device="cpu"), and a
card it cannot find is an error (config.resolve_device).  Every window is
timed on the host's clock between two synchronisations of the device and
fetches a value inside it, as bench.py:39-66 does; `timed_loop` also reads
CUDA events around a run of repeats, beside the host's enqueue time.
"""

from __future__ import annotations

import time

import torch

from .. import scenes
from ..config import resolve_device
from ..integrator import diff_fused
from ..scene import build as sb
from ..scene import compile_scene


def device_from(argv):
    """(argv without `--cpu`, the device it names: the CPU for `--cpu`,
    else the card)."""
    args = [a for a in argv if a != "--cpu"]
    return args, resolve_device("cpu" if "--cpu" in argv else None)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_name(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"


def cornell(dev, dtype=torch.float32):
    """The Cornell box as the JAX tools compile it: its objects and sky
    (the light is found by its material), the camera at aspect 1."""
    spec = scenes.cornell_box()
    scene = compile_scene(spec.objects, sky=spec.sky, dtype=dtype,
                          device=dev)
    return scene, spec.camera(dtype=dtype, aspect=1.0, device=dev)


def loss_of(raw):
    """bench.py's training loss: the mean of the squared radiance sums."""
    return torch.sum(raw ** 2) / raw.numel()


def fwd_bwd(params, rest, cam, config, n_iters):
    """One training step (bench.py's value_and_grad): render_diff_fused of
    `params`, the loss and every leaf's gradient (zeros where a leaf is
    unused).  Returns (loss, (segments, leftover), grads)."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    raw, segs, leftover = diff_fused.render_diff_fused(
        sb.combine(leaves, rest), cam, config, n_iters)
    loss = loss_of(raw)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(leaves.items(), grads)}
    return loss.detach(), (segs, leftover), grads


def sgd(params, grads, lr=1e-6):
    """bench.py's chaining update, params - lr * grad."""
    return {k: v - lr * grads[k] for k, v in params.items()}


def timed_loop(stage, init, k, dev, n=3):
    """Run `stage(i, carry)` k times in a row, carrying its result; return
    (seconds an iteration, the host's enqueue seconds an iteration), the
    best of n runs after a warm-up.  On the card the first is read by CUDA
    events around the k repeats: when the host's enqueue is the longer, the
    device waited on the host and the number is the host's.  On the CPU
    both are the host's wall."""

    def run():
        c = init
        for i in range(k):
            c = stage(i, c)
        return c

    float(run().reshape(-1)[0])                    # warm-up
    best, best_host = float("inf"), float("inf")
    for _ in range(n):
        sync(dev)
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
        t0 = time.perf_counter()
        c = run()
        host = time.perf_counter() - t0
        if dev.type == "cuda":
            b.record()
            b.synchronize()
            elapsed = a.elapsed_time(b) / 1e3
        else:
            elapsed = host
        float(c.reshape(-1)[0])
        best, best_host = min(best, elapsed / k), min(best_host, host / k)
    return best, best_host


def host_note(dt, host, dev) -> str:
    """What a timed_loop line adds: the enqueue time, and whose time the
    number is."""
    if dev.type != "cuda":
        return "  [CPU wall]"
    note = f"  [host enqueue {host * 1e3:.3f} ms"
    return note + ("; host-bound: the number is the host's]" if host >= dt
                   else "]")
