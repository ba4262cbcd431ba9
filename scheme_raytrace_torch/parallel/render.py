"""Sharded rendering and the data-parallel training steps over a mesh.

The port of scheme_raytrace_tpu/parallel/render.py.  The image rows shard
over the mesh's ranks (parallel/mesh.py: a rank is a shard); the scene and
camera are replicated.  The forward pass needs no collective until the
rows are gathered; a training step (inverse rendering: fit scene
parameters to a target image) all-reduces the parameter gradients, the
only traffic between ranks, as BASELINE prescribes ("shard rays and
tiles, replicate scene parameters, all-reduce parameter gradients").

JAX's `train_step` gets its gradient psum from AD (the transpose of the
replicated-to-varying cast of the parameters) and its `train_step_fused`
psums explicitly.  Here both reduce explicitly, exactly once: the loss and
every gradient go in one flat buffer a step (DDP's bucket), summed by one
all-reduce.
"""

from __future__ import annotations

import torch

from .. import config as cfg_mod
from ..camera import Camera, get_rays
from ..core import rng
from ..integrator import pool_fused
from ..integrator.wavefront import trace_rays
from ..scene import build as sb
from ..utils import telemetry
from . import distributed as pdist


def _check_rows(config, mesh):
    assert config.ny % mesh.size == 0, (
        f"ny={config.ny} must divide evenly over {mesh.size} ranks")
    return config.ny // mesh.size


def _pass_rows(scene, cam, config, pass_idx, shard_idx, rows, dtype):
    """Render `rows` image rows starting at shard_idx * rows: [rows, nx, 3].
    The keys are fold_in(fold_in(root_key(seed), pass), shard) split in 3,
    as JAX's."""
    key = rng.fold_in(rng.fold_in(rng.root_key(config.seed, scene.device),
                                  pass_idx), shard_idx)
    k_jit, k_lens, k_trace = rng.split(key, 3).unbind(-2)

    n = rows * config.nx
    idx = torch.arange(n, device=scene.device)
    ys = torch.div(idx, config.nx, rounding_mode="floor") + shard_idx * rows
    xs = idx % config.nx
    xi = rng.uniform(k_jit, (n, 2), dtype)
    u = (xs.to(dtype) + xi[:, 0]) / config.nx
    v = (ys.to(dtype) + xi[:, 1]) / config.ny
    o, d, time = get_rays(cam, u, v, k_lens)
    radiance = trace_rays(scene, o, d, time, k_trace, config)
    return radiance.reshape(rows, config.nx, 3)


def _mean_image_local(scene, cam, config, rows, dtype, shard_idx):
    """config.spp passes of shard `shard_idx`'s rows: the mean frame."""
    acc = torch.zeros((rows, config.nx, 3), dtype=dtype, device=scene.device)
    for i in range(config.spp):
        acc = acc + _pass_rows(scene, cam, config, i, shard_idx, rows, dtype)
    return acc / config.spp


def render_sharded(scene, cam: Camera, config: cfg_mod.RenderConfig, mesh):
    """Full-frame mean radiance [ny,nx,3] through the wavefront, rows
    sharded over the mesh and gathered onto every rank."""
    rows = _check_rows(config, mesh)
    img = _mean_image_local(scene, cam, config, rows, config.torch_dtype,
                            mesh.rank)
    return pdist.assemble_image(img, mesh.group)


def calibrate_iters_sharded(scene, cam: Camera,
                            config: cfg_mod.RenderConfig, mesh,
                            slack: float = 1.25) -> int:
    """Static trip count for `train_step_fused`: one sharded forward pool
    render at the REVERSE-mode pool size measures the maximum drain count
    over the ranks (each runs the same fixed count, so the slowest sizes
    it), times `slack` (integrator/diff_fused.calibrate_iters)."""
    from .pool import render_pool_sharded

    config = config.replace(
        pool_rays=config.resolve_pool_rays(reverse=True))
    with torch.no_grad():
        _, _, iters = render_pool_sharded(scene, cam, config, mesh)
    return int(-(-int(iters) * slack // 1))


def _sgd(params, leaves, loss, mesh, lr):
    """The step's one reduction: the local loss and every leaf's gradient
    in one flat buffer, summed over the ranks; then params -= lr * grad.
    Returns (new_params, global loss)."""
    names = list(leaves)
    with telemetry.span("train.autograd"):
        grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                    allow_unused=True)
    grads = [torch.zeros_like(leaves[k]) if g is None else g
             for k, g in zip(names, grads)]
    with telemetry.span("train.allreduce"):
        flat = pdist.all_sum(torch.cat([loss.detach().reshape(1)]
                                       + [g.reshape(-1) for g in grads]),
                             mesh.group)
    new_params, at = {}, 1
    for k in names:
        p = params[k]
        g = flat[at:at + p.numel()].reshape(p.shape)
        new_params[k] = p.detach() - lr * g
        at += p.numel()
    return new_params, flat[0]


def _leaves(params):
    return {k: v.detach().clone().requires_grad_() for k, v in params.items()}


def train_step_fused(params, rest_scene, cam: Camera,
                     config: cfg_mod.RenderConfig, target, mesh,
                     n_iters: int, lr: float = 1e-2):
    """Training step through the reverse-mode regeneration pool, sharded.

    The multi-rank form of integrator/diff_fused: each rank runs the
    fixed-trip pool (`static_iters=n_iters`) over its band of rows, on the
    card through the K1 forward and K2 backward kernels
    (`bounce.step_cuda_vjp`); the loss is the band's squared error over the
    WHOLE frame's count; loss, gradients and `leftover` are summed over the
    ranks.  target: [ny,nx,3], the whole frame (each rank reads its rows).

    Returns (new_params, loss, leftover); `leftover` MUST be checked: a
    nonzero value means n_iters did not drain some rank's queue and the
    image and gradient miss that work (integrator/diff_fused)."""
    with telemetry.span("train.step", unit=True):
        return _train_step_fused(params, rest_scene, cam, config, target,
                                 mesh, n_iters, lr)


def _train_step_fused(params, rest_scene, cam, config, target, mesh,
                      n_iters, lr):
    rows = _check_rows(config, mesh)
    local_pix = rows * config.nx
    pix0 = mesh.rank * local_pix
    leaves = _leaves(params)
    scene = sb.combine(leaves, rest_scene)
    raw0 = torch.zeros((local_pix, 3), dtype=config.torch_dtype,
                       device=scene.device)
    raw, _, leftover = pool_fused.render_pool_fused(
        scene, cam, config, raw0, 0, pix0=pix0, total_pix=config.n_pixels,
        static_iters=n_iters)
    img = (raw / config.spp).reshape(rows, config.nx, 3)
    tgt = target[mesh.rank * rows:(mesh.rank + 1) * rows]
    loss = torch.sum((img - tgt) ** 2) / (config.ny * config.nx * 3)
    new_params, loss = _sgd(params, leaves, loss, mesh, lr)
    with telemetry.span("train.allreduce"):
        leftover = pdist.all_sum(leftover.reshape(1), mesh.group)[0]
    return new_params, loss, leftover


def train_step(params, rest_scene, cam: Camera, config: cfg_mod.RenderConfig,
               target, mesh, lr: float = 1e-2):
    """One inverse-rendering SGD step through the wavefront's scan: L2 image
    loss, the gradients summed over the ranks.

    params and rest_scene from `scene.build.partition`; target [ny,nx,3],
    the whole frame (each rank reads its rows).  Returns (new_params,
    loss)."""
    rows = _check_rows(config, mesh)
    dcfg = config.replace(differentiable=True)
    leaves = _leaves(params)
    scene = sb.combine(leaves, rest_scene)
    img = _mean_image_local(scene, cam, dcfg, rows, config.torch_dtype,
                            mesh.rank)
    tgt = target[mesh.rank * rows:(mesh.rank + 1) * rows]
    loss = torch.sum((img - tgt) ** 2) / (config.ny * config.nx * 3)
    return _sgd(params, leaves, loss, mesh, lr)
