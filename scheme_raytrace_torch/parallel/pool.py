"""Sharded regeneration-pool rendering: the fast forward path over a mesh.

The port of scheme_raytrace_tpu/parallel/pool.py.  Each rank runs its own
regeneration pool (integrator/pool.py) over its shard of the frame; the
scene and camera are replicated, and the forward pass needs no collective
until the shards are combined.  Work-item RNG is keyed by GLOBAL (pass,
pixel) ids, so the sharded render equals the unsharded one bit for bit:
each pixel gets the same samples, summed in the same order.

`render_pool_sharded` gives each rank a contiguous band of rows;
`render_pool_balanced` interleaves the pixels over the ranks, so that a
frame whose cost sits in a few rows (a fractal, a cheap sky) still splits
evenly, at the price of one all-reduce of the frame.
"""

from __future__ import annotations

import torch

from .. import config as cfg_mod
from ..camera import Camera
from ..integrator import bounce, pool_fused
from ..integrator.pool import render_pool_auto
from . import distributed as pdist


def _raw0(config, raw0, scene):
    if raw0 is None:
        return torch.zeros((config.n_pixels, 3), dtype=config.torch_dtype,
                           device=scene.device)
    return raw0.reshape(config.n_pixels, 3)


def _combine(mesh, segments, iters, device):
    """Segments summed over the ranks, iterations their maximum (the
    drain-limited straggler's)."""
    segments = pdist.all_sum(segments.reshape(1), mesh.group)[0]
    iters = pdist.all_max(torch.tensor([iters], dtype=torch.int64,
                                       device=device), mesh.group)
    return segments, int(iters[0])


def render_pool_balanced(scene, cam: Camera, config: cfg_mod.RenderConfig,
                         mesh, raw0=None, sample_base=0):
    """Load-balanced sharded pool render: rank s renders the interleaved
    pixels k * n + s of the whole frame, and the partial frames are summed
    by one all-reduce.  The sum is exact: each pixel has one owner and the
    other ranks add 0.0.  Returns (raw [ny,nx,3], segments, iters) with
    iters the maximum over the ranks, the straggler bound the balance
    minimises."""
    n = mesh.size
    assert config.n_pixels % n == 0, (
        f"frame pixels {config.n_pixels} must divide over {n} ranks "
        "(the work unit is a pixel)")
    assert bounce.supported(scene, config), (
        "balanced mode runs the fused pool; scene not covered")
    raw0 = _raw0(config, raw0, scene)
    raw, segments, iters = pool_fused.render_pool_fused(
        scene, cam, config, torch.zeros_like(raw0), sample_base, pix0=0,
        total_pix=config.n_pixels, item_stride=n, item_offset=mesh.rank)
    raw = pdist.all_sum(raw, mesh.group)
    segments, iters = _combine(mesh, segments, iters, raw.device)
    return (raw0 + raw).reshape(config.ny, config.nx, 3), segments, iters


def render_pool_sharded(scene, cam: Camera, config: cfg_mod.RenderConfig,
                        mesh, raw0=None, sample_base=0):
    """Pool-render the frame with rows sharded over the mesh: rank s renders
    rows [s * ny / n, (s + 1) * ny / n) in one drain (a shard never bands,
    whatever its size) and the bands are gathered onto every rank.

    Returns (raw [ny,nx,3] radiance sums, segments, iters) like
    render.render_with_stats, segments summed and iters the maximum over
    the ranks; raw0 ([ny,nx,3], the whole frame) resumes an accumulation."""
    n = mesh.size
    assert config.ny % n == 0, (
        f"ny={config.ny} must divide evenly over {n} ranks")
    local_pix = config.ny // n * config.nx
    pix0 = mesh.rank * local_pix
    raw0 = _raw0(config, raw0, scene)
    raw, segments, iters = render_pool_auto(
        scene, cam, config, raw0[pix0:pix0 + local_pix], sample_base,
        pix0=pix0, total_pix=config.n_pixels, bands=False)
    raw = pdist.assemble_image(raw, mesh.group)
    segments, iters = _combine(mesh, segments, iters, raw.device)
    return raw.reshape(config.ny, config.nx, 3), segments, iters
