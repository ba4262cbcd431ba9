"""Regeneration pool over the fused SoA bounce step (integrator/bounce.py).

The forward (drain) form of scheme_raytrace_tpu/integrator/pool_fused.py.
A pool of M lanes; each lane renders all `spp` jittered paths of one pixel
in turn, sums the pixel's passes in-lane in pass order starting from 0.0,
adds the finished sum to the framebuffer once, and is re-issued the next
pixel at once, so occupancy stays near 100% until the frame drains.  The
RNG key of a path is its global (pass, pixel) id,

    gitem = (sample_base + pass) * total_pix + pixel   (int32, wrapping),

so the image is band- and resume-invariant and equals the JAX pool's.

What differs from the JAX module:
  * the work unit is one pixel (the JAX pool's K=1).  Its K-pixel groups,
    [S, K, M] staging buffers and batched every-F scatter exist to cut TPU
    scatter slots; here a finished pixel's sum goes straight into the
    framebuffer with `index_add_`.  Indices are unique within an iteration
    (lanes that did not finish a pixel add to their own spill row past the
    frame), so the result is deterministic.  The image and the exact
    segment count do not depend on K; only the iteration count does.
  * the drain loop is a Python loop that checks `alive.any()` (a host
    sync) every FLUSH_EVERY iterations; the extra iterations after the
    drain are no-ops, as in the JAX while_loop.
  * the framebuffer and the in-lane pixel sums are updated in place.
  * the step is picked by the device: CUDA tensors go through the kernel
    (`bounce.step_cuda`), CPU tensors through the plain `bounce.step`.

With `static_iters` the pool runs a fixed number of iterations with no host
sync: the reverse-mode form (integrator/diff_fused.py), the JAX module's
fixed-length scan.  Every update there is out of place, so nothing autograd
saves is changed later; on the card the step is `bounce.step_cuda_vjp`
(the K1 forward and K2 backward kernels), on the CPU the plain `step`
under torch autograd.

While a torch profiler records, the pool is traced (utils/telemetry): the
span `pool` around a call, `pool.iter` around an iteration, inside it
`pool.launch` around the step and `pool.fold`, `pool.reissue`,
`pool.reissue.lanes` and `pool.reissue.state` around the glue (each short
enough for a trace's idle gaps to be named after it), and
`pool.drain_check` around the host sync; the counters `pool.segments` and `pool.lane_slots` (iterations times
lanes) give the pool's occupancy.
"""

from __future__ import annotations

import torch

from ..utils import telemetry
from . import bounce

FLUSH_EVERY = 8     # bounce iterations between drain checks (host syncs)

# The step the most recent fused pool call ran, by direction:
# {"forward": "cuda"|"persistent"|"plain", "reverse": "cuda"|"plain"} (the
# JAX module's pallas / jnp record): "cuda" for the kernels K1 (and K2 in
# reverse) of this pool, "persistent" for K4 through
# persist.render_pool_persistent (the card's routed forward frame), "plain"
# for the plain PyTorch step of either.  It records what ran and selects
# nothing.
LAST_STEP_IMPL: dict = {}


def _pixel_of(item, n_pix, stride, offset):
    """Local frame pixel of a work item: the item itself by default; with
    stride = n and offset = shard, local item k is pixel k * n + shard, the
    interleave of parallel.pool's balanced mode.  The modulo only keeps
    dead padding lanes (item >= n_work) inside the frame."""
    return (item * stride + offset) % n_pix


def pool_step(device, reverse=False):
    """The bounce step the pool runs on `device`: on the card the kernel K1
    (`bounce.step_cuda`; in reverse `step_cuda_vjp`, K1 forward and K2
    backward), on the CPU the plain `bounce.step`."""
    if device.type == "cuda":
        return bounce.step_cuda_vjp if reverse else bounce.step_cuda
    return bounce.step


def render_pool_fused(scene, cam, config, raw0, sample_base, pix0=0,
                      total_pix=None, static_iters=None, item_stride=1,
                      item_offset=0):
    """Trace config.spp passes over raw0's pixels; return (raw, segments,
    iters), or (raw, segments, leftover) with `static_iters`.

    raw0: [n_pix, 3] running radiance sums (the whole frame, or a row band
    whose first pixel is `pix0` of a `total_pix`-pixel frame).
    sample_base: passes already in raw0 (int or 0-d integer tensor); it
    offsets the RNG keys so a resumed render draws fresh samples.
    segments: exact count of path segments traced (0-d int64 tensor);
    iters: pool iterations run, i.e. step launches (Python int).
    static_iters: run exactly ceil(static_iters / FLUSH_EVERY) blocks of
    FLUSH_EVERY iterations at the reverse-mode pool size, out of place and
    with no host sync; leftover (0-d int64 tensor) counts the lanes still
    alive plus the pixels never issued, and must be 0 for a whole image.
    item_stride, item_offset: render only the pixels k * item_stride +
    item_offset of raw0 (the interleaved shard of parallel.pool's balanced
    mode); the others keep raw0's values.
    """
    with telemetry.span("pool"):
        return _render(scene, cam, config, raw0, sample_base, pix0, total_pix,
                       static_iters, item_stride, item_offset)


def _render(scene, cam, config, raw0, sample_base, pix0, total_pix,
            static_iters, item_stride, item_offset):
    n_pix = raw0.shape[0]
    total_pix = config.n_pixels if total_pix is None else total_pix
    spp = config.spp
    plan = bounce.pool_plan(scene, config)
    dev, dtype = raw0.device, raw0.dtype
    reverse = static_iters is not None
    step = pool_step(dev, reverse)
    LAST_STEP_IMPL["reverse" if reverse else "forward"] = (
        "plain" if step is bounce.step else "cuda")

    pool_cap = max(128, config.resolve_pool_rays(reverse=reverse)
                   // 128 * 128)
    assert n_pix % item_stride == 0, (n_pix, item_stride)
    n_work = n_pix // item_stride              # local pixels
    m = max(128, min(pool_cap, (n_work + 127) // 128 * 128))
    pk = bounce.pack(scene, cam, plan, dtype)

    i64 = dict(dtype=torch.int64, device=dev)
    lane = torch.arange(m, **i64)
    item = lane.clone()                        # pixel (local) of each lane
    alive = lane < n_work
    fresh = alive.clone()
    pass_idx = torch.zeros(m, **i64)
    depth = torch.zeros(m, dtype=torch.int32, device=dev)
    pixg = pix0 + _pixel_of(item, n_pix, item_stride, item_offset)
    px = (pixg % config.nx).to(dtype)
    py = torch.div(pixg, config.nx, rounding_mode="floor").to(dtype)
    z = torch.zeros(m, dtype=dtype, device=dev)
    o, d, time = (z, z, z), (z, z, torch.ones_like(z)), z
    rad, tp = (z, z, z), (z, z, z)
    acc = torch.zeros(m, 3, dtype=dtype, device=dev)   # in-lane pixel sums
    next_w = torch.full((), m, **i64)
    segments = torch.zeros((), **i64)
    base = torch.as_tensor(sample_base, device=dev).to(torch.int64)
    # rows [0, n_pix): the frame; row n_pix + lane: that lane's spill row
    raw = torch.cat([raw0, raw0.new_zeros(m, 3)])
    spill = n_pix + lane

    iters = 0
    while True:
        for _ in range(FLUSH_EVERY):
            with telemetry.span("pool.iter"):
                gitem = bounce.wrap_i32((base + pass_idx) * total_pix + pixg)
                with telemetry.span("pool.launch"):
                    o, d, time, rad, tp, scattering = step(
                        plan, pk, gitem, px, py, fresh, alive, depth,
                        o, d, time, rad, tp)

                # --- fold the finished path into its pixel's sum ------------
                with telemetry.span("pool.fold"):
                    path_done = alive & ~scattering
                    folded = torch.where(path_done[:, None],
                                         torch.stack(rad, 1), 0.0)
                    pixel_done = path_done & (pass_idx >= spp - 1)
                    more = path_done & ~pixel_done   # next pass, same pixel
                    dest = torch.where(pixel_done, pixg - pix0, spill)
                    if reverse:
                        acc = acc + folded
                        raw = raw.index_add(0, dest, acc)
                        acc = torch.where(pixel_done[:, None], 0.0, acc)
                    else:
                        acc += folded
                        raw.index_add_(0, dest, acc)
                        acc.masked_fill_(pixel_done[:, None], 0.0)

                # --- re-issue freed lanes the next pixels ------------------
                with telemetry.span("pool.reissue"):
                    done_i = pixel_done.to(torch.int64)
                    new_local = next_w + torch.cumsum(done_i, 0) - done_i
                    has_work = pixel_done & (new_local < n_work)
                    item = torch.where(has_work, new_local, item)
                    pass_idx = torch.where(more, pass_idx + 1,
                                           torch.where(has_work, 0, pass_idx))
                    fresh = more | has_work
                with telemetry.span("pool.reissue.lanes"):
                    pixg = pix0 + _pixel_of(item, n_pix, item_stride,
                                            item_offset)
                    px = torch.where(fresh, (pixg % config.nx).to(dtype), px)
                    py = torch.where(fresh, torch.div(
                        pixg, config.nx, rounding_mode="floor").to(dtype), py)
                with telemetry.span("pool.reissue.state"):
                    depth = torch.where(scattering, depth + 1,
                                        torch.where(fresh, 0, depth))
                    if reverse:
                        segments = segments + alive.sum()
                    else:
                        segments += alive.sum()
                    alive = scattering | fresh
                    next_w = torch.clamp(next_w + done_i.sum(), max=n_work)
                iters += 1
        if reverse:
            if iters >= static_iters:
                leftover = alive.sum() + (n_work - next_w)
                _count(segments, iters, m)
                return raw[:n_pix], segments, leftover
        else:
            with telemetry.span("pool.drain_check"):
                drained = not bool(alive.any())
            if drained:
                break
    _count(segments, iters, m)
    return raw[:n_pix], segments, iters


def _count(segments, iters, m):
    """The traced counters of one pool call: its exact segments (a 0-d
    device tensor, read at snapshot time) and its lane slots, iterations
    times lanes: their ratio is the pool's occupancy."""
    telemetry.add("pool.segments", segments)
    telemetry.add("pool.lane_slots", iters * m)
