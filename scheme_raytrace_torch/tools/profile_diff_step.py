"""Decompose the fwd+bwd pool step's cost on the card.

The port of tools/profile_diff_step.py.  Three loops of the length and
pool of the bench's fwd+bwd workload (Cornell light-sampled, 512^2 spp8
depth 100, m = 24,576, n_iters from `calibrate_iters(slack=1.1)`), each
timed forward-only and under autograd (the gradient of the squared output
with respect to every float leaf):

  kernel  the pool's reverse step alone (`pool_fused.pool_step`: K1
          forward and K2 backward on the card, `BounceStep`), carried
          state, every lane fresh every iteration, no pool glue;
  glue    the port's pool glue (integrator/pool_fused.py's loop, out of
          place as in reverse mode) with the framebuffer flush, its
          `index_add` into [n_pix + m, 3], replaced by a [3] reduction of
          the finished pixels' sums (every staged value stays live for
          autograd);
  full    the committed render_diff_fused (the flush included).

full - glue = the flush; glue - kernel = the glue; kernel = the kernels'
floor with their launches.  Each number is the best of 5 windows after a
warm-up, each ending in a synchronised, fetched value.

    python -m scheme_raytrace_torch.tools.profile_diff_step [m] [--cpu]
"""

from __future__ import annotations

import sys
import time

import torch

from ..config import RenderConfig
from ..integrator import bounce, diff_fused, pool_fused
from ..scene import build as sb
from .common import cornell, device_from, loss_of, sync


def _timed(fn, label, dev, segs_ref, reps):
    fn()
    best = float("inf")
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        float(fn())
        sync(dev)
        best = min(best, time.perf_counter() - t0)
    print(f"{label:28s} {best * 1e3:8.1f} ms"
          + (f"  ({segs_ref / best / 1e6:5.1f}M rays/s-equiv)"
             if segs_ref else ""), flush=True)
    return best


def run(m=24 * 1024, size=512, spp=8, max_depth=100, device=None, reps=5):
    """Print the JAX tool's lines; return {label: best seconds},
    segments and n_iters."""
    config = RenderConfig(nx=size, ny=size, spp=spp, max_depth=max_depth,
                          light_sampling=True, seed=0, pool_rays=m)
    scene, cam = cornell(device)
    dev, dtype = scene.device, torch.float32
    n_iters = diff_fused.calibrate_iters(scene, cam, config, slack=1.1)
    print(f"m={m} n_iters={n_iters}", flush=True)

    params, rest = sb.partition(scene)
    plan = bounce.pool_plan(scene, config)
    step = pool_fused.pool_step(dev, reverse=True)
    n_pix = config.n_pixels
    i64 = dict(dtype=torch.int64, device=dev)

    def kernel_only(params):
        pk = bounce.pack(sb.combine(params, rest), cam, plan, dtype)
        z = torch.zeros(m, dtype=dtype, device=dev)
        one = torch.ones_like(z)
        item = torch.arange(m, **i64)
        px = (item % config.nx).to(dtype)
        py = (torch.div(item, config.nx, rounding_mode="floor")
              % config.ny).to(dtype)
        fresh = alive = torch.ones(m, dtype=torch.bool, device=dev)
        depth = torch.zeros(m, dtype=torch.int32, device=dev)
        o, d, t, rad, tp = (z, z, z), (z, z, one), z, (z, z, z), (one,) * 3
        acc = torch.zeros((), dtype=dtype, device=dev)
        for i in range(n_iters):
            gitem = bounce.wrap_i32(i * m + item)
            o, d, t, rad, tp, _ = step(plan, pk, gitem, px, py, fresh,
                                       alive, depth, o, d, t, rad, tp)
            acc = acc + rad[0].sum() + rad[1].sum() + rad[2].sum()
        return acc

    def glue_no_scatter(params):
        # pool_fused.render_pool_fused's reverse-mode loop, whole frame,
        # the flush into raw replaced by a [3] reduction
        pk = bounce.pack(sb.combine(params, rest), cam, plan, dtype)
        lane = torch.arange(m, **i64)
        item = lane.clone()
        alive = lane < n_pix
        fresh = alive.clone()
        pass_idx = torch.zeros(m, **i64)
        depth = torch.zeros(m, dtype=torch.int32, device=dev)
        pixg = item % n_pix
        px = (pixg % config.nx).to(dtype)
        py = torch.div(pixg, config.nx, rounding_mode="floor").to(dtype)
        z = torch.zeros(m, dtype=dtype, device=dev)
        o, d, time_ = (z, z, z), (z, z, torch.ones_like(z)), z
        rad, tp = (z, z, z), (z, z, z)
        acc = torch.zeros(m, 3, dtype=dtype, device=dev)
        red = torch.zeros(3, dtype=dtype, device=dev)
        next_w = torch.full((), m, **i64)
        segments = torch.zeros((), **i64)
        n_blocks = -(-n_iters // pool_fused.FLUSH_EVERY)
        for _ in range(n_blocks * pool_fused.FLUSH_EVERY):
            gitem = bounce.wrap_i32(pass_idx * n_pix + pixg)
            o, d, time_, rad, tp, scattering = step(
                plan, pk, gitem, px, py, fresh, alive, depth, o, d, time_,
                rad, tp)
            path_done = alive & ~scattering
            acc = acc + torch.where(path_done[:, None],
                                    torch.stack(rad, 1), 0.0)
            pixel_done = path_done & (pass_idx >= spp - 1)
            more = path_done & ~pixel_done
            red = red + torch.where(pixel_done[:, None], acc, 0.0).sum(0)
            acc = torch.where(pixel_done[:, None], 0.0, acc)
            done_i = pixel_done.to(torch.int64)
            new_local = next_w + torch.cumsum(done_i, 0) - done_i
            has_work = pixel_done & (new_local < n_pix)
            item = torch.where(has_work, new_local, item)
            pass_idx = torch.where(more, pass_idx + 1,
                                   torch.where(has_work, 0, pass_idx))
            fresh = more | has_work
            pixg = item % n_pix
            px = torch.where(fresh, (pixg % config.nx).to(dtype), px)
            py = torch.where(fresh, torch.div(
                pixg, config.nx, rounding_mode="floor").to(dtype), py)
            depth = torch.where(scattering, depth + 1,
                                torch.where(fresh, 0, depth))
            segments = segments + alive.sum()
            alive = scattering | fresh
            next_w = torch.clamp(next_w + done_i.sum(), max=n_pix)
        return red.sum()

    def full(params):
        raw, _, _ = diff_fused.render_diff_fused(sb.combine(params, rest),
                                                 cam, config, n_iters)
        return loss_of(raw)

    # segments for the rays/s-equivalents
    with torch.no_grad():
        _, segs, lo = diff_fused.render_diff_fused(scene, cam, config,
                                                   n_iters)
    segs_ref = int(segs)
    print(f"segs={segs_ref} leftover={int(lo)}", flush=True)
    assert int(lo) == 0

    def grad_of(fn):
        def vg():
            leaves = {k: v.detach().requires_grad_()
                      for k, v in params.items()}
            out = torch.sum(fn(leaves) ** 2)
            g = torch.autograd.grad(out, list(leaves.values()),
                                    allow_unused=True)
            return sum(x.reshape(-1)[0] for x in g if x is not None)
        return vg

    out = dict(segments=segs_ref, n_iters=n_iters)
    for label, fn in [("kernel", kernel_only), ("glue", glue_no_scatter),
                      ("full", full)]:
        with torch.no_grad():
            out[f"{label} fwd"] = _timed(lambda fn=fn: fn(params),
                                         f"{label} fwd", dev, segs_ref, reps)
        out[f"{label} fwd+bwd"] = _timed(grad_of(fn), f"{label} fwd+bwd",
                                         dev, segs_ref, reps)
    return out


def main(argv=None):
    args, dev = device_from(sys.argv[1:] if argv is None else argv)
    run(int(args[0]) if args else 24 * 1024, device=dev)


if __name__ == "__main__":
    main()
