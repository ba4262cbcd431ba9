"""Stage-level timing of the regeneration pool's hot path on the card.

The port of tools/profile_hotpath.py: Cornell light-sampled, 512^2 spp16,
m = the forward pool's width (65,536 lanes), six stages in plain PyTorch
(the general pool's modules), each run K = 50 times in a row with a
carried data dependency.  JAX runs the K repeats inside one jit, so its
number is device time; here they are queued between two CUDA events, and
the line also gives the host's enqueue time: where that is the larger, the
card waited on the host and the number is the host's.

    python -m scheme_raytrace_torch.tools.profile_hotpath [--cpu]
"""

from __future__ import annotations

import sys

import torch

from .. import config as cfg
from ..camera import get_rays_u
from ..config import RenderConfig
from ..core import rng
from ..integrator import shade
from ..integrator.hit import scene_hit
from .common import cornell, device_from, host_note, timed_loop

K = 50


def run(size=512, spp=16, max_depth=100, m=None, k=K, device=None):
    """Print a line a stage; return {stage: (seconds an iteration, host
    enqueue seconds)}."""
    config = RenderConfig(nx=size, ny=size, spp=spp, max_depth=max_depth,
                          light_sampling=True, seed=0, pool_rays=m)
    m = config.resolve_pool_rays()
    scene, cam = cornell(device)
    dev, dtype = scene.device, torch.float32
    print(f"device: {dev.type}", flush=True)

    item = torch.arange(m, dtype=torch.int64, device=dev)

    def camera_rays(item):
        u = rng.hash_uniforms(config.seed, item, rng.CAMERA_DEPTH, 5, dtype)
        pix = item % config.n_pixels
        ys = torch.div(pix, config.nx, rounding_mode="floor")
        xs = pix % config.nx
        s = (xs.to(dtype) + u[:, 0]) / config.nx
        t = (ys.to(dtype) + u[:, 1]) / config.ny
        return get_rays_u(cam, s, t, u[:, 2], u[:, 3], u[:, 4])

    o, d, t = camera_rays(item)
    u0 = rng.hash_uniforms(config.seed, item, 0, shade.N_U, dtype)
    rec0 = scene_hit(o, d, t, scene, cfg.SHADOW_EPS, cfg.BIG, None, config)
    raw = torch.zeros((config.n_pixels, 3), dtype=dtype, device=dev)
    pix = item % config.n_pixels
    mask = item % 7 == 0

    # --- stages: each folds the loop counter in so work isn't hoisted -----
    def st_rng(i, c):
        return rng.hash_uniforms(config.seed, item + i, 0, shade.N_U,
                                 dtype)[:, 0] + c * 0.0

    def st_cam(i, c):
        _, d, _ = camera_rays(item + i)
        return d[:, 0] + c * 0.0

    def st_hit(i, c):
        o2 = o.clone()
        o2[:, 0] += c[0] * 1e-30
        return scene_hit(o2, d, t, scene, cfg.SHADOW_EPS, cfg.BIG, None,
                         config).t

    def st_shade(i, c):
        u = u0.clone()
        u[:, 0] += c[0] * 1e-30
        return shade.shade(u, scene, config, d, rec0).direction[:, 0]

    def st_scatter(i, c):
        vals = torch.where(mask[:, None], c[:, None] + 1.0, 0.0)
        return raw.index_add(0, pix, vals.expand(m, 3))[:m, 0]

    def st_body(i, c):
        o2 = o.clone()
        o2[:, 0] += c[0] * 1e-30
        rec = scene_hit(o2, d, t, scene, cfg.SHADOW_EPS, cfg.BIG, None,
                        config)
        u = rng.hash_uniforms(config.seed, item + i, 0, shade.N_U, dtype)
        sc = shade.shade(u, scene, config, d, rec)
        r = raw.index_add(0, pix, torch.where(mask[:, None], sc.mult, 0.0))
        return rec.t + sc.direction[:, 0] + r[:m, 0]

    zeros = torch.zeros(m, dtype=dtype, device=dev)
    stages = [
        ("rng (12 cols)", st_rng),
        ("camera regen", st_cam),
        ("scene_hit", st_hit),
        ("shade", st_shade),
        ("fb scatter-add", st_scatter),
        ("body (hit+shade+scatter)", st_body),
    ]
    out = {}
    for name, fn in stages:
        dt, host = timed_loop(fn, zeros, k, dev)
        out[name] = (dt, host)
        print(f"{name:>26}: {dt * 1e3:8.3f} ms  "
              f"({m / dt / 1e6:8.1f} Mrays/s equivalent)"
              + host_note(dt, host, dev), flush=True)
    return out


def main(argv=None):
    _, dev = device_from(sys.argv[1:] if argv is None else argv)
    run(device=dev)


if __name__ == "__main__":
    main()
