"""BVH-against-brute crossover on the card.

The port of tools/bench_bvh_crossover.py: forward rays/s on N-sphere
grids (N = 256 / 1k / 4k / 16k) for the fused pool's brute sweep (on the
card the persistent pool's kernel K4 while the N spheres and the ground fit
bounce.MAX_FUSED_PRIMS; from N = 4,096 on, 4,097 prims, the route is the
general pool's brute sweep, as in JAX, and the line names it) and for
the general pool's flat threaded SAH-BVH walk (plain PyTorch), each a
warm-up and three chained renders timed up to a fetched value, at 256^2
spp4 depth 8 (32^2 on the CPU).  It records where the card would route;
the choice between the fused and the general pool (`render_pool_auto`)
stays the JAX package's.

    python -m scheme_raytrace_torch.tools.bench_bvh_crossover [N ...] [--cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np

from .. import render as R
from .. import scenes
from ..config import RenderConfig
from ..integrator import pool_fused
from ..scene import compile_scene
from ..scene import objects as ob
from .common import device_from

SIZES = [256, 1024, 4096, 16384]


def grid_spec(n):
    """sqrt(n) x sqrt(n) lambertian sphere grid + ground (the reference's
    line-upped-spheres, main.scm:177-191, at parameterized scale)."""
    side = int(round(n ** 0.5))
    rng = np.random.default_rng(7)
    objs = [ob.Sphere((0, -1000.0, 0), 1000.0,
                      ob.Lambertian((0.5, 0.5, 0.5)))]
    for i in range(side):
        for j in range(side):
            c = (i - side / 2 + 0.5, 0.2, j - side / 2 + 0.5)
            objs.append(ob.Sphere(c, 0.2, ob.Lambertian(
                tuple(rng.uniform(0.1, 0.9, 3)))))
    cam_kwargs = dict(lookfrom=(side * 0.9, side * 0.35, side * 0.9),
                      lookat=(0.0, 0.0, 0.0), vfov=30.0)
    return scenes.SceneSpec(objs, cam_kwargs, "gradient")


def grid_scene(n, bvh=None, device=None):
    """(scene, camera) of grid_spec(n), compiled on `device` (None: the
    card) with `bvh` None, "median" or "sah"."""
    spec = grid_spec(n)
    scene = compile_scene(spec.objects, sky="gradient", bvh=bvh,
                          device=device)
    return scene, spec.camera(aspect=1.0, device=device)


def bench(scene, cam, config, n_timed=3):
    """Segments over the median wall of n_timed chained renders."""
    st, seg, _ = R.render_with_stats(scene, cam, config,
                                     R.init_state(config,
                                                  device=scene.device))
    float(st.raw_sum[0, 0, 0])
    times = []
    for _ in range(n_timed):
        t0 = time.perf_counter()
        st, seg, _ = R.render_with_stats(scene, cam, config, st)
        float(st.raw_sum[0, 0, 0])
        times.append(time.perf_counter() - t0)
    return int(seg) / sorted(times)[len(times) // 2]


def run(sizes=SIZES, device=None, res=None, spp=4, max_depth=8,
        pool_rays=48 * 1024):
    """Print a line an N; return {N: {"brute": rays/s, "impl": ...,
    "bvh": rays/s}}.  A failing side is printed as FAILED, as JAX's."""
    out = {}
    for n in sizes:
        scene, cam = grid_scene(n, device=device)
        if res is None:
            res = 256 if scene.device.type == "cuda" else 32
        cfg = RenderConfig(nx=res, ny=res, spp=spp, max_depth=max_depth,
                           pool_rays=pool_rays,
                           seed=0)
        line, row = f"n={n:6d}", {}
        try:
            pool_fused.LAST_STEP_IMPL.clear()
            row["brute"] = bench(scene, cam, cfg)
            row["impl"] = pool_fused.LAST_STEP_IMPL.get("forward", "general")
            line += f"  fused-brute[{row['impl']}]: {row['brute']/1e6:8.2f}M"
        except Exception as e:  # noqa: BLE001 -- one side may fail alone
            line += f"  fused-brute FAILED: {type(e).__name__}: {e}"
        try:
            scene_b, cam = grid_scene(n, bvh="sah", device=device)
            row["bvh"] = bench(scene_b, cam, cfg.replace(traversal="bvh"))
            line += f"  bvh-pool: {row['bvh']/1e6:8.2f}M rays/s"
        except Exception as e:  # noqa: BLE001
            line += f"  bvh-pool FAILED: {type(e).__name__}: {e}"
        print(line, flush=True)
        out[n] = row
    return out


def main(argv=None):
    args, dev = device_from(sys.argv[1:] if argv is None else argv)
    run([int(x) for x in args] or SIZES, device=dev)


if __name__ == "__main__":
    main()
