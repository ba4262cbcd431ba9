"""Per-scene forward rays/s on the card (fused-path coverage).

The port of tools/bench_scenes.py.  Each scene renders through
`render.render_with_stats` (the pool `render_pool_auto` routes it to: on
the card the persistent pool, kernel K4, on the CPU the FIFO pool, or the
general pool), one warm-up and three chained renders, each timed up to a
fetched value; the line names the step that ran
(`pool_fused.LAST_STEP_IMPL`: "persistent", "cuda" or "plain", or
"general-pool").

    python -m scheme_raytrace_torch.tools.bench_scenes [scene ...] [--cpu]
"""

from __future__ import annotations

import sys
import time

from .. import render as R
from .. import scenes
from ..config import RenderConfig, resolve_device
from ..integrator import pool_fused
from ..scene import compile_scene
from .common import device_from

DEFAULT = ["cornell", "cornell_smoke", "klein", "cornell_klein",
           "bezier", "cornell_bezier"]


def bench_one(name, size=512, spp=8, device=None, max_depth=100,
              pool_rays=48 * 1024):
    """Print and return one scene's rays/s: dict(impl, segments,
    median_s, rays_per_s)."""
    dev = resolve_device(device)
    spec = scenes.SCENES[name]()
    scene = compile_scene(spec.objects, sky=spec.sky, device=dev)
    cam = spec.camera(aspect=1.0, device=dev)
    config = RenderConfig(nx=size, ny=size, spp=spp, max_depth=max_depth,
                          light_sampling=scene.n_lights > 0, seed=0,
                          pool_rays=pool_rays)
    pool_fused.LAST_STEP_IMPL.clear()
    st, seg, iters = R.render_with_stats(scene, cam, config,
                                         R.init_state(config, device=dev))
    float(st.raw_sum[0, 0, 0])
    impl = pool_fused.LAST_STEP_IMPL.get("forward", "general-pool")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        st, seg, iters = R.render_with_stats(scene, cam, config, st)
        float(st.raw_sum[0, 0, 0])
        times.append(time.perf_counter() - t0)
    med = sorted(times)[1]
    print(f"{name:18s} impl={impl:8s} {int(seg)/med/1e6:8.2f}M rays/s "
          f"({int(seg)} segs, {med*1e3:.0f} ms)", flush=True)
    return dict(impl=impl, segments=int(seg), iters=iters, median_s=med,
                rays_per_s=int(seg) / med)


def main(argv=None):
    names, dev = device_from(sys.argv[1:] if argv is None else argv)
    for n in names or DEFAULT:
        try:
            bench_one(n, device=dev)
        except Exception as e:  # noqa: BLE001 -- one line a scene, go on
            print(f"{n:18s} FAILED: {type(e).__name__}: {e}", flush=True)


if __name__ == "__main__":
    main()
