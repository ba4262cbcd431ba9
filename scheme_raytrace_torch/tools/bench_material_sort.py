"""Material-sorted shading against masked shading in the general pool, on
the card.

The port of tools/bench_material_sort.py: the general pool's
(`pool.render_pool`, plain PyTorch, no kernel) forward rays/s with masked
shading (the default) and with material-sorted shading
(RenderConfig.material_sort=True: rank the lanes by the hit material's
kind, shade, unsort; bitwise the same estimator) on test_scene
(main.scm:155-174: four material kinds interleaved) and the RTOW final
scene (random_scene, main.scm:31-89: three kinds over ~500 prims), both
under the gradient sky, at 256^2 spp4 depth 8 (32^2 on the CPU); each a
warm-up and three renders timed up to a fetched value.

    python -m scheme_raytrace_torch.tools.bench_material_sort [--cpu]
"""

from __future__ import annotations

import sys
import time

import torch

from .. import scenes
from ..config import RenderConfig, resolve_device
from ..integrator import pool as pool_mod
from ..scene import compile_scene
from .common import device_from

SCENES = [("test_scene", scenes.test_scene),
          ("rtow_final", scenes.random_scene)]


def bench(scene, cam, config):
    """Segments over the median wall of three renders of the general pool
    (sample bases spp, 2 spp, 3 spp after a warm-up at 0)."""
    raw0 = torch.zeros((config.n_pixels, 3), dtype=torch.float32,
                       device=scene.device)
    raw, seg, _ = pool_mod.render_pool(scene, cam, config, raw0, 0)
    float(raw[0, 0])
    times = []
    for i in range(3):
        t0 = time.perf_counter()
        raw, seg, _ = pool_mod.render_pool(scene, cam, config, raw0,
                                           (i + 1) * config.spp)
        float(raw[0, 0])
        times.append(time.perf_counter() - t0)
    return int(seg) / sorted(times)[1]


def run(device=None, res=None, spp=4, max_depth=8, pool_rays=48 * 1024):
    """Print a line a scene; return {scene: (masked rays/s, sorted
    rays/s)}."""
    dev = resolve_device(device)
    res = res or (256 if dev.type == "cuda" else 32)
    cfg = RenderConfig(nx=res, ny=res, spp=spp, max_depth=max_depth,
                       pool_rays=pool_rays, seed=0)
    out = {}
    for name, spec_fn in SCENES:
        spec = spec_fn()
        scene = compile_scene(spec.objects, sky="gradient", device=dev)
        cam = spec.camera(aspect=1.0, device=dev)
        r_masked = bench(scene, cam, cfg)
        r_sorted = bench(scene, cam, cfg.replace(material_sort=True))
        print(f"{name:12s}  masked: {r_masked/1e6:8.2f}M  "
              f"sorted: {r_sorted/1e6:8.2f}M  "
              f"ratio sorted/masked: {r_sorted/r_masked:5.2f}", flush=True)
        out[name] = (r_masked, r_sorted)
    return out


def main(argv=None):
    _, dev = device_from(sys.argv[1:] if argv is None else argv)
    run(device=dev)


if __name__ == "__main__":
    main()
