"""BASELINE parity harness of the port: the six canonical configs and their
gradient probes, as scheme_raytrace_tpu/parity.py defines them.

The goldens (tests/goldens/*.npz) are the JAX package's f64 oracle: the
image of each config's forward render, and d(mean image)/d(leaf[index])
for each probe by f64 central finite differences (`grad_fd`) and f64
autodiff (`grad_ad`) on a small 8x8 spp1 depth-3 differentiable render,
and by f64 autodiff on a big 16x16 one (`grad_ad_big`).  The port's
differentiable render draws the same threefry samples, so its f64
gradients hold to the goldens' to rounding, and its f32 autodiff on the
big workload to each config's `f32_grad_rtol` (tests/test_parity.py's
bound).  The configs here equal the JAX package's field by field
(tests/test_torch_parity.py).

`probe_gradients(..., "ad")` takes every probe from one backward pass,
with the scene's float leaves and the camera's fields as leaves; "fd" is
JAX's central difference, a forward render at +eps and -eps a probe.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from . import render as R
from . import scenes
from .camera import CAMERA_FIELDS, Camera
from .config import RenderConfig
from .scene import build as sb
from .scene import compile_scene
from .scene import objects as ob

GOLDEN_DIR = "tests/goldens"


@dataclasses.dataclass(frozen=True)
class Probe:
    """One gradient probe: d(mean image)/d(leaf[index])."""
    leaf: str                    # params-dict key, or "camera:<field>"
    index: Tuple[int, ...]       # index into the leaf array ( () for scalars )
    eps: float = 1e-3            # central-difference step (f64)


@dataclasses.dataclass(frozen=True)
class ParityConfig:
    name: str
    scene_fn: Callable[[], scenes.SceneSpec]
    config: RenderConfig
    nominal: str                 # the BASELINE.json wording this realizes
    # the gradient probes' render config and scene, where a config needs
    # its own (see the JAX package's parity.py for each reason)
    grad_config: Optional[RenderConfig] = None
    grad_scene_fn: Optional[Callable[[], scenes.SceneSpec]] = None
    probes: Tuple[Probe, ...] = ()
    # (y0, y1, x0, x1) pixel window of the gradient loss on the small (8x8)
    # and the big (16x16) workload: inside the object, off its silhouette
    window: Optional[Tuple[int, int, int, int]] = None
    window_big: Optional[Tuple[int, int, int, int]] = None
    # f32-AD-vs-f64-AD tolerance on the big workload
    f32_grad_rtol: float = 0.10
    # spp of the big gradient workload
    grad_spp_big: int = 32


def _grad_bezier_scene() -> scenes.SceneSpec:
    """test_bezier with a band-limited noise-textured curve: constant-albedo
    ribbon radiance has no continuous dependence on the control points
    (the B11 normal is -ray.dir), a p-dependent albedo restores it."""
    spec = scenes.test_bezier()
    objs = [o for o in spec.objects if not isinstance(o, ob.Bezier)]
    cp = np.array([[-1, 0, -1], [-0.8, 1, 1], [0.8, -1, 1], [1, 0, -1]], float)
    objs.append(ob.Bezier(cp, 0.7, ob.Lambertian(ob.NoiseTexture(2.0))))
    return scenes.SceneSpec(objs, spec.camera_kwargs, spec.sky)


def _grad_textured_scene() -> scenes.SceneSpec:
    """textured_scene with the marble probe sphere re-textured band-limited
    (NoiseTexture(0.5)): the probes differentiate the sphere's centre and
    radius through its albedo."""
    spec = scenes.textured_scene()
    objs = list(spec.objects)
    objs[1] = ob.Sphere((-1.1, 0, -1), 0.5,
                        ob.Lambertian(ob.NoiseTexture(0.5)))
    return scenes.SceneSpec(objs, spec.camera_kwargs, spec.sky)


# The two gradient workloads: FD == AD on the small one (few paths, few
# hit-boundary crossings), f32 AD == f64 AD on the big one (many paths).
_GRAD_CFG = RenderConfig(nx=8, ny=8, spp=1, max_depth=3,
                         differentiable=True)
_GRAD_CFG_BIG = RenderConfig(nx=16, ny=16, spp=32, max_depth=3,
                             differentiable=True)

PARITY_CONFIGS: List[ParityConfig] = [
    ParityConfig(
        name="config1_three_spheres",
        scene_fn=scenes.three_spheres,
        config=RenderConfig(nx=64, ny=64, spp=10, max_depth=100, seed=0),
        nominal="3-sphere Lambertian scene, 64x64, 10 spp, fixed seed "
                "(at exact BASELINE spec)",
        probes=(Probe("sph_c0", (1, 1)), Probe("sph_r", (1,)),
                Probe("tex_color", (1, 0)), Probe("camera:lookfrom", (1,)),
                Probe("camera:vfov", ())),
        window=(3, 5, 3, 5), window_big=(6, 10, 6, 10),
    ),
    ParityConfig(
        name="config2_rtow_final",
        scene_fn=lambda: scenes.random_scene(seed=0),
        config=RenderConfig(nx=64, ny=64, spp=4, max_depth=100, seed=0),
        nominal="RTOW final scene: metal + dielectric + Lambertian + moving "
                "spheres (nominal 200x200; 64x64 for the CPU oracle)",
        # the checker ground's two constant children
        probes=(Probe("tex_color", (213, 0)), Probe("tex_color", (214, 1))),
    ),
    ParityConfig(
        name="config3_textured",
        scene_fn=scenes.textured_scene,
        config=RenderConfig(nx=64, ny=64, spp=4, max_depth=100, seed=0),
        nominal="textured scene: checker + Perlin noise/marble + image "
                "texture on sphere",
        probes=(Probe("sph_c0", (1, 0), 1e-4), Probe("sph_r", (1,), 1e-4)),
        window=(3, 5, 0, 2), window_big=(6, 10, 0, 4),
        grad_scene_fn=_grad_textured_scene,
    ),
    ParityConfig(
        name="config4_cornell_light",
        scene_fn=scenes.cornell_box,
        config=RenderConfig(nx=64, ny=64, spp=8, max_depth=100, seed=0,
                            light_sampling=True),
        nominal="Cornell box + emissive light + mixture-PDF light sampling "
                "(nominal 512x512; 64x64 for the CPU oracle)",
        grad_config=_GRAD_CFG.replace(light_sampling=True),
        probes=(Probe("tex_color", (0, 0)), Probe("rect_k", (0,), 5e-2)),
    ),
    ParityConfig(
        name="config5_bezier",
        scene_fn=scenes.test_bezier,
        config=RenderConfig(nx=64, ny=64, spp=4, max_depth=100, seed=0),
        nominal="bezier scene with differentiable control points "
                "(nominal 512x512; 64x64 for the CPU oracle)",
        grad_scene_fn=_grad_bezier_scene,
        probes=(Probe("bez_cp", (0, 1, 1), 1e-3),),
        window=(3, 5, 2, 6), window_big=(7, 9, 6, 10),
        f32_grad_rtol=0.15, grad_spp_big=128,
    ),
    ParityConfig(
        name="config6_cornell_bezier",
        scene_fn=scenes.cornell_bezier,
        config=RenderConfig(nx=64, ny=64, spp=4, max_depth=100, seed=0),
        nominal="Cornell walls + fat bezier (w=10, main.scm:353-373) — "
                "image parity evidence that the Newton kernel's fat-curve "
                "t-slack (width/3 bound vs the subdivision oracle) is "
                "visually immaterial (VERDICT r2 weak #7)",
        probes=(Probe("tex_color", (0, 0)),),
    ),
]

BY_NAME = {c.name: c for c in PARITY_CONFIGS}


def build(pc: ParityConfig, dtype, for_grads: bool = False,
          big: bool = False, device=None):
    """Compile (scene, camera, config) for a parity entry at `dtype` on
    `device` (None: the card, config.resolve_device)."""
    spec = (pc.grad_scene_fn or pc.scene_fn)() if for_grads else pc.scene_fn()
    scene = compile_scene(spec.objects, sky=spec.sky, dtype=dtype,
                          device=device)
    cam = spec.camera(dtype=dtype, aspect=1.0, device=device)
    if for_grads:
        base = (_GRAD_CFG_BIG.replace(spp=pc.grad_spp_big) if big
                else _GRAD_CFG)
        config = (pc.grad_config or _GRAD_CFG)
        config = base.replace(light_sampling=config.light_sampling)
    else:
        config = pc.config
    if dtype == torch.float64:
        config = config.replace(dtype="f64")
    return scene, cam, config


def render_parity_image(pc: ParityConfig, dtype, device=None) -> np.ndarray:
    """Mean radiance image for a parity config (the committed-golden field)."""
    scene, cam, config = build(pc, dtype, device=device)
    mean, _ = R.render_image(scene, cam, config, dtype=dtype)
    return mean.cpu().numpy()


def _loss_fn(pc: ParityConfig, dtype, big: bool, device):
    """(params, camera) -> windowed mean image on a gradient config."""
    scene, cam, config = build(pc, dtype, for_grads=True, big=big,
                               device=device)
    params, rest = sb.partition(scene)
    window = pc.window_big if big else pc.window

    def loss(params, cam):
        mean, _ = R.render_image(sb.combine(params, rest), cam, config,
                                 dtype=dtype)
        if window is not None:
            y0, y1, x0, x1 = window
            mean = mean[y0:y1, x0:x1]
        return torch.mean(mean)

    return loss, params, cam


def _ad(pc, loss, params, cam):
    """Every probe from one backward pass of the loss."""
    params = {k: v.detach().clone().requires_grad_() for k, v in
              params.items()}
    cam = Camera(**{f: getattr(cam, f).detach().clone().requires_grad_()
                    for f in CAMERA_FIELDS})
    leaves = list(params.values()) + [getattr(cam, f) for f in CAMERA_FIELDS]
    grads = torch.autograd.grad(loss(params, cam), leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    by_name = dict(zip(list(params) + [f"camera:{f}" for f in CAMERA_FIELDS],
                       grads))
    out = []
    for pr in pc.probes:
        g = by_name[pr.leaf][pr.index]
        if pr.leaf == "sph_c0" and "sph_c1" in params:
            # the probe moves c1 with c0 (static spheres keep c1 == c0)
            g = g + by_name["sph_c1"][pr.index]
        out.append(float(g))
    return out


def _fd(pc, loss, params, cam, dtype):
    """Central differences: (f(eps) - f(-eps)) / (2 eps) a probe."""
    out = []
    for pr in pc.probes:
        def f(x, pr=pr):
            if pr.leaf.startswith("camera:"):
                field = pr.leaf.split(":", 1)[1]
                base = torch.zeros_like(getattr(cam, field))
                if pr.index:
                    base[pr.index] += x
                    delta = base
                else:
                    delta = base + x
                c = dataclasses.replace(
                    cam, **{field: getattr(cam, field) + delta})
                return loss(params, c)
            p = dict(params)
            p[pr.leaf] = params[pr.leaf].clone()
            p[pr.leaf][pr.index] += x
            if pr.leaf == "sph_c0" and "sph_c1" in p:
                p["sph_c1"] = params["sph_c1"].clone()
                p["sph_c1"][pr.index] += x
            return loss(p, cam)

        e = torch.tensor(pr.eps, dtype=dtype)
        with torch.no_grad():
            out.append(float((f(e) - f(-e)) / (2.0 * pr.eps)))
    return out


def probe_gradients(pc: ParityConfig, dtype, method: str,
                    big: bool = False, device=None) -> np.ndarray:
    """Per-probe d(mean image)/d(leaf[idx]) via "ad" or "fd" (central), on
    `device` (None: the card)."""
    loss, params, cam = _loss_fn(pc, dtype, big, device)
    if method == "ad":
        out = _ad(pc, loss, params, cam)
    elif method == "fd":
        out = _fd(pc, loss, params, cam, dtype)
    else:
        raise ValueError(f"method must be 'ad' or 'fd', got {method!r}")
    return np.asarray(out, np.float64)
