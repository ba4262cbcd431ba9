"""PyTorch port: the parity harness and the differentiable path's gradients
(CPU).

  * the six goldens with no JAX run: the port's f64 `probe_gradients(...,
    "ad")` on the small gradient workload against `grad_ad` within 1e-9
    relative, "fd" against `grad_fd` within 1e-6, with tests/test_parity.py's
    scale floor (5% of the config's largest |gradient|);
  * the port's `PARITY_CONFIGS` equal the JAX package's field by field, by
    name (their scenes compiled to equal arrays);
  * the differentiable render against `jax.grad`, f64, 8^2 spp1 depth 2,
    every leaf of `partition(scene)` and every camera field within 1e-9
    relative (same scale floor): cornell_smoke, cornell_klein and the RTOW
    scene with russian roulette from depth 0;
  * NaN hygiene (tests/test_grads.py's three regressions, port only): a
    shading point inside a sphere light, the full Cornell box and
    cornell_klein through the wavefront, every leaf's gradient finite;
  * `utils/checks.checked_render_image`: clean on Cornell, and raising with
    the bounce on an injected NaN albedo.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import contextlib
import dataclasses
import os

import numpy as np
import pytest
import torch

from scheme_raytrace_torch import parity
from scheme_raytrace_torch import render as t_render
from scheme_raytrace_torch import scenes as t_scenes
from scheme_raytrace_torch.camera import CAMERA_FIELDS, Camera, make_camera
from scheme_raytrace_torch.config import RenderConfig as TConfig
from scheme_raytrace_torch.scene import build as t_build
from scheme_raytrace_torch.scene import compile_scene
from scheme_raytrace_torch.scene import objects as t_ob
from scheme_raytrace_torch.utils import checks

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
GRAD_CFG = TConfig(nx=8, ny=8, spp=1, max_depth=3, differentiable=True)


def _rel(got, want):
    """|got - want| over tests/test_parity.py's scale: |want| floored at 5%
    of the largest |want|."""
    want = np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want), 0.05 * np.abs(want).max() + 1e-7)
    return np.abs(np.asarray(got) - want) / scale


# --- the six goldens ----------------------------------------------------------

@pytest.mark.parametrize("pc", parity.PARITY_CONFIGS, ids=lambda c: c.name)
def test_f64_gradients_match_goldens(pc):
    g = np.load(os.path.join(GOLDEN_DIR, f"{pc.name}.npz"))
    assert [str(p) for p in g["probes"]] == [
        f"{p.leaf}{list(p.index)}" for p in pc.probes]
    ad = parity.probe_gradients(pc, torch.float64, "ad", device="cpu")
    assert (_rel(ad, g["grad_ad"]) < 1e-9).all(), (ad, g["grad_ad"])
    fd = parity.probe_gradients(pc, torch.float64, "fd", device="cpu")
    assert (_rel(fd, g["grad_fd"]) < 1e-6).all(), (fd, g["grad_fd"])
    assert np.abs(ad).max() > 0.0


def test_parity_configs_equal_jax():
    from scheme_raytrace_tpu import parity as j_parity
    from scheme_raytrace_tpu.scene import build as j_build
    assert [c.name for c in parity.PARITY_CONFIGS] == [
        c.name for c in j_parity.PARITY_CONFIGS]
    t_fields = {f.name for f in dataclasses.fields(TConfig)}

    def cfg(c):
        return None if c is None else {
            f.name: getattr(c, f.name) for f in dataclasses.fields(c)
            if f.name in t_fields}

    def arrays(spec_fn, compile_fn, build):
        spec = spec_fn()
        kw = {} if build is j_build else dict(device="cpu")
        s = compile_fn(spec.objects, sky=spec.sky, **kw)
        return ({f: np.asarray(getattr(s, f)) for f in build._DATA_FIELDS},
                spec.camera_kwargs)

    for t, j in zip(parity.PARITY_CONFIGS, j_parity.PARITY_CONFIGS):
        for f in ("nominal", "window", "window_big", "f32_grad_rtol",
                  "grad_spp_big"):
            assert getattr(t, f) == getattr(j, f), (t.name, f)
        assert cfg(t.config) == cfg(j.config), t.name
        assert cfg(t.grad_config) == cfg(j.grad_config), t.name
        assert [dataclasses.astuple(p) for p in t.probes] == [
            dataclasses.astuple(p) for p in j.probes], t.name
        assert (t.grad_scene_fn is None) == (j.grad_scene_fn is None)
        for t_fn, j_fn in ((t.scene_fn, j.scene_fn),
                           (t.grad_scene_fn, j.grad_scene_fn)):
            if t_fn is None:
                continue
            ta, tcam = arrays(t_fn, compile_scene, t_build)
            ja, jcam = arrays(j_fn, j_build.compile_scene, j_build)
            assert tcam == jcam, t.name
            for f in t_build._DATA_FIELDS:
                np.testing.assert_array_equal(
                    ta[f], ja[f].astype(ta[f].dtype), err_msg=f"{t.name} {f}")
    for name in ("_GRAD_CFG", "_GRAD_CFG_BIG"):
        assert cfg(getattr(parity, name)) == cfg(getattr(j_parity, name))


# --- gradients against jax.grad -------------------------------------------------

@contextlib.contextmanager
def _x64():
    import jax
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _jax_grads(spec, kw):
    """jax.grad of the mean image over every leaf and camera field (f64):
    (the JAX scene's arrays, its camera's, {name: gradient})."""
    import jax
    import jax.numpy as jnp
    from scheme_raytrace_tpu import render as j_render
    from scheme_raytrace_tpu.config import RenderConfig as JConfig
    from scheme_raytrace_tpu.scene import build as j_build
    js = j_build.compile_scene(spec.objects, sky=spec.sky, dtype=jnp.float64)
    jc = spec.camera(dtype=jnp.float64, aspect=1.0)
    params, rest = j_build.partition(js)

    def loss(p, c):
        m, _ = j_render.render_image(j_build.combine(p, rest), c,
                                     JConfig(**kw), dtype=jnp.float64)
        return jnp.mean(m)
    gp, gc = jax.grad(loss, argnums=(0, 1))(params, jc)
    grads = {k: np.asarray(v) for k, v in gp.items()}
    grads.update({f"camera:{f}": np.asarray(getattr(gc, f))
                  for f in CAMERA_FIELDS})
    arrays = {f: np.asarray(getattr(js, f)) for f in j_build._DATA_FIELDS}
    meta = {f: getattr(js, f) for f in j_build._META_FIELDS}
    cam = {f: np.asarray(getattr(jc, f)) for f in CAMERA_FIELDS}
    return arrays, meta, cam, grads


def _port_grads(scene, cam, cfg):
    """autograd of the port's mean image over every leaf and camera field."""
    params, rest = t_build.partition(scene)
    params = {k: v.clone().requires_grad_() for k, v in params.items()}
    cam = Camera(**{f: getattr(cam, f).clone().requires_grad_()
                    for f in CAMERA_FIELDS})
    mean, _ = t_render.render_image(t_build.combine(params, rest), cam, cfg)
    leaves = list(params.values()) + [getattr(cam, f) for f in CAMERA_FIELDS]
    names = list(params) + [f"camera:{f}" for f in CAMERA_FIELDS]
    grads = torch.autograd.grad(mean.mean(), leaves, allow_unused=True)
    return {n: (torch.zeros_like(x) if g is None else g).numpy()
            for n, x, g in zip(names, leaves, grads)}


@pytest.mark.parametrize("name", ["cornell_smoke", "cornell_klein",
                                  "rtow_rr"])
def test_gradients_match_jax_grad_f64(name):
    from scheme_raytrace_tpu import scenes as j_scenes
    from scheme_raytrace_torch.camera import camera_from_arrays
    kw = dict(nx=8, ny=8, spp=1, max_depth=2, differentiable=True,
              dtype="f64")
    if name == "rtow_rr":
        spec = j_scenes.random_scene(seed=0)
        kw.update(russian_roulette=True, rr_start_depth=0)
    else:
        spec = j_scenes.SCENES[name]()
        kw.update(light_sampling=name == "cornell_smoke")
    with _x64():
        arrays, meta, cam, want = _jax_grads(spec, kw)
    ts = t_build.scene_from_arrays(arrays, meta, dtype=torch.float64,
                                   device="cpu")
    tc = camera_from_arrays(cam, dtype=torch.float64, device="cpu")
    got = _port_grads(ts, tc, TConfig(**kw))
    assert got.keys() == want.keys()
    top = max(np.abs(w).max() for w in want.values() if w.size)
    assert top > 0.0
    for k, w in want.items():
        assert np.isfinite(got[k]).all(), k
        scale = np.maximum(np.abs(w), 0.05 * top)
        np.testing.assert_array_less(np.abs(got[k] - w) / scale, 1e-9,
                                     err_msg=k)
    if name == "cornell_klein":
        assert np.abs(got["kl_center"]).max() > 0.0
    if name == "cornell_smoke":
        assert np.abs(got["med_neg_inv_d"]).max() > 0.0


# --- NaN hygiene (port only) ----------------------------------------------------

def _all_finite(scene, cam, cfg):
    grads = _port_grads(scene, cam, cfg)
    for name, g in grads.items():
        assert np.isfinite(g).all(), f"non-finite gradient in {name}"
    return grads


def test_no_nan_grads_shading_point_inside_sphere_light():
    objs = [t_ob.Sphere((0, -100.5, -1), 100,
                        t_ob.Lambertian((0.5, 0.5, 0.5))),
            t_ob.Sphere((0, 0.0, -1), 3.0, t_ob.DiffuseLight((4.0, 4.0, 4.0)))]
    scene = compile_scene(objs, sky="black", device="cpu")
    assert scene.n_lights == 1
    cam = make_camera((0, 0.8, 2), (0, 0, -1), vfov=60.0, aspect=1.0,
                      device="cpu")
    _all_finite(scene, cam, GRAD_CFG.replace(light_sampling=True))


def test_no_nan_grads_on_full_cornell():
    spec = t_scenes.cornell_box()
    scene = compile_scene(spec.objects, sky=spec.sky, device="cpu")
    grads = _all_finite(scene, spec.camera(aspect=1.0, device="cpu"),
                        GRAD_CFG.replace(light_sampling=True))
    assert np.abs(grads["tex_color"]).max() > 0.0


def test_no_nan_grads_on_cornell_klein_wavefront():
    spec = t_scenes.cornell_klein()
    scene = compile_scene(spec.objects, sky=spec.sky, device="cpu")
    grads = _all_finite(scene, spec.camera(aspect=1.0, device="cpu"),
                        GRAD_CFG)
    assert np.abs(grads["kl_center"]).max() > 0.0


# --- checked rendering ----------------------------------------------------------

def test_checked_render_passes_on_cornell():
    spec = t_scenes.cornell_box()
    scene = compile_scene(spec.objects, sky=spec.sky, device="cpu")
    cfg = TConfig(nx=8, ny=8, spp=2, max_depth=3, light_sampling=True)
    cam = spec.camera(aspect=1.0, device="cpu")
    mean = checks.checked_render_image(scene, cam, cfg)
    assert torch.isfinite(mean).all() and mean.max() > 0.0
    # the scan path's image: render_image of the differentiable config
    want, _ = t_render.render_image(scene, cam,
                                    cfg.replace(differentiable=True))
    assert torch.equal(mean, want)


def test_checked_render_raises_on_nan_albedo():
    spec = t_scenes.cornell_box()
    scene = compile_scene(spec.objects, sky=spec.sky, device="cpu")
    color = scene.tex_color.clone()
    color[0, 0] = float("nan")
    bad = dataclasses.replace(scene, tex_color=color)
    cfg = TConfig(nx=8, ny=8, spp=1, max_depth=3, light_sampling=True)
    with pytest.raises(checks.NonFiniteError) as err:
        checks.checked_render_image(bad, spec.camera(aspect=1.0,
                                                     device="cpu"), cfg)
    assert err.value.bounce == 0 and err.value.what == "throughput"
    assert "bounce 0" in str(err.value)
