"""PyTorch port, host side: config, scene compile, camera, import hygiene.

The port (scheme_raytrace_torch) is held against the JAX package
(scheme_raytrace_tpu), which stays the reference.  Inputs go to both
packages; arrays cross between them as numpy.
"""

import dataclasses
import math
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scheme_raytrace_tpu import camera as j_camera
from scheme_raytrace_tpu import config as j_config
from scheme_raytrace_tpu import scenes as j_scenes
from scheme_raytrace_tpu.scene import build as j_build
from scheme_raytrace_torch import camera as t_camera
from scheme_raytrace_torch import config as t_config
from scheme_raytrace_torch import scenes as t_scenes
from scheme_raytrace_torch.scene import build as t_build

CONSTANTS = ("BIG", "SHADOW_EPS", "RECT_PAD", "MEDIUM_REHIT_EPS",
             "KLEIN_MAX_STEPS", "KLEIN_ITERATIONS", "KLEIN_SURF_EPS",
             "KLEIN_NORMAL_H", "KLEIN_DE_SCALE", "KLEIN_R", "KLEIN_SPHERE_R",
             "SAH_T_TRI", "SAH_T_AABB", "GAMMA_QUANT")
DROPPED_FIELDS = {"use_pallas"}      # the device picks the implementation


def test_config_fields_defaults_and_constants_equal():
    j_fields = {f.name: f.default for f in dataclasses.fields(j_config.RenderConfig)}
    t_fields = {f.name: f.default for f in dataclasses.fields(t_config.RenderConfig)}
    assert set(j_fields) - set(t_fields) == DROPPED_FIELDS
    assert set(t_fields) <= set(j_fields)
    for name, default in t_fields.items():
        assert default == j_fields[name], name
    for name in CONSTANTS:
        assert getattr(t_config, name) == getattr(j_config, name), name
    cfg = t_config.RenderConfig(nx=3, ny=5)
    assert cfg.n_pixels == 15
    assert cfg.resolve_pool_rays() == j_config.RenderConfig().resolve_pool_rays()
    assert (cfg.resolve_pool_rays(reverse=True)
            == j_config.RenderConfig().resolve_pool_rays(reverse=True))
    assert cfg.torch_dtype == torch.float32
    assert cfg.replace(dtype="f64").torch_dtype == torch.float64
    with pytest.raises(ValueError):
        cfg.replace(dtype="bf16").torch_dtype


def _assert_scene_equal(j_scene, t_scene):
    for f in j_build._DATA_FIELDS:
        a = np.asarray(getattr(j_scene, f))
        b = getattr(t_scene, f).numpy()
        assert a.shape == b.shape, f
        if np.issubdtype(a.dtype, np.floating):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(b, a, err_msg=f)   # floats within 0
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)
            assert (b.dtype == np.bool_) == (a.dtype == np.bool_), f
    for f in j_build._META_FIELDS:
        assert getattr(t_scene, f) == getattr(j_scene, f), f


@pytest.mark.parametrize("name", sorted(j_scenes.SCENES))
def test_compile_scene_equals_jax(name):
    j_spec = j_scenes.SCENES[name]()
    t_spec = t_scenes.SCENES[name]()
    assert t_spec.sky == j_spec.sky
    assert t_spec.camera_kwargs == j_spec.camera_kwargs
    j_scene = j_build.compile_scene(j_spec.objects, sky=j_spec.sky)
    t_scene = t_build.compile_scene(t_spec.objects, sky=t_spec.sky,
                                    device="cpu")
    _assert_scene_equal(j_scene, t_scene)


def test_compile_scene_bvh_not_ported():
    spec = t_scenes.test_scene()
    with pytest.raises(NotImplementedError, match="A.11"):
        t_build.compile_scene(spec.objects, sky=spec.sky, bvh="sah",
                              device="cpu")


def test_scene_from_arrays_round_trips():
    spec = j_scenes.cornell_box()
    j_scene = j_build.compile_scene(spec.objects, sky=spec.sky)
    arrays = {f: np.asarray(getattr(j_scene, f)) for f in j_build._DATA_FIELDS}
    meta = {f: getattr(j_scene, f) for f in j_build._META_FIELDS}
    t_scene = t_build.scene_from_arrays(arrays, meta, device="cpu")
    _assert_scene_equal(j_scene, t_scene)
    again = t_build.scene_from_arrays(
        {f: getattr(t_scene, f).numpy() for f in t_build._DATA_FIELDS},
        {f: getattr(t_scene, f) for f in t_build._META_FIELDS}, device="cpu")
    _assert_scene_equal(j_scene, again)
    params, rest = t_build.partition(t_scene)
    assert set(params) == {f for f in t_build._DATA_FIELDS
                           if getattr(t_scene, f).is_floating_point()}
    moved = t_build.combine({k: v * 2 for k, v in params.items()}, rest)
    assert torch.equal(moved.rect_k, t_scene.rect_k * 2)
    assert torch.equal(moved.rect_axis, t_scene.rect_axis)
    f64 = t_scene.astype(torch.float64)
    assert f64.dtype == torch.float64 and f64.rect_axis.dtype == torch.int32


@pytest.mark.parametrize("name", ["cornell", "three_spheres", "random"])
def test_camera_basis_and_rays_match_jax(name):
    spec = j_scenes.SCENES[name]()
    j_cam = spec.camera(aspect=1.5)
    t_cam = t_scenes.SCENES[name]().camera(aspect=1.5, device="cpu")
    from_arrays = t_camera.camera_from_arrays(
        {k: np.asarray(getattr(j_cam, k)) for k in t_camera.CAMERA_FIELDS},
        device="cpu")
    for a, b, c in zip(j_camera._basis(j_cam), t_camera._basis(t_cam),
                       t_camera._basis(from_arrays)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-5)
        np.testing.assert_array_equal(c.numpy(), b.numpy())
    rng = np.random.default_rng(0)
    s, t, r1, r2, xi = (rng.random(64, dtype=np.float32) for _ in range(5))
    j_out = j_camera.get_rays_u(j_cam, *(jnp.asarray(x) for x in (s, t, r1, r2, xi)))
    t_out = t_camera.get_rays_u(t_cam, *(torch.from_numpy(x) for x in (s, t, r1, r2, xi)))
    for a, b in zip(j_out, t_out):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-4)


def test_camera_basis_f64_matches_jax():
    jax.config.update("jax_enable_x64", True)
    try:
        spec = j_scenes.cornell_box()
        j_cam = spec.camera(dtype=jnp.float64, aspect=1.0)
        t_cam = t_scenes.cornell_box().camera(dtype=torch.float64, aspect=1.0,
                                              device="cpu")
        for a, b in zip(j_camera._basis(j_cam), t_camera._basis(t_cam)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12,
                                       atol=1e-12)
    finally:
        jax.config.update("jax_enable_x64", False)
    theta = 40.0 * math.pi / 180.0
    assert math.isclose(float(t_camera._basis(t_cam)[3][1]),
                        2.0 * math.tan(theta / 2.0), rel_tol=1e-12)


def test_port_imports_no_jax():
    code = (
        "import pkgutil, sys, importlib\n"
        "import scheme_raytrace_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith("
        "('jax.', 'jaxlib', 'scheme_raytrace_tpu')))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _entry_points(tmp_path):
    """name -> a call of each entry point that builds tensors, taking the
    `device` keyword."""
    from scheme_raytrace_torch import render as t_render
    spec = t_scenes.three_spheres()
    scene = t_build.compile_scene(spec.objects, sky=spec.sky, device="cpu")
    arrays = {f: getattr(scene, f).numpy() for f in t_build._DATA_FIELDS}
    meta = {f: getattr(scene, f) for f in t_build._META_FIELDS}
    cam = spec.camera(device="cpu")
    cam_arrays = {k: getattr(cam, k).numpy() for k in t_camera.CAMERA_FIELDS}
    cfg = t_config.RenderConfig(nx=4, ny=4, spp=1)
    path = str(tmp_path / "state.npz")
    t_render.save_state(path, t_render.init_state(cfg, device="cpu"), seed=0)
    return {
        "compile_scene": lambda **kw: t_build.compile_scene(
            spec.objects, sky=spec.sky, **kw).sph_r,
        "scene_from_arrays": lambda **kw: t_build.scene_from_arrays(
            arrays, meta, **kw).sph_r,
        "spec_camera": lambda **kw: spec.camera(**kw).lookfrom,
        "make_camera": lambda **kw: t_camera.make_camera(
            (0.0, 0.0, 1.0), (0.0, 0.0, 0.0), **kw).lookfrom,
        "camera_from_arrays": lambda **kw: t_camera.camera_from_arrays(
            cam_arrays, **kw).lookfrom,
        "init_state": lambda **kw: t_render.init_state(cfg, **kw).raw_sum,
        "load_state": lambda **kw: t_render.load_state(path, **kw).raw_sum,
    }


@pytest.mark.parametrize("name", [
    "compile_scene", "scene_from_arrays", "spec_camera", "make_camera",
    "camera_from_arrays", "init_state", "load_state"])
def test_entry_points_default_to_the_card(name, tmp_path, monkeypatch):
    # no `device`: the card, and where there is none an error that names
    # the request for the CPU; never the CPU by itself
    call = _entry_points(tmp_path)[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call()
    assert call(device="cpu").device.type == "cpu"
    assert call(device=torch.device("cpu")).device.type == "cpu"


def test_resolve_device():
    assert t_config.resolve_device("cpu") == torch.device("cpu")
    assert t_config.resolve_device("cuda:1") == torch.device("cuda", 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            t_config.resolve_device(None)


def test_kernel_variants_are_named_by_feature_set():
    # utils/cuda_build names a library by its kernel and its plan's feature
    # set (no nvcc needed): two plans with the same features share a name,
    # Cornell and the bezier scene do not, counts do not enter
    from scheme_raytrace_torch.integrator import bounce as tb
    from scheme_raytrace_torch.utils import cuda_build

    def feats(name, **kw):
        spec = t_scenes.SCENES[name]()
        scene = t_build.compile_scene(spec.objects, sky=spec.sky,
                                      device="cpu")
        return tb.kernel_features(tb.pool_plan(scene, t_config.RenderConfig(
            nx=8, ny=8, spp=1, **kw)))

    assert feats("cornell") == feats("cornell", light_sampling=True) == ()
    assert feats("bezier") == feats("points_chain") == ("spheres", "bezier")
    assert feats("cornell_bezier") == ("bezier",)
    assert feats("three_spheres") == feats("test") == ("spheres",)
    assert feats("random") == ("spheres", "moving")
    assert feats("textured") == ("spheres", "perlin", "image")
    assert feats("cornell_smoke") == ("media",)
    assert feats("klein") == ("spheres", "klein")
    assert feats("cornell_klein") == ("klein",)
    name = cuda_build.variant_name
    assert name("bounce_step", feats("cornell")) == "bounce_step-base"
    assert (name("bounce_step_bwd", feats("bezier"))
            == name("bounce_step_bwd", feats("points_chain"))
            == "bounce_step_bwd-spheres+bezier")
    assert name("bounce_step", feats("cornell")) != name(
        "bounce_step", feats("cornell_bezier"))
    # a set in any order, each flag once; an unknown flag raises
    assert name("k", ("bezier", "spheres", "bezier")) == "k-spheres+bezier"
    assert cuda_build.feature_flags(("bezier", "spheres")) == [
        "-DSRT_SPHERES=1", "-DSRT_BEZIER=1"]
    with pytest.raises(ValueError, match="unknown kernel features"):
        name("k", ("nurbs",))
    # every flag is read by the shared header
    header = (cuda_build.CSRC / "bounce_common.cuh").read_text()
    for flag, macro in cuda_build.FEATURES.items():
        assert macro in header, flag


def test_build_log_resources_are_parsed():
    from scheme_raytrace_torch.utils import cuda_build
    log = """-gencode arch=compute_90a,code=sm_90a -DSRT_BEZIER=1
built in 9.1 s
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN3abc6kernelIfEEvT_' for 'sm_90a'
ptxas info    : Function properties for _ZN3abc6kernelIfEEvT_
    736 bytes stack frame, 234 bytes spill stores, 136 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 16224 bytes smem
ptxas info    : Function properties for _ZN3abc10bezier_adjIfEEvT_
    64 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN3abc6kernelIdEEvT_' for 'sm_90a'
ptxas info    : Function properties for _ZN3abc6kernelIdEEvT_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 255 registers, 568 bytes cmem[0]
"""
    f32, f64 = cuda_build.resources(log)
    assert f32 == dict(entry="_ZN3abc6kernelIfEEvT_", registers=128,
                       spill_stores=234, spill_loads=136, stack=736,
                       smem=16224)
    assert (f64["registers"], f64["smem"], f64["stack"]) == (255, 0, 0)
