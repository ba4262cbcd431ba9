"""PyTorch port, forward render: the pool against the JAX pool and goldens.

In f64 the port's pool render equals the JAX pool's to round-off with the
exact same segment count; in f32 it meets the config-4 golden bounds of
tests/test_parity.py (MAE < 5e-3, < 1% of pixels off by more than 0.05).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scheme_raytrace_tpu import render as j_render
from scheme_raytrace_tpu import scenes as j_scenes
from scheme_raytrace_tpu.config import RenderConfig as JConfig
from scheme_raytrace_tpu.scene import build as j_build
from scheme_raytrace_torch import render as t_render
from scheme_raytrace_torch import scenes as t_scenes
from scheme_raytrace_torch.camera import CAMERA_FIELDS, camera_from_arrays
from scheme_raytrace_torch.config import RenderConfig as TConfig
from scheme_raytrace_torch.integrator import pool as t_pool
from scheme_raytrace_torch.scene import build as t_build

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "config4_cornell_light.npz")
# BASELINE config 4 at the golden's size (scheme_raytrace_tpu/parity.py)
CONFIG4 = dict(nx=64, ny=64, spp=8, max_depth=100, seed=0,
               light_sampling=True)


def _cornell(dtype=torch.float32, device="cpu"):
    spec = t_scenes.cornell_box()
    scene = t_build.compile_scene(spec.objects, sky=spec.sky, dtype=dtype,
                                  device=device)
    return scene, spec.camera(dtype=dtype, aspect=1.0, device=device)


def _assert_golden_bounds(mean):
    ref = np.load(GOLDEN)["image"]
    img = mean.detach().cpu().numpy().astype(np.float64)
    assert img.shape == ref.shape
    assert np.isfinite(img).all()
    diff = np.abs(img - ref)
    assert diff.mean() < 5e-3, diff.mean()
    assert (diff.max(axis=-1) > 0.05).mean() < 0.01


def test_render_f64_matches_jax_pool():
    kw = dict(nx=32, ny=32, spp=2, max_depth=100, seed=0, light_sampling=True,
              dtype="f64")
    jax.config.update("jax_enable_x64", True)
    try:
        spec = j_scenes.cornell_box()
        j_scene = j_build.compile_scene(spec.objects, sky=spec.sky,
                                        dtype=jnp.float64)
        j_cam = spec.camera(dtype=jnp.float64, aspect=1.0)
        cfg = JConfig(**kw)
        st, j_segs, j_iters = j_render.render_with_stats(
            j_scene, j_cam, cfg, j_render.init_state(cfg))
        j_img, j_segs, j_iters = np.asarray(st.raw_sum), int(j_segs), int(j_iters)
        arrays = {f: np.asarray(getattr(j_scene, f))
                  for f in j_build._DATA_FIELDS}
        meta = {f: getattr(j_scene, f) for f in j_build._META_FIELDS}
        cam_arrays = {k: np.asarray(getattr(j_cam, k)) for k in CAMERA_FIELDS}
    finally:
        jax.config.update("jax_enable_x64", False)
    scene = t_build.scene_from_arrays(arrays, meta, dtype=torch.float64,
                                      device="cpu")
    cam = camera_from_arrays(cam_arrays, dtype=torch.float64, device="cpu")
    cfg = TConfig(**kw)
    st, segs, iters = t_render.render_with_stats(scene, cam, cfg,
                                                 t_render.init_state(cfg, device="cpu"))
    assert int(segs) == j_segs
    # both pools run one pixel per work unit at this size, so the
    # iteration counts agree too
    assert iters == j_iters
    assert int(st.sample_count) == 2
    np.testing.assert_allclose(st.raw_sum.numpy(), j_img, rtol=1e-9,
                               atol=1e-9)
    assert j_img.max() > 0


def test_render_f32_matches_config4_golden():
    scene, cam = _cornell()
    mean, state = t_render.render_image(scene, cam, TConfig(**CONFIG4))
    assert mean.dtype == torch.float32 and int(state.sample_count) == 8
    _assert_golden_bounds(mean)


def test_banded_render_equals_whole_frame(monkeypatch):
    scene, cam = _cornell(torch.float64)
    cfg = TConfig(nx=16, ny=16, spp=2, max_depth=20, light_sampling=True,
                  dtype="f64")
    whole, w_segs, _ = t_pool.render_pool_auto(
        scene, cam, cfg, torch.zeros(256, 3, dtype=torch.float64), 0)
    monkeypatch.setattr(t_pool, "BAND_PIX", 64)      # 4 bands of 4 rows
    banded, b_segs, _ = t_pool.render_pool_auto(
        scene, cam, cfg, torch.zeros(256, 3, dtype=torch.float64), 0)
    assert int(b_segs) == int(w_segs)
    assert torch.equal(banded, whole)


def test_resumed_render_continues_the_stream():
    scene, cam = _cornell(torch.float64)
    cfg = TConfig(nx=16, ny=16, spp=2, max_depth=20, light_sampling=True,
                  dtype="f64")
    st2, segs2, _ = t_render.render_with_stats(scene, cam, cfg,
                                               t_render.init_state(cfg, device="cpu"))
    one = cfg.replace(spp=1)
    st, segs_a, _ = t_render.render_with_stats(scene, cam, one,
                                               t_render.init_state(one, device="cpu"))
    st, segs_b, _ = t_render.render_with_stats(scene, cam, one, st)
    assert int(st.sample_count) == 2
    assert int(segs_a) + int(segs_b) == int(segs2)
    np.testing.assert_allclose(st.raw_sum.numpy(), st2.raw_sum.numpy(),
                               rtol=1e-12, atol=1e-12)


def test_differentiable_config_not_ported():
    """The differentiable config, once refused, renders through the
    wavefront scan: its pass is the while mode's render_pass bit for bit
    (tests/test_torch_wavefront.py holds both against JAX)."""
    scene, cam = _cornell()
    cfg = TConfig(nx=8, ny=8, spp=1, differentiable=True)
    st = t_render.render(scene, cam, cfg,
                         t_render.init_state(cfg, device="cpu"))
    want = t_render.render_pass(scene, cam, cfg.replace(differentiable=False),
                                t_render.init_state(cfg, device="cpu"), 0)
    assert int(st.sample_count) == 1
    assert torch.equal(st.raw_sum, want.raw_sum)
    assert torch.isfinite(st.raw_sum).all() and st.raw_sum.max() > 0.0


def test_display_ppm_and_state_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    mean = rng.uniform(-0.1, 1.5, (5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(t_render.to_u8(torch.from_numpy(mean)),
                                  j_render.to_u8(mean))
    t_render.write_ppm(str(tmp_path / "t.ppm"), torch.from_numpy(mean))
    j_render.write_ppm(str(tmp_path / "j.ppm"), mean)
    assert (tmp_path / "t.ppm").read_text() == (tmp_path / "j.ppm").read_text()
    state = t_render.RenderState(torch.from_numpy(mean),
                                 torch.tensor(3, dtype=torch.int32))
    t_render.save_state(str(tmp_path / "s.npz"), state, seed=5)
    back = t_render.load_state(str(tmp_path / "s.npz"), device="cpu")
    assert torch.equal(back.raw_sum, state.raw_sum)
    assert int(back.sample_count) == 3
    assert int(np.load(tmp_path / "s.npz")["seed"]) == 5
    j_back = j_render.load_state(str(tmp_path / "s.npz"))
    np.testing.assert_array_equal(np.asarray(j_back.raw_sum), mean)
