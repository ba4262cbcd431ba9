"""PyTorch port, the BVH (scene/bvh.py, ops/traverse.py) against the JAX
package and against its own brute sweeps (CPU).

  * the median and SAH builders' flat arrays (boxes, hit and miss links,
    leaf slots) equal the JAX package's exactly, for random boxes and for
    `compile_scene(bvh=...)` on sphere, mixed and grid scenes, with the
    builders' structural invariants;
  * the traversals (`sphere.intersect_bvh`, `traverse.intersect_bvh_mixed`)
    against the JAX ones in f64 (within 1e-11 relative to max(1, |value|),
    as tests/test_torch_general.py's scene_hit) and against the port's
    brute sweeps: the same hits and materials;
  * the image identity of tests/test_bvh.py: median and SAH renders equal
    to 1e-5, and statistically the brute render (fused pool);
  * `traversal="bvh"` on a scene compiled without a BVH brute-forces;
  * the host's drain check (every `traverse.DRAIN_EVERY` steps) changes no
    value.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scheme_raytrace_tpu import scenes as j_scenes
from scheme_raytrace_tpu.ops import sphere as j_sphere
from scheme_raytrace_tpu.ops import traverse as j_traverse
from scheme_raytrace_tpu.scene import build as j_build
from scheme_raytrace_tpu.scene import bvh as j_bvh
from scheme_raytrace_tpu.scene import objects as j_ob
from scheme_raytrace_torch import render as t_render
from scheme_raytrace_torch import scenes as t_scenes
from scheme_raytrace_torch.config import RenderConfig as TConfig
from scheme_raytrace_torch.integrator import hit as t_hit
from scheme_raytrace_torch.integrator import pool as t_pool
from scheme_raytrace_torch.ops import rect as t_rect
from scheme_raytrace_torch.ops import sphere as t_sphere
from scheme_raytrace_torch.ops import traverse as t_traverse
from scheme_raytrace_torch.scene import build as t_build
from scheme_raytrace_torch.scene import bvh as t_bvh
from scheme_raytrace_torch.scene import objects as t_ob

T_MIN, T_MAX = 0.001, 1e9
BVH_FIELDS = ("bvh_pmin", "bvh_pmax", "bvh_hit", "bvh_miss", "bvh_prims")


@contextlib.contextmanager
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _random_boxes(n, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-5, 5, (n, 3))
    r = rng.uniform(0.1, 0.5, n)
    return t_bvh.sphere_bounds(c, c, r)


def _build(mod, builder, pmin, pmax):
    return (mod.build_sah(pmin, pmax) if builder == "sah"
            else mod.build_median(pmin, pmax, seed=3))


@pytest.mark.parametrize("builder", ["median", "sah"])
@pytest.mark.parametrize("n", [1, 2, 5, 37, 100])
def test_builder_flat_arrays_equal_jax(builder, n):
    pmin, pmax = _random_boxes(n)
    flat = _build(t_bvh, builder, pmin, pmax)
    ref = _build(j_bvh, builder, pmin, pmax)
    for f in ("pmin", "pmax", "hit_link", "miss_link", "prims"):
        np.testing.assert_array_equal(getattr(flat, f), getattr(ref, f))
    # structural invariants: links in range, every prim in one slot, node
    # boxes contain their leaves' boxes
    m = flat.n_nodes
    assert ((flat.hit_link >= -1) & (flat.hit_link < m)).all()
    assert ((flat.miss_link >= -1) & (flat.miss_link < m)).all()
    assert sorted(flat.prims[flat.prims >= 0].tolist()) == list(range(n))
    for i in range(m):
        ids = flat.prims[i][flat.prims[i] >= 0]
        assert (flat.pmin[i][None] <= pmin[ids] + 1e-12).all()
        assert (flat.pmax[i][None] >= pmax[ids] - 1e-12).all()
    np.testing.assert_array_equal(
        t_bvh.rect_bounds(*_rect_args())[0], j_bvh.rect_bounds(*_rect_args())[0])


def _rect_args():
    r = np.random.default_rng(1)
    n = 6
    th = r.uniform(0, 6.28, n)
    rot = np.zeros((n, 3, 3))
    rot[:, 0, 0] = rot[:, 2, 2] = np.cos(th)
    rot[:, 0, 2], rot[:, 2, 0] = np.sin(th), -np.sin(th)
    rot[:, 1, 1] = 1.0
    return (r.integers(0, 3, n), r.uniform(-1, 1, n), r.uniform(-2, 0, n),
            r.uniform(0, 2, n), r.uniform(-2, 0, n), r.uniform(0, 2, n),
            rot, r.uniform(-3, 3, (n, 3)))


def _mixed_objs(ob):
    spec = (j_scenes if ob is j_ob else t_scenes).cornell_box()
    return list(spec.objects) + [
        ob.Sphere((190, 90, 190), 90, ob.Lambertian((0.7, 0.7, 0.7))),
        ob.Sphere((370, 60, 350), 60, ob.Metal((0.9, 0.8, 0.7), 0.2))]


SCENE_OBJS = {
    "random": lambda ob: (j_scenes if ob is j_ob else
                          t_scenes).random_scene(seed=0).objects,
    "grid": lambda ob: (j_scenes if ob is j_ob else
                        t_scenes).test_scene_grid().objects,
    "mixed": _mixed_objs,
}


@pytest.mark.parametrize("builder", ["median", "sah"])
@pytest.mark.parametrize("name", sorted(SCENE_OBJS))
def test_compile_scene_bvh_equals_jax(name, builder):
    """One tree over spheres then rects (global ids), from each package's
    own objects: the same flat arrays, has_bvh set."""
    js = j_build.compile_scene(SCENE_OBJS[name](j_ob), sky="gradient",
                               bvh=builder)
    ts = t_build.compile_scene(SCENE_OBJS[name](t_ob), sky="gradient",
                               bvh=builder, device="cpu")
    assert ts.has_bvh and js.has_bvh
    for f in BVH_FIELDS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))


def _rays(n, seed, box):
    rng = np.random.default_rng(seed)
    lo, hi = box
    o = rng.uniform(lo, hi, (n, 3))
    d = rng.normal(size=(n, 3))
    return o, d / np.linalg.norm(d, axis=1, keepdims=True), rng.random(n)


def _scenes(name, builder):
    """The JAX scene (f64) and the port's twin from its arrays."""
    with x64():
        js = j_build.compile_scene(SCENE_OBJS[name](j_ob), sky="gradient",
                                   dtype=jnp.float64, bvh=builder)
    ts = t_build.scene_from_arrays(
        {f: np.asarray(getattr(js, f)) for f in j_build._DATA_FIELDS},
        {f: getattr(js, f) for f in j_build._META_FIELDS},
        dtype=torch.float64, device="cpu")
    return js, ts


def _close(want, got):
    for w, g in zip(want, got):
        w, g = np.asarray(w), g.numpy()
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            assert (np.abs(g - w) <= 1e-11 * np.maximum(1.0, np.abs(w))).all()


@pytest.mark.parametrize("builder", ["median", "sah"])
@pytest.mark.parametrize("name", ["random", "grid"])
def test_sphere_traversal_against_jax_and_brute(name, builder):
    js, ts = _scenes(name, builder)
    box = (-3, 12) if name == "grid" else (-10, 10)
    o, d, tm = _rays(512, 1, box)
    with x64():
        want = j_sphere.intersect_bvh(jnp.asarray(o), jnp.asarray(d),
                                      jnp.asarray(tm), js, T_MIN, T_MAX)
    to, td, tt = (torch.tensor(x) for x in (o, d, tm))
    got = t_sphere.intersect_bvh(to, td, tt, ts, T_MIN, T_MAX)
    assert np.asarray(want[0]).sum() > 50
    _close(want, got)
    brute = t_sphere.intersect(to, td, tt, ts, T_MIN, T_MAX)
    assert torch.equal(brute[0], got[0]) and torch.equal(brute[3], got[3])
    torch.testing.assert_close(brute[1], got[1], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("builder", ["median", "sah"])
@pytest.mark.parametrize("name", ["mixed", "random"])
def test_mixed_traversal_against_jax_and_brute(name, builder):
    """One tree over spheres and rotated rects: against JAX's
    intersect_bvh_mixed, and against the port's sphere and rect sweeps
    merged as scene_hit merges them."""
    js, ts = _scenes(name, builder)
    box = (1, 554) if name == "mixed" else (-10, 10)
    o, d, tm = _rays(512, 2, box)
    with x64():
        want = j_traverse.intersect_bvh_mixed(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), js, T_MIN,
            T_MAX)
    to, td, tt = (torch.tensor(x) for x in (o, d, tm))
    got = t_traverse.intersect_bvh_mixed(to, td, tt, ts, T_MIN, T_MAX)
    assert np.asarray(want[0]).sum() > 50
    _close(want, got)
    brute = t_sphere.intersect(to, td, tt, ts, T_MIN, T_MAX)
    if ts.has_rects:
        brute = t_hit._merge(brute, t_rect.intersect(to, td, tt, ts, T_MIN,
                                                     T_MAX))
    assert torch.equal(brute[0], got[0])
    assert torch.equal(brute[3].long(), got[3].long())
    torch.testing.assert_close(brute[1], got[1], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["grid", "mixed"])
def test_image_identical_median_sah_brute(name):
    """tests/test_bvh.py's triple, on the port in f32: the median and SAH
    renders (general pool) within 1e-5 of each other, and the brute render
    (the fused pool) statistically the same: mean |difference| < 2e-3,
    under 2% of pixels off by > 0.05."""
    spec = (t_scenes.test_scene_grid() if name == "grid"
            else t_scenes.SceneSpec(_mixed_objs(t_ob),
                                    t_scenes.cornell_camera(), "gradient"))
    cam = spec.camera(aspect=1.0, device="cpu")
    cfg = TConfig(nx=16, ny=16, spp=1, max_depth=4,
                  light_sampling=name == "mixed")
    imgs = {}
    for builder, traversal in [(None, "brute"), ("median", "bvh"),
                               ("sah", "bvh")]:
        scene = t_build.compile_scene(spec.objects, sky=spec.sky, bvh=builder,
                                      device="cpu")
        mean, _ = t_render.render_image(scene, cam,
                                        cfg.replace(traversal=traversal))
        assert torch.isfinite(mean).all()
        imgs[builder] = mean.numpy()
    assert imgs[None].max() > 0.0
    np.testing.assert_allclose(imgs["median"], imgs["sah"], atol=1e-5)
    diff = np.abs(imgs[None] - imgs["median"])
    assert diff.mean() < 2e-3
    assert (diff.max(axis=-1) > 0.05).mean() < 0.02


def test_bvh_requested_but_absent_falls_back():
    """traversal="bvh" on a scene compiled without a BVH brute-forces in the
    general pool: the image of the brute sweep, bit for bit."""
    spec = t_scenes.test_scene_grid()
    scene = t_build.compile_scene(spec.objects, sky=spec.sky, device="cpu")
    assert not scene.has_bvh
    cam = spec.camera(aspect=1.0, device="cpu")
    cfg = TConfig(nx=8, ny=8, spp=1, max_depth=2, traversal="bvh")
    mean, _ = t_render.render_image(scene, cam, cfg)
    assert torch.isfinite(mean).all()
    z = torch.zeros(cfg.n_pixels, 3)
    brute = t_pool.render_pool(scene, cam, cfg.replace(traversal="brute"), z,
                               0)
    assert torch.equal(mean.reshape(-1, 3), brute[0])


def test_drain_check_changes_nothing(monkeypatch):
    """The walk checks for live cursors every DRAIN_EVERY steps; the steps
    it runs past the last one change no value."""
    _, ts = _scenes("mixed", "sah")
    o, d, tm = (torch.tensor(x) for x in _rays(256, 3, (1, 554)))
    every = t_traverse.intersect_bvh_mixed(o, d, tm, ts, T_MIN, T_MAX)
    monkeypatch.setattr(t_traverse, "DRAIN_EVERY", 1)
    once = t_traverse.intersect_bvh_mixed(o, d, tm, ts, T_MIN, T_MAX)
    for a, b in zip(every, once):
        assert torch.equal(a, b)
