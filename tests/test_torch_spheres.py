"""PyTorch port, the sphere scenes against the JAX package (CPU).

The same numpy-seeded inputs go through the JAX function and the port's:

  * the plain `bounce.step` against the JAX `bounce.step` on `test_scene`
    (gradient sky: metal, dielectric, the hollow negative-radius sphere, a
    checker ground of radius 100), a moving-sphere scene, `grid` (101
    spheres) and `random_scene(seed=0)` (227 spheres, most of them moving,
    ground radius 1000).  Above 64 spheres the JAX step runs its chunked
    loop (pk only) or its slim sweep (pk and the attribute atlas); the port
    is held against both.  f64: the same scattering decisions and every
    output within rtol/atol 1e-10.  XLA's CPU compiler contracts products
    and sums into FMAs, and `cq = oc.oc - r*r` cancels on the ground
    spheres (radius 100 and 1000): over 3 seeds of 4,096 lanes the largest
    difference was 7.9e-12 on `random_scene` and 1.4e-12 on `test_scene`,
    and the JAX step's own two sweeps differ from each other by 3e-15 in
    the same outputs, so they are not bitwise equal either.  f32: rtol 1e-4
    / atol 1e-3 on all but at most 0.1% of the lanes (a lane can take a
    branch the other way), and once against the Pallas kernel in interpret
    mode on the 5-sphere scene;
  * `bounce.step_vjp` against `jax.vjp` of the JAX step on the same scenes
    in f64: every cotangent within 1e-12 of that output's largest, and
    within 1e-10 on `random_scene`, where the radius-1000 ground's
    cancellation feeds 1/sqrt(disc) in the adjoint (measured: 12 of 4,794
    `pk` slots beyond 1e-12, the worst 7.3e-12 of the largest);
  * f64 `render_with_stats` on `three_spheres` 16^2 spp2 and `random_scene`
    16^2 spp1 against the JAX pool: image within 1e-9, exact segments and
    iterations;
  * f64 `render_diff_fused` on `three_spheres` 16^2 spp2 depth 8 against the
    JAX one and `jax.grad`: image, segments, leftover, and the gradient of
    every float scene leaf and the camera's lookfrom within 1e-12 of the
    leaf's largest;
  * f32 renders against the config-1 and config-2 goldens with the bounds
    of tests/test_parity.py (MAE < 5e-3, < 1% of pixels off by > 0.05);
  * the three strided pools on `three_spheres`: bitwise equal to each
    other, the FIFO pool's segments, its image within rtol/atol 1e-5.

The kernels run these scenes only on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scheme_raytrace_tpu import render as j_render
from scheme_raytrace_tpu import scenes as j_scenes
from scheme_raytrace_tpu.config import RenderConfig as JConfig
from scheme_raytrace_tpu.integrator import bounce as jb
from scheme_raytrace_tpu.integrator import diff_fused as j_diff
from scheme_raytrace_tpu.scene import build as j_build
from scheme_raytrace_tpu.scene import objects as j_ob
from scheme_raytrace_torch import render as t_render
from scheme_raytrace_torch import scenes as t_scenes
from scheme_raytrace_torch.camera import CAMERA_FIELDS, camera_from_arrays
from scheme_raytrace_torch.config import RenderConfig as TConfig
from scheme_raytrace_torch.integrator import bounce as tb
from scheme_raytrace_torch.integrator import diff_fused as t_diff
from scheme_raytrace_torch.integrator import persist as t_persist
from scheme_raytrace_torch.integrator import pool_fused as t_fused
from scheme_raytrace_torch.integrator import pool_packed as t_packed
from scheme_raytrace_torch.integrator import pool_strided as t_strided
from scheme_raytrace_torch.scene import build as t_build

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
M = 1024          # lanes of the step comparisons
MAX_FLIP_FRAC = 1e-3


def _moving_spec():
    """The moving-sphere scene of tests/test_bounce.py."""
    objs = [j_ob.Sphere((0, -100.5, -1), 100,
                        j_ob.Lambertian((0.6, 0.6, 0.2))),
            j_ob.MovingSphere((0, 0, -1), (0, 0.4, -1), 0.0, 1.0, 0.5,
                              j_ob.Lambertian((0.2, 0.3, 0.7)))]
    return j_scenes.SceneSpec(objs, j_scenes.default_camera(), "gradient")


# name -> (spec, sky, the box the lane origins are drawn from)
SCENES = {
    "test": (j_scenes.test_scene, "gradient", ((-2, -0.4, -3), (2, 1.5, 1))),
    "moving": (_moving_spec, "gradient", ((-2, -0.4, -3), (2, 1.5, 1))),
    "grid": (j_scenes.test_scene_grid, "gradient",
             ((-1, -0.4, -1), (10, 2, 10))),
    "random": (lambda: j_scenes.random_scene(seed=0), "gradient",
               ((-6, 0.0, -6), (10, 2.5, 10))),
}


class _X64:
    """jax_enable_x64 for an f64 block, restored on exit."""

    def __init__(self, on=True):
        self.on = on

    def __enter__(self):
        if self.on:
            jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        if self.on:
            jax.config.update("jax_enable_x64", False)


def _jax_scene(name, dtype_name):
    dt = jnp.float64 if dtype_name == "f64" else jnp.float32
    spec_fn, sky, box = SCENES[name]
    spec = spec_fn()
    scene = j_build.compile_scene(spec.objects, sky=sky, dtype=dt)
    return scene, spec.camera(dtype=dt, aspect=1.0), box


def _arrays(j_scene, j_cam):
    return ({f: np.asarray(getattr(j_scene, f)) for f in j_build._DATA_FIELDS},
            {f: getattr(j_scene, f) for f in j_build._META_FIELDS},
            {k: np.asarray(getattr(j_cam, k)) for k in CAMERA_FIELDS})


def _port_scene(arrays, meta, cam, dtype):
    return (t_build.scene_from_arrays(arrays, meta, dtype=dtype, device="cpu"),
            camera_from_arrays(cam, dtype=dtype, device="cpu"))


def _t_plan(plan):
    return tb.BouncePlan(**{k: getattr(plan, k)
                            for k in tb.BouncePlan.__dataclass_fields__})


def _lanes(m, plan, box, seed):
    """Numpy draws of the step's inputs: random gitems (negatives included),
    fresh/alive masks, depths with some at the cap, origins inside `box`,
    unit directions, times in [0, 1), nonzero radiance and throughput; and
    normal cotangents for the 13 float outputs."""
    r = np.random.default_rng(seed)
    gitem = r.integers(-2 ** 31, 2 ** 31, m, dtype=np.int64).astype(np.int32)
    px = r.integers(0, plan.nx, m).astype(np.float64)
    py = r.integers(0, plan.ny, m).astype(np.float64)
    fresh = r.random(m) < 0.4
    alive = fresh | (r.random(m) < 0.8)
    depth = r.integers(0, 4, m).astype(np.int32)
    depth[r.random(m) < 0.05] = plan.max_depth
    lo, hi = (np.asarray(b, np.float64)[:, None] for b in box)
    o = lo + r.random((3, m)) * (hi - lo)
    dvec = r.normal(size=(3, m))
    dvec /= np.linalg.norm(dvec, axis=0, keepdims=True)
    rad = r.random((3, m))
    tp = r.uniform(0.1, 1.0, (3, m))
    lanes = [*o, *dvec, r.random(m), *rad, *tp]
    cts = list(r.normal(size=(13, m)))
    return (gitem, px, py, fresh, alive, depth), lanes, cts


def _split(x):
    return (tuple(x[0:3]), tuple(x[3:6]), x[6], tuple(x[7:10]),
            tuple(x[10:13]))


def _flat(out, conv):
    o, d, time, rad, tp, sc = out
    return np.stack([conv(x) for x in (*o, *d, time, *rad, *tp)]), conv(sc)


def _jax_step(plan, pk, ints, lanes, dt, fn=None):
    gitem, px, py, fresh, alive, depth = ints
    f = lambda x: jnp.asarray(x, dt)
    pk = tuple(f(x) for x in pk) if isinstance(pk, tuple) else f(pk)
    out = (fn or jb.step)(plan, pk, jnp.asarray(gitem), f(px), f(py),
                          jnp.asarray(fresh), jnp.asarray(alive),
                          jnp.asarray(depth), *_split([f(x) for x in lanes]))
    return _flat(out, np.asarray)


def _torch_step(plan, pk, ints, lanes, dt):
    gitem, px, py, fresh, alive, depth = ints
    g = lambda x: torch.tensor(np.asarray(x), dtype=dt)
    pk = tuple(g(x) for x in pk) if isinstance(pk, tuple) else g(pk)
    out = tb.step(_t_plan(plan), pk, torch.as_tensor(gitem), g(px), g(py),
                  torch.as_tensor(fresh), torch.as_tensor(alive),
                  torch.as_tensor(depth), *_split([g(x) for x in lanes]))
    return _flat(out, lambda x: x.numpy())


def _plans(name, dtype_name):
    """The JAX plans and packed scenes of one scene: pk only, and, above
    UNROLL_MAX spheres, the (pk, atlas) pair of the slim sweep."""
    j_scene, j_cam, box = _jax_scene(name, dtype_name)
    dt = jnp.float64 if dtype_name == "f64" else jnp.float32
    cfg = JConfig(nx=16, ny=16, spp=1, max_depth=8, dtype=dtype_name)
    plan = jb.make_plan(j_scene, cfg)
    packed = jb.pack(j_scene, j_cam, plan, dt)
    forms = {}
    if plan.has_atlas:
        forms["atlas"] = (plan, tuple(np.asarray(x) for x in packed))
        packed = packed[0]
    forms["pk"] = (dataclasses.replace(plan, attr_sweep=False),
                   np.asarray(packed))
    return forms, box


@pytest.mark.parametrize("dtype_name", ["f64", "f32"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_step_matches_jax(name, dtype_name):
    f64 = dtype_name == "f64"
    t_dt = torch.float64 if f64 else torch.float32
    with _X64(f64):
        forms, box = _plans(name, dtype_name)
        j_dt = jnp.float64 if f64 else jnp.float32
        plan = forms["pk"][0]
        assert (name in ("grid", "random")) == (plan.n_spheres > tb.UNROLL_MAX)
        assert plan.has_moving == (name in ("moving", "random"))
        ints, lanes, _ = _lanes(M, plan, box, seed=11)
        want = {k: _jax_step(p, pk, ints, lanes, j_dt)
                for k, (p, pk) in forms.items()}
    for form, (p, pk) in forms.items():
        got, g_sc = _torch_step(p, pk, ints, lanes, t_dt)
        w, w_sc = want[form]
        assert g_sc.any() and not g_sc.all()
        if f64:
            np.testing.assert_array_equal(g_sc, w_sc, err_msg=form)
            np.testing.assert_allclose(got, w, rtol=1e-10, atol=1e-10,
                                       err_msg=form)
        else:
            bad = (g_sc != w_sc) | (np.abs(got - w)
                                    > 1e-3 + 1e-4 * np.abs(w)).any(0)
            assert np.isfinite(got).all()
            assert bad.sum() <= MAX_FLIP_FRAC * M, (form, int(bad.sum()))
    if "atlas" in want and f64:     # the JAX step's two sweeps agree
        np.testing.assert_allclose(want["atlas"][0], want["pk"][0],
                                   rtol=1e-10, atol=1e-10)


def test_step_matches_pallas_interpret_on_spheres():
    forms, box = _plans("test", "f32")
    plan, pk = forms["pk"]
    ints, lanes, _ = _lanes(256, plan, box, seed=12)
    want, w_sc = _jax_step(plan, pk, ints, lanes, jnp.float32,
                           fn=jb.as_pallas(plan, 256, interpret=True))
    got, g_sc = _torch_step(plan, pk, ints, lanes, torch.float32)
    bad = (g_sc != w_sc) | (np.abs(got - want)
                            > 1e-3 + 1e-4 * np.abs(want)).any(0)
    assert bad.sum() <= 1, int(bad.sum())        # one f32 flip of 256 lanes


@pytest.mark.parametrize("name", sorted(SCENES))
def test_step_vjp_matches_jax_vjp(name):
    m = 256
    with _X64():
        forms, box = _plans(name, "f64")
        plan, pk = forms["pk"]
        ints, lanes, cts = _lanes(m, plan, box, seed=13)
        gitem, px, py, fresh, alive, depth = ints
        f = lambda x: jnp.asarray(x, jnp.float64)

        def fn(pk, o, d, time, rad, tp):
            out = jb.step(plan, pk, jnp.asarray(gitem), f(px), f(py),
                          jnp.asarray(fresh), jnp.asarray(alive),
                          jnp.asarray(depth), o, d, time, rad, tp)
            return out[:5], out[5]

        _, vjp, scattering = jax.vjp(fn, f(pk), *_split([f(x) for x in lanes]),
                                     has_aux=True)
        want = [np.asarray(g) for g in jax.tree.leaves(
            vjp(_split([f(x) for x in cts])))]
        scattering = np.asarray(scattering)
    assert scattering.any() and not scattering.all()
    g = lambda x: torch.tensor(np.asarray(x), dtype=torch.float64)
    got = tb.step_vjp(_t_plan(plan), g(pk), torch.as_tensor(gitem), g(px),
                      g(py), torch.as_tensor(fresh), torch.as_tensor(alive),
                      torch.as_tensor(depth), *_split([g(x) for x in lanes]),
                      *_split([g(x) for x in cts]))
    got = [x.numpy() for x in (got[0], *got[1], *got[2], got[3], *got[4],
                               *got[5])]
    assert len(got) == len(want) == 14
    # the sphere block takes gradient: centres, radii, albedos
    sph = want[0][plan.sph_base:plan.lgt_base].reshape(-1, tb.SPH_SIZE)
    assert np.abs(sph[:, tb.S_C0:tb.S_C0 + 3]).max() > 0
    assert np.abs(sph[:, tb.S_R]).max() > 0
    if plan.has_moving:
        assert np.abs(sph[:, tb.S_C1:tb.S_C1 + 3]).max() > 0
        assert np.abs(want[7]).max() > 0            # the time cotangent
    tol = 1e-10 if name == "random" else 1e-12
    for k, (a, b) in enumerate(zip(got, want)):
        assert np.isfinite(a).all(), k
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=tol * float(np.abs(b).max()),
                                   err_msg=f"cotangent {k}")


@pytest.mark.parametrize("name,spp", [("three_spheres", 2), ("random", 1)])
def test_render_f64_matches_jax_pool(name, spp):
    kw = dict(nx=16, ny=16, spp=spp, max_depth=100, seed=0, dtype="f64")
    with _X64():
        spec = j_scenes.SCENES[name]()
        j_scene = j_build.compile_scene(spec.objects, sky=spec.sky,
                                        dtype=jnp.float64)
        j_cam = spec.camera(dtype=jnp.float64, aspect=1.0)
        cfg = JConfig(**kw)
        st, j_segs, j_iters = j_render.render_with_stats(
            j_scene, j_cam, cfg, j_render.init_state(cfg))
        j_img, j_segs, j_iters = (np.asarray(st.raw_sum), int(j_segs),
                                  int(j_iters))
        scene, cam = _port_scene(*_arrays(j_scene, j_cam), torch.float64)
    cfg = TConfig(**kw)
    st, segs, iters = t_render.render_with_stats(
        scene, cam, cfg, t_render.init_state(cfg, device="cpu"))
    assert int(segs) == j_segs
    assert iters == j_iters
    np.testing.assert_allclose(st.raw_sum.numpy(), j_img, rtol=1e-9,
                               atol=1e-9)
    assert j_img.max() > 0


DIFF_CFG = dict(nx=16, ny=16, spp=2, max_depth=8, pool_rays=256, dtype="f64")


@pytest.fixture(scope="module")
def jax_diff_reference():
    """The f64 JAX render_diff_fused of three_spheres on DIFF_CFG, its
    jax.grad, and the scene and camera as numpy arrays."""
    with _X64():
        spec = j_scenes.three_spheres()
        scene = j_build.compile_scene(spec.objects, sky=spec.sky,
                                      dtype=jnp.float64)
        cam = spec.camera(dtype=jnp.float64, aspect=1.0)
        cfg = JConfig(**DIFF_CFG)
        n_iters = j_diff.calibrate_iters(scene, cam, cfg)
        params, rest = j_build.partition(scene)

        def loss(p, c):
            raw, segs, leftover = j_diff.render_diff_fused(
                j_build.combine(p, rest), c, cfg, n_iters)
            return jnp.mean(raw), (raw, segs, leftover)

        (_, (raw, segs, leftover)), (g_par, g_cam) = jax.jit(
            jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
                params, cam)
        arrays, meta, cam_arrays = _arrays(scene, cam)
        return dict(
            n_iters=n_iters, raw=np.asarray(raw), segments=int(segs),
            leftover=int(leftover),
            grads={k: np.asarray(v) for k, v in g_par.items()},
            grad_lookfrom=np.asarray(g_cam.lookfrom),
            arrays=arrays, meta=meta, cam=cam_arrays)


def test_diff_render_matches_jax_and_forward(jax_diff_reference):
    ref = jax_diff_reference
    scene, cam = _port_scene(ref["arrays"], ref["meta"], ref["cam"],
                             torch.float64)
    cfg = TConfig(**DIFF_CFG)
    assert t_diff.calibrate_iters(scene, cam, cfg) == ref["n_iters"]
    with torch.no_grad():
        raw, segs, leftover = t_diff.render_diff_fused(scene, cam, cfg,
                                                       ref["n_iters"])
    assert int(leftover) == ref["leftover"] == 0
    assert int(segs) == ref["segments"]
    np.testing.assert_allclose(raw.numpy(), ref["raw"], rtol=1e-12,
                               atol=1e-12)
    st, f_segs, _ = t_render.render_with_stats(
        scene, cam, cfg, t_render.init_state(cfg, device="cpu"))
    assert int(f_segs) == int(segs)
    assert torch.equal(raw, st.raw_sum.reshape(-1, 3))


def test_diff_render_grads_match_jax_grad(jax_diff_reference):
    ref = jax_diff_reference
    scene, cam = _port_scene(ref["arrays"], ref["meta"], ref["cam"],
                             torch.float64)
    params, rest = t_build.partition(scene)
    params = {k: v.clone().requires_grad_() for k, v in params.items()}
    cam = dataclasses.replace(cam,
                              lookfrom=cam.lookfrom.clone().requires_grad_())
    raw, _, leftover = t_diff.render_diff_fused(
        t_build.combine(params, rest), cam, TConfig(**DIFF_CFG),
        ref["n_iters"])
    assert int(leftover) == 0
    leaves = [*params.values(), cam.lookfrom]
    grads = torch.autograd.grad(raw.mean(), leaves, allow_unused=True)
    assert set(params) == set(ref["grads"])
    want = {**ref["grads"], "lookfrom": ref["grad_lookfrom"]}
    for name, leaf, g in zip([*params, "lookfrom"], leaves, grads):
        g = np.zeros(leaf.shape) if g is None else g.numpy()
        w = want[name]
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-12 * np.abs(w).max(initial=0.0),
                                   err_msg=name)
    for name in ("sph_c0", "sph_r", "tex_color", "sky_a", "lookfrom"):
        assert np.abs(want[name]).max() > 0, name


@pytest.mark.parametrize("golden,scene_fn,spp", [
    ("config1_three_spheres", t_scenes.three_spheres, 10),
    ("config2_rtow_final", lambda: t_scenes.random_scene(seed=0), 4)])
def test_render_f32_matches_golden(golden, scene_fn, spp):
    spec = scene_fn()
    scene = t_build.compile_scene(spec.objects, sky=spec.sky, device="cpu")
    cam = spec.camera(aspect=1.0, device="cpu")
    cfg = TConfig(nx=64, ny=64, spp=spp, max_depth=100, seed=0)
    mean, state = t_render.render_image(scene, cam, cfg)
    assert mean.dtype == torch.float32 and int(state.sample_count) == spp
    ref = np.load(os.path.join(GOLDENS, golden + ".npz"))["image"]
    img = mean.numpy().astype(np.float64)
    assert img.shape == ref.shape and np.isfinite(img).all()
    diff = np.abs(img - ref)
    assert diff.mean() < 5e-3, diff.mean()
    assert (diff.max(axis=-1) > 0.05).mean() < 0.01


def test_strided_pools_match_fifo_on_spheres():
    spec = t_scenes.three_spheres()
    scene = t_build.compile_scene(spec.objects, sky=spec.sky, device="cpu")
    cam = spec.camera(aspect=1.0, device="cpu")
    cfg = TConfig(nx=16, ny=16, spp=2, max_depth=6, pool_rays=128)
    raw0 = torch.rand(cfg.n_pixels, 3,
                      generator=torch.Generator().manual_seed(0))
    want, w_segs, w_iters = t_strided.render_pool_strided(scene, cam, cfg,
                                                          raw0, 2)
    for fn in (t_packed.render_pool_packed, t_persist.render_pool_persistent):
        raw, segs, iters = fn(scene, cam, cfg, raw0, 2)
        assert int(segs) == int(w_segs), fn.__name__
        assert torch.equal(raw, want), fn.__name__
        assert iters >= w_iters
    fifo, f_segs, _ = t_fused.render_pool_fused(scene, cam, cfg, raw0, 2)
    assert int(f_segs) == int(w_segs)
    np.testing.assert_allclose(want.numpy(), fifo.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert float((want - raw0).abs().max()) > 0


def test_pool_plan_drops_the_attribute_atlas():
    spec = t_scenes.random_scene(seed=0)
    scene = t_build.compile_scene(spec.objects, sky=spec.sky, device="cpu")
    cam = spec.camera(aspect=1.0, device="cpu")
    cfg = TConfig(nx=8, ny=8, spp=1)
    full = tb.make_plan(scene, cfg)
    plan = tb.pool_plan(scene, cfg)
    assert full.attr_sweep and full.n_spheres == 227 and full.size == 4794
    assert not plan.has_atlas
    assert plan == dataclasses.replace(full, attr_sweep=False)
    pk, atlas = tb.pack(scene, cam, full, torch.float32)
    assert torch.equal(tb.pack(scene, cam, plan, torch.float32), pk)
    assert atlas.shape == (full.atlas_rows, 128)
