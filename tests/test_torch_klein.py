"""PyTorch port, the klein scenes against the JAX package (CPU).

The same numpy-seeded inputs go through the JAX function and the port's:

  * the plain `bounce.step` against the JAX `bounce.step` on `klein` (a
    ground sphere of radius 1000 and the fractal, the camera inside its
    solid) and `cornell_klein` (the Cornell walls, a wide light and the
    fractal; light sampling on), 256 lanes with fresh, live and dead lanes
    and depths at the cap, aimed at the fractal from outside its precull
    ball, one in ten born near its centre (inside the solid: the march
    retires them backward-stuck), some grazing it; the lanes that end on the
    klein, stick, and retire otherwise are counted and asserted.  f64:
    the same scattering decisions and every output within 1e-9.  f32: rtol
    1e-4 / atol 1e-3 on all but 1% of the lanes, scattering included;
  * `bounce.step_vjp` against `jax.vjp` of the JAX step in f64: every
    cotangent within 1e-10 of that output's largest (every lane finite on
    both sides, asserted), the klein's centre slots nonzero;
  * the hit t's gradient in the klein's centre against central finite
    differences of the root the estimator differentiates (DE = eps along the
    ray, solved by Newton from the march's t);
  * the march's bounds: KLEIN_PRECULL_R and KLEIN_RECEDE_R, the JAX step's
    726 and 900, hold what the KLEIN_* constants imply;
  * f64 `render_with_stats` at 16^2 spp2 depth 6 on `cornell_klein` against
    the JAX pool: image within 1e-9, exact segments and iterations; the
    three strided pools against the FIFO pool on both scenes (8^2 spp2);
  * f64 `render_diff_fused` on `cornell_klein` at 8^2 spp1 depth 4 against
    `jax.grad`: every float leaf within 1e-10 of its largest, `kl_center`
    nonzero (marked slow: the JAX gradient's compile); and, in tier 1, the
    port's AD against central finite differences on the klein's centre
    where the estimator's normal holds (chip_smoke.py's KLEIN_FD_CFG
    window).

The kernels run these scenes only on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import dataclasses
import pathlib

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
from scheme_raytrace_torch import config as t_config
from scheme_raytrace_torch import render as t_render
from scheme_raytrace_torch import scenes as t_scenes
from scheme_raytrace_torch.camera import CAMERA_FIELDS, camera_from_arrays
from scheme_raytrace_torch.config import RenderConfig as TConfig
from scheme_raytrace_torch.integrator import bounce as tb
from scheme_raytrace_torch.integrator import diff_fused as t_diff
from scheme_raytrace_torch.integrator import persist as t_persist
from scheme_raytrace_torch.integrator import pool as t_pool
from scheme_raytrace_torch.integrator import pool_fused as t_fused
from scheme_raytrace_torch.integrator import pool_packed as t_packed
from scheme_raytrace_torch.integrator import pool_strided as t_strided
from scheme_raytrace_torch.scene import build as t_build

M = 256           # lanes of the step comparisons
MAX_FLIP_FRAC = 1e-2

# name -> (JAX spec function, light sampling)
SCENES = {"klein": (j_scenes.klein_scene, False),
          "cornell_klein": (j_scenes.cornell_klein, True)}


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
    spec = SCENES[name][0]()
    scene = j_build.compile_scene(spec.objects, sky=spec.sky, dtype=dt)
    return scene, spec.camera(dtype=dt, aspect=1.0)


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


def _plan_pk(name, dtype_name):
    """The JAX pool plan, `pack`'s result as numpy, and the klein's
    centre."""
    j_scene, j_cam = _jax_scene(name, dtype_name)
    dt = jnp.float64 if dtype_name == "f64" else jnp.float32
    cfg = JConfig(nx=16, ny=16, spp=1, max_depth=8, dtype=dtype_name,
                  light_sampling=SCENES[name][1])
    plan = jb.make_plan(j_scene, cfg)
    assert not plan.has_atlas and plan.n_kleins == 1
    return (plan, np.asarray(jb.pack(j_scene, j_cam, plan, dt)),
            np.asarray(j_scene.kl_center, np.float64)[0])


def _lanes(m, plan, c, seed):
    """Numpy draws of the step's inputs: random gitems (negatives included),
    fresh/alive masks, depths with some at the cap; origins outside the
    march's precull ball about the klein's centre c on the cameras' side,
    aimed at random points within 300 of c, one lane in ten born within 100
    of c; nonzero radiance and throughput; and normal cotangents for the 13
    float outputs."""
    r = np.random.default_rng(seed)
    gitem = r.integers(-2 ** 31, 2 ** 31, m, dtype=np.int64).astype(np.int32)
    px = r.integers(0, plan.nx, m).astype(np.float64)
    py = r.integers(0, plan.ny, m).astype(np.float64)
    fresh = r.random(m) < 0.2
    alive = fresh | (r.random(m) < 0.85)
    depth = r.integers(0, 4, m).astype(np.int32)
    depth[r.random(m) < 0.05] = plan.max_depth
    u = r.normal(size=(3, m))
    u[2] = -np.abs(u[2]) - 1.0
    u /= np.linalg.norm(u, axis=0)
    o = c[:, None] + u * r.uniform(730.0, 1000.0, m)
    inside = r.random(m) < 0.1
    o[:, inside] = c[:, None] + r.uniform(-100.0, 100.0,
                                          (3, int(inside.sum())))
    dvec = c[:, None] + r.uniform(-300.0, 300.0, (3, m)) - o
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


def _jax_step(plan, pk, ints, lanes, dt):
    gitem, px, py, fresh, alive, depth = ints
    f = lambda x: jnp.asarray(x, dt)
    out = jb.step(plan, f(pk), jnp.asarray(gitem), f(px), f(py),
                  jnp.asarray(fresh), jnp.asarray(alive), jnp.asarray(depth),
                  *_split([f(x) for x in lanes]))
    return _flat(out, np.asarray)


def _torch_args(ints, lanes, dt):
    gitem, px, py, fresh, alive, depth = ints
    g = lambda x: torch.tensor(np.asarray(x), dtype=dt)
    return (torch.as_tensor(gitem), g(px), g(py), torch.as_tensor(fresh),
            torch.as_tensor(alive), torch.as_tensor(depth),
            *_split([g(x) for x in lanes]))


def _klein_work(plan, pk, args):
    """The live lanes whose closest hit is the klein, and the plain march's
    counts on the live lanes (bounded by the rects' and spheres' hit)."""
    gitem, px, py, fresh, alive, depth, o, d, time = args[:9]
    o, d, _, rec0 = tb.hit_record(dataclasses.replace(plan, n_kleins=0), pk,
                                  gitem, px, py, fresh, depth, o, d, time)
    live = alive.nonzero()[:, 0]
    stats = dict(marching=0, steps=0, inversions=0, stuck=0, capped=0)
    c = tuple(pk[plan.kl_base + tb.K_C + i] for i in range(3))
    hit, _ = tb._klein_march(c, tuple(x[live] for x in o),
                             tuple(x[live] for x in d),
                             t_config.SHADOW_EPS, rec0["t"][live], stats)
    return int(hit.sum()), stats


# --- the step ---------------------------------------------------------------


@pytest.mark.parametrize("dtype_name", ["f64", "f32"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_step_matches_jax(name, dtype_name):
    f64 = dtype_name == "f64"
    t_dt = torch.float64 if f64 else torch.float32
    with _X64(f64):
        plan, pk, c = _plan_pk(name, dtype_name)
        assert jb.pallas_ok(plan) and tb.pallas_ok(_t_plan(plan))
        ints, lanes, _ = _lanes(M, plan, c, seed=31)
        want, w_sc = _jax_step(plan, pk, ints, lanes,
                               jnp.float64 if f64 else jnp.float32)
    args = _torch_args(ints, lanes, t_dt)
    t_plan, t_pk = _t_plan(plan), torch.tensor(pk, dtype=t_dt)
    got, g_sc = _flat(tb.step(t_plan, t_pk, *args), lambda x: x.numpy())
    hits, st = _klein_work(t_plan, t_pk, args)
    # hits, backward-stuck retirements (the lanes born in the solid), and
    # lanes retired past the closest hit or receding outside the ball
    others = st["marching"] - hits - st["stuck"] - st["capped"]
    assert hits >= 20 and st["stuck"] >= 10 and others >= 20, (hits, st)
    assert st["steps"] > 5 * st["marching"] and st["inversions"] > 0
    assert g_sc.any() and not g_sc.all() and np.isfinite(got).all()
    if f64:
        np.testing.assert_array_equal(g_sc, w_sc)
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    else:
        bad = (g_sc != w_sc) | (np.abs(got - want)
                                > 1e-3 + 1e-4 * np.abs(want)).any(0)
        assert bad.sum() <= MAX_FLIP_FRAC * M, int(bad.sum())


def test_every_scene_runs_through_the_port():
    # no scene raises any longer: every plan of scenes.SCENES is one the
    # kernels take (the klein scenes' variants carry the klein flag), and the
    # klein scenes render through the pool dispatch on the CPU
    for name, spec_fn in t_scenes.SCENES.items():
        spec = spec_fn()
        scene = t_build.compile_scene(spec.objects, sky=spec.sky,
                                      device="cpu")
        plan = tb.pool_plan(scene, TConfig(nx=8, ny=8, spp=1, max_depth=4))
        tb.check_kernel_plan(plan)
        assert ("klein" in tb.kernel_features(plan)) == bool(plan.n_kleins)
        if plan.n_kleins:
            cfg = TConfig(nx=8, ny=8, spp=1, max_depth=4,
                          light_sampling=scene.n_lights > 0)
            raw, segs, _ = t_pool.render_pool_auto(
                scene, spec.camera(aspect=1.0, device="cpu"), cfg,
                torch.zeros(64, 3), 0)
            assert int(segs) >= 64 and torch.isfinite(raw).all(), name


def test_march_bounds_hold_the_acceptance_set():
    # the JAX step's hard-coded bounds are the port's constants
    src = (pathlib.Path(jb.__file__).read_text())
    assert "726.0 * 726.0" in src and "900.0 * 900.0" in src
    assert (tb.KLEIN_PRECULL_R, tb.KLEIN_RECEDE_R) == (726.0, 900.0)
    assert tb._KLEIN_SPHERES == jb._KLEIN_SPHERES
    # every inversion ball B(s_i, r) lies inside |p - c| < 724.26 < 726 < 900
    reach = max(np.linalg.norm(s) for s in tb._KLEIN_SPHERES) \
        + t_config.KLEIN_SPHERE_R
    assert reach < tb.KLEIN_PRECULL_R < tb.KLEIN_RECEDE_R
    assert abs(reach - 724.26) < 0.01
    # outside every ball nothing inverts, and the DE 0.7 (|p - c| - 125) is
    # far above eps: no point between the balls' reach and the precull
    # radius can accept
    r = np.random.default_rng(5)
    u = r.normal(size=(3, 4096))
    u /= np.linalg.norm(u, axis=0)
    p = u * r.uniform(reach + 1e-6, tb.KLEIN_PRECULL_R, 4096)
    zero = torch.tensor(0.0, dtype=torch.float64)
    de = tb._klein_dist((zero,) * 3, *(torch.tensor(x) for x in p))
    want = t_config.KLEIN_DE_SCALE * (np.linalg.norm(p, axis=0)
                                      - t_config.KLEIN_R)
    np.testing.assert_allclose(de.numpy(), want, rtol=1e-12)
    assert float(de.min()) > 400.0 > t_config.KLEIN_SURF_EPS


# --- the VJP ----------------------------------------------------------------


def _jax_vjp(plan, pk, ints, lanes, cts):
    """jax.vjp of the JAX step in f64: [dpk, 13 lane cotangents]."""
    gitem, px, py, fresh, alive, depth = ints
    f = lambda x: jnp.asarray(x, jnp.float64)

    def fn(pk, o, d, time, rad, tp):
        out = jb.step(plan, pk, jnp.asarray(gitem), f(px), f(py),
                      jnp.asarray(fresh), jnp.asarray(alive),
                      jnp.asarray(depth), o, d, time, rad, tp)
        return out[:5], out[5]

    _, vjp, scattering = jax.vjp(fn, f(pk), *_split([f(x) for x in lanes]),
                                 has_aux=True)
    return ([np.asarray(g) for g in jax.tree.leaves(
        vjp(_split([f(x) for x in cts])))], np.asarray(scattering))


def _torch_vjp(plan, pk, ints, lanes, cts):
    g = lambda x: torch.tensor(np.asarray(x), dtype=torch.float64)
    got = tb.step_vjp(_t_plan(plan), g(pk),
                      *_torch_args(ints, lanes, torch.float64),
                      *_split([g(x) for x in cts]))
    return [x.numpy() for x in (got[0], *got[1], *got[2], got[3], *got[4],
                                *got[5])]


@pytest.mark.parametrize("name", sorted(SCENES))
def test_step_vjp_matches_jax_vjp(name):
    # the plain VJP differentiates _klein_dist_grad on every lane, misses
    # included; on these lanes no partial overflows in f64, so every lane is
    # finite on both sides and none is left out
    with _X64():
        plan, pk, c = _plan_pk(name, "f64")
        ints, lanes, cts = _lanes(M, plan, c, seed=33)
        want, scattering = _jax_vjp(plan, pk, ints, lanes, cts)
    assert scattering.any() and not scattering.all()
    got = _torch_vjp(plan, pk, ints, lanes, cts)
    assert len(got) == len(want) == 14
    for k, (a, b) in enumerate(zip(got, want)):
        assert np.isfinite(a).all() and np.isfinite(b).all(), k
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-10 * float(np.abs(b).max()),
                                   err_msg=f"cotangent {k}")
    kc = slice(plan.kl_base + tb.K_C, plan.kl_base + tb.K_C + 3)
    assert (got[0][kc] != 0).all() and (want[0][kc] != 0).all()


def _root(c, o, d, t):
    """The t where the DE along o + t d falls to eps: Newton from t."""
    ct = tuple(torch.tensor(float(x), dtype=torch.float64) for x in c)
    for _ in range(30):
        p = tuple(torch.tensor([o[i] + t * d[i]], dtype=torch.float64)
                  for i in range(3))
        de, g = tb._klein_dist_grad(ct, *p)
        slope = float(g[0][0] * d[0] + g[1][0] * d[1] + g[2][0] * d[2])
        t = t - (float(de[0]) - t_config.KLEIN_SURF_EPS) / slope
    return t


def test_hit_t_gradient_matches_fd_of_the_root():
    # the estimator attaches the implicit-function derivative of the root of
    # DE(o + t d - c) = eps at the march's t; central differences of that
    # root (Newton to convergence), lane by lane, through the plain step:
    # the cotangent picks t out of o' = o + t d
    c0 = np.array([250.0, 200.0, 280.0])
    r = np.random.default_rng(0)
    errs = []
    while len(errs) < 8:
        o = c0 + np.array([0.0, 0.0, -800.0]) + r.uniform(-50, 50, 3)
        tgt = c0 + r.uniform(-200, 200, 3)
        d = (tgt - o) / np.linalg.norm(tgt - o)
        pk = torch.zeros(tb.KL_SIZE, dtype=torch.float64)
        pk[tb.K_C:tb.K_C + 3] = torch.tensor(c0)
        pk[tb.K_VALID] = 1.0
        pk.requires_grad_()
        f = lambda v: tuple(torch.tensor([x], dtype=torch.float64) for x in v)
        ok, t, _ = tb._klein_hit(pk.unbind(0), 0, f(o), f(d),
                                 t_config.SHADOW_EPS,
                                 torch.tensor([1e12], dtype=torch.float64))
        if not bool(ok[0]):
            continue
        ad = torch.autograd.grad(t[0], pk)[0][tb.K_C:tb.K_C + 3].numpy()
        t0 = _root(c0, o, d, float(t[0].detach()))
        fd = np.array([(_root(c0 + 1e-5 * e, o, d, t0)
                        - _root(c0 - 1e-5 * e, o, d, t0)) / 2e-5
                       for e in np.eye(3)])
        assert np.abs(ad).max() > 0.1
        errs.append(np.abs(ad - fd).max() / np.abs(fd).max())
    # the derivative is taken at the march's t, a residual short of the
    # root: within 1% on every lane, and within 1e-4 on most
    assert max(errs) < 1e-2 and np.median(errs) < 1e-4, errs


# --- renders ----------------------------------------------------------------


def test_render_f64_matches_jax_pool():
    kw = dict(nx=16, ny=16, spp=2, max_depth=6, seed=0, dtype="f64",
              light_sampling=True)
    with _X64():
        j_scene, j_cam = _jax_scene("cornell_klein", "f64")
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


@pytest.mark.parametrize("name", sorted(SCENES))
def test_strided_pools_match_fifo(name):
    spec = t_scenes.SCENES[name]()
    scene = t_build.compile_scene(spec.objects, sky=spec.sky, device="cpu")
    cam = spec.camera(aspect=1.0, device="cpu")
    cfg = TConfig(nx=8, ny=8, spp=2, max_depth=6, pool_rays=64,
                  light_sampling=SCENES[name][1])
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


DIFF_CFG = dict(nx=8, ny=8, spp=1, max_depth=4, pool_rays=64, dtype="f64",
                light_sampling=True)


@pytest.mark.slow
def test_diff_render_grads_match_jax_grad():
    # the f64 JAX render_diff_fused of cornell_klein and its jax.grad: the
    # JAX gradient alone compiles for over a minute on a cold cache, so this
    # case is slow, as the JAX package's own klein diff_fused cases are
    # (tests/test_diff_fused.py); test_diff_render_kl_center_matches_fd keeps
    # an f64 check of the klein's gradient in tier 1
    with _X64():
        scene, cam = _jax_scene("cornell_klein", "f64")
        cfg = JConfig(**DIFF_CFG)
        n_iters = j_diff.calibrate_iters(scene, cam, cfg)
        params, rest = j_build.partition(scene)

        def loss(p):
            raw, segs, leftover = j_diff.render_diff_fused(
                j_build.combine(p, rest), cam, cfg, n_iters)
            return jnp.mean(raw), (raw, segs, leftover)

        (_, (j_raw, j_segs, j_left)), j_grads = jax.jit(
            jax.value_and_grad(loss, has_aux=True))(params)
        want = {k: np.asarray(v) for k, v in j_grads.items()}
        t_scene, t_cam = _port_scene(*_arrays(scene, cam), torch.float64)
    cfg = TConfig(**DIFF_CFG)
    assert t_diff.calibrate_iters(t_scene, t_cam, cfg) == n_iters
    t_params, t_rest = t_build.partition(t_scene)
    t_params = {k: v.clone().requires_grad_() for k, v in t_params.items()}
    raw, segs, leftover = t_diff.render_diff_fused(
        t_build.combine(t_params, t_rest), t_cam, cfg, n_iters)
    assert int(leftover) == int(j_left) == 0
    assert int(segs) == int(j_segs)
    np.testing.assert_allclose(raw.detach().numpy(), np.asarray(j_raw),
                               rtol=1e-12, atol=1e-12)
    grads = torch.autograd.grad(raw.mean(), list(t_params.values()),
                                allow_unused=True)
    assert set(t_params) == set(want)
    for name, leaf, g in zip(t_params, t_params.values(), grads):
        g = np.zeros(leaf.shape) if g is None else g.numpy()
        assert g.shape == want[name].shape and np.isfinite(g).all(), name
        np.testing.assert_allclose(
            g, want[name], rtol=0,
            atol=1e-10 * np.abs(want[name]).max(initial=0.0), err_msg=name)
    assert np.abs(want["kl_center"]).max() > 0


def test_diff_render_kl_center_matches_fd():
    # the port alone: f64 AD against central finite differences on the
    # klein's centre, on the window of chip_smoke.py's diff-klein phase
    # (one bounce, the centre's y, the pixels whose camera rays meet the
    # fractal where its normal holds: see KLEIN_FD_CFG there)
    spec = t_scenes.cornell_klein()
    scene = t_build.compile_scene(spec.objects, sky=spec.sky,
                                  dtype=torch.float64, device="cpu")
    cam = spec.camera(aspect=1.0, dtype=torch.float64, device="cpu")
    cfg = TConfig(nx=16, ny=16, spp=1, max_depth=1, seed=0, dtype="f64",
                  light_sampling=True)
    window = (2, 8, 10, 13)
    n_iters = t_diff.calibrate_iters(scene, cam, cfg)
    params, rest = t_build.partition(scene)

    def loss(p):
        raw, _, leftover = t_diff.render_diff_fused(
            t_build.combine(p, rest), cam, cfg, n_iters)
        assert int(leftover) == 0
        img = raw.reshape(cfg.ny, cfg.nx, 3)
        return img[window[0]:window[1], window[2]:window[3]].mean()

    leaf = params["kl_center"].clone().requires_grad_()
    ad = float(torch.autograd.grad(loss({**params, "kl_center": leaf}),
                                   leaf)[0][0, 1])

    def at(x):
        c = params["kl_center"].clone()
        c[0, 1] += x
        with torch.no_grad():
            return float(loss({**params, "kl_center": c}))

    fd = (at(1e-3) - at(-1e-3)) / 2e-3
    assert ad != 0.0 and abs(ad - fd) < 0.01 * abs(fd), (ad, fd)
