"""PyTorch port, textures and smoke against the JAX package (CPU).

The same numpy-seeded inputs go through the JAX function and the port's:

  * `scene/perlin.py`: `_hash_grad` bit for bit, `noise_xyz` and `turb_xyz`
    within 1e-12 (f64) and 1e-5 (f32) on 4,096 points of [-50, 50]^3 with
    negative and exact-lattice coordinates, for three seeds;
  * the plain `bounce.step` against the JAX `bounce.step` on `textured`
    (BASELINE config 3: checker, marble, image and noise spheres),
    `simple_light` (marble ground and sphere, a sphere light and an xy-rect
    emitter, light sampling on) and `cornell_smoke` (two constant media,
    light sampling on and off), 256 lanes with fresh, live and dead lanes and
    depths at the cap.  f64: the same scattering decisions and every output
    within 1e-10 (XLA's CPU compiler contracts products and sums into FMAs;
    the ground spheres' quadratic cancels).  f32: rtol 1e-4 / atol 1e-3 on
    all but one lane in a thousand, scattering included.  And against the
    Pallas kernel in interpret mode on `textured` and `cornell_smoke`;
  * the arctangent: the JAX step takes a polynomial `_atan2` (a Mosaic
    workaround, up to 4e-8 rad off) for a sphere's surface coordinates, the
    port the true `torch.atan2`.  u then differs by up to 6e-9, and a lane
    whose `u * iw` or `(1 - v) * ih - 0.001` lies within 1e-6 of an integer
    may read the neighbouring texel.  Such lanes are left out of the step
    and VJP comparisons; each test asserts how many it left out (none, with
    these seeds);
  * `bounce.step_vjp` against `jax.vjp` of the JAX step on the same scenes
    in f64: every cotangent within 1e-10 of that output's largest, the
    image texels' included;
  * f64 `render_with_stats` at 16^2 spp2 on the three scenes against the JAX
    pool: image within 1e-9, exact segments and iterations; the three strided
    pools against the FIFO pool on `textured` and `cornell_smoke`;
  * f64 `render_diff_fused` on `textured` and `cornell_smoke` at 16^2 spp2,
    depth 12, against the JAX one and `jax.grad`: image, segments, leftover,
    and the gradient of every float scene leaf (the image texels, the
    texture scales, the media's bounds and densities among them) and the
    camera's lookfrom within 1e-12 of the leaf's largest on `cornell_smoke`
    and 1e-10 on `textured` (its radius-100 ground sphere feeds 1/sqrt(disc)
    in the adjoint, as the RTOW ground does in tests/test_torch_spheres.py);
  * the f32 64^2 spp4 render of `textured` against the config-3 golden with
    the bounds of tests/test_parity.py.

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
from scheme_raytrace_tpu.scene import perlin as j_perlin
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
from scheme_raytrace_torch.scene import perlin as t_perlin

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
M = 256           # lanes of the step comparisons
MAX_FLIP_FRAC = 1e-3

# name -> the box the lane origins are drawn from
SCENES = {
    "textured": ((-2, -0.4, -3), (2, 1.5, 2)),
    "simple_light": ((-6, 0.0, -6), (6, 9, 6)),
    "cornell_smoke": ((0, 0, 0), (555, 555, 555)),
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


# --- scene/perlin.py ---------------------------------------------------------


def _points(seed, n=4096):
    """Points of [-50, 50]^3: random ones, some on exact lattice coordinates
    (negative ones too), some just below and above them."""
    r = np.random.default_rng(seed)
    p = r.uniform(-50.0, 50.0, (3, n))
    k = n // 8
    p[:, :k] = r.integers(-50, 51, (3, k))
    p[0, k:2 * k] = r.integers(-50, 51, k)
    p[1, 2 * k:3 * k] = np.nextafter(r.integers(-50, 51, k).astype(float), -99)
    p[2, 3 * k:4 * k] = np.nextafter(r.integers(-50, 51, k).astype(float), 99)
    return p


@pytest.mark.parametrize("seed", [0, 7, 0x9E3779B9])
def test_hash_grad_is_bit_exact(seed):
    r = np.random.default_rng(seed & 0xFFFF)
    ijk = r.integers(-2 ** 31, 2 ** 31, (3, 4096), dtype=np.int64).astype(
        np.int32)
    ijk[:, :8] = [[0, -1, 1, -2 ** 31, 2 ** 31 - 1, -50, 50, 7]] * 3
    want = j_perlin._hash_grad(*(jnp.asarray(x) for x in ijk), seed)
    got = t_perlin._hash_grad(*(torch.as_tensor(x) for x in ijk), seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.uint32),
                                      np.asarray(w))


@pytest.mark.parametrize("dtype_name", ["f64", "f32"])
@pytest.mark.parametrize("seed", [0, 7, 0x9E3779B9])
def test_perlin_matches_jax(seed, dtype_name):
    f64 = dtype_name == "f64"
    p = _points(seed & 0xFFFF)
    with _X64(f64):
        j_dt = jnp.float64 if f64 else jnp.float32
        jp = [jnp.asarray(x, j_dt) for x in p]
        want_n = np.asarray(j_perlin.noise_xyz(seed, *jp))
        want_t = np.asarray(j_perlin.turb_xyz(seed, *jp))
        want_a = np.asarray(j_perlin.turb(seed, jnp.stack(jp, -1)))
    t_dt = torch.float64 if f64 else torch.float32
    tp = [torch.tensor(x, dtype=t_dt) for x in p]
    got_n = t_perlin.noise_xyz(seed, *tp).numpy()
    got_t = t_perlin.turb_xyz(seed, *tp).numpy()
    tol = 1e-12 if f64 else 1e-5
    np.testing.assert_allclose(got_n, want_n, rtol=0, atol=tol)
    np.testing.assert_allclose(got_t, want_t, rtol=0, atol=tol)
    np.testing.assert_allclose(
        t_perlin.turb(seed, torch.stack(tp, -1)).numpy(), want_a, rtol=0,
        atol=tol)
    np.testing.assert_array_equal(
        t_perlin.noise(seed, torch.stack(tp, -1)).numpy(), got_n)
    assert np.abs(got_n).max() > 0.3 and np.abs(got_n).max() <= 1.0
    assert (got_n[:512] == 0).all()           # zero at lattice points


# --- the step and its VJP ------------------------------------------------


def _jax_scene(name, dtype_name):
    dt = jnp.float64 if dtype_name == "f64" else jnp.float32
    spec = j_scenes.SCENES[name]()
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


def _lanes(m, plan, box, seed):
    """Numpy draws of the step's inputs: random gitems (negatives included),
    fresh/alive masks, depths with some at the cap, origins inside `box`,
    unit directions, nonzero radiance and throughput; and normal cotangents
    for the 13 float outputs."""
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


def _map_pk(pk, f):
    return tuple(f(x) for x in pk) if isinstance(pk, tuple) else f(pk)


def _jax_step(plan, pk, ints, lanes, dt, fn=None):
    gitem, px, py, fresh, alive, depth = ints
    f = lambda x: jnp.asarray(x, dt)
    out = (fn or jb.step)(plan, _map_pk(pk, f), jnp.asarray(gitem), f(px),
                          f(py), jnp.asarray(fresh), jnp.asarray(alive),
                          jnp.asarray(depth), *_split([f(x) for x in lanes]))
    return _flat(out, np.asarray)


def _torch_args(ints, lanes, dt):
    gitem, px, py, fresh, alive, depth = ints
    g = lambda x: torch.tensor(np.asarray(x), dtype=dt)
    return (torch.as_tensor(gitem), g(px), g(py), torch.as_tensor(fresh),
            torch.as_tensor(alive), torch.as_tensor(depth),
            *_split([g(x) for x in lanes]))


class _TexelSpy:
    """Wraps bounce._texel for one step call and marks the lanes whose texel
    index lies within 1e-6 of a texel boundary: the lanes on which the JAX
    step's polynomial arctangent and torch.atan2 may pick different texels."""

    def __init__(self, monkeypatch):
        self.near = None
        orig = tb._texel

        def spy(plan, atlas, rec, uv):
            iw, ih, _ = rec["alb0"]
            a = (uv[0] * iw).detach().numpy()
            b = ((1.0 - uv[1]) * ih - 0.001).detach().numpy()
            is_img = (rec["texk"] == 4.0).numpy()
            off = lambda x: np.abs(x - np.round(x))
            self.near = is_img & ((off(a) < 1e-6) | (off(b) < 1e-6))
            self.n_img = int(is_img.sum())
            return orig(plan, atlas, rec, uv)

        monkeypatch.setattr(tb, "_texel", spy)

    def keep(self, m):
        """The lanes to compare, all of them for a plan without images."""
        return np.ones(m, bool) if self.near is None else ~self.near


def _plan_pk(name, dtype_name, light_sampling=True):
    """The JAX pool plan (no attribute atlas) and `pack`'s result as numpy."""
    j_scene, j_cam = _jax_scene(name, dtype_name)
    dt = jnp.float64 if dtype_name == "f64" else jnp.float32
    cfg = JConfig(nx=16, ny=16, spp=1, max_depth=8, dtype=dtype_name,
                  light_sampling=light_sampling)
    plan = jb.make_plan(j_scene, cfg)
    assert not plan.attr_sweep
    return plan, _map_pk(jb.pack(j_scene, j_cam, plan, dt), np.asarray)


STEP_CASES = [("textured", False), ("simple_light", True),
              ("cornell_smoke", True), ("cornell_smoke", False)]
STEP_IDS = ["textured", "simple_light", "smoke-light", "smoke-cosine"]


@pytest.mark.parametrize("dtype_name", ["f64", "f32"])
@pytest.mark.parametrize("name,light", STEP_CASES, ids=STEP_IDS)
def test_step_matches_jax(name, light, dtype_name, monkeypatch):
    f64 = dtype_name == "f64"
    t_dt = torch.float64 if f64 else torch.float32
    with _X64(f64):
        plan, pk = _plan_pk(name, dtype_name, light)
        assert plan.light_sampling == (light and name != "textured")
        assert plan.has_image == plan.has_atlas == (name == "textured")
        assert plan.has_perlin == (name != "cornell_smoke")
        assert plan.n_media == (2 if name == "cornell_smoke" else 0)
        ints, lanes, _ = _lanes(M, plan, SCENES[name], seed=21)
        want, w_sc = _jax_step(plan, pk, ints, lanes,
                               jnp.float64 if f64 else jnp.float32)
    spy = _TexelSpy(monkeypatch)
    got, g_sc = _flat(tb.step(_t_plan(plan), _map_pk(
        pk, lambda x: torch.tensor(x, dtype=t_dt)), *_torch_args(
            ints, lanes, t_dt)), lambda x: x.numpy())
    keep = spy.keep(M)
    assert (~keep).sum() == 0, int((~keep).sum())    # lanes left out
    if name == "textured":
        assert spy.n_img > 5
    assert g_sc.any() and not g_sc.all() and np.isfinite(got).all()
    if f64:
        np.testing.assert_array_equal(g_sc[keep], w_sc[keep])
        np.testing.assert_allclose(got[:, keep], want[:, keep], rtol=1e-10,
                                   atol=1e-10)
    else:
        bad = (g_sc != w_sc) | (np.abs(got - want)
                                > 1e-3 + 1e-4 * np.abs(want)).any(0)
        assert (bad & keep).sum() <= max(1, MAX_FLIP_FRAC * M), int(bad.sum())


def test_media_scatter_before_the_walls():
    # a medium event overrides the solid hit only when it comes first: the
    # lanes that scatter with and without the media travel no further with
    # them, and some of them stop short, inside a box of smoke
    with _X64():
        plan, pk = _plan_pk("cornell_smoke", "f64")
    ints, lanes, _ = _lanes(1024, plan, SCENES["cornell_smoke"], seed=22)
    ints = (*ints[:3], np.zeros(1024, bool), *ints[4:])     # given rays
    args = _torch_args(ints, lanes, torch.float64)
    pk = torch.tensor(pk)
    with_media = tb.step(_t_plan(plan), pk, *args)
    without = tb.step(dataclasses.replace(_t_plan(plan), n_media=0), pk,
                      *args)
    both = (with_media[5] & without[5]).numpy()
    o = np.stack(lanes[:3])
    dist = lambda out: np.linalg.norm(
        np.stack([x.numpy() for x in out[0]]) - o, axis=0)[both]
    assert (dist(with_media) <= dist(without) + 1e-9).all()
    short = dist(with_media) < dist(without) - 1e-6
    assert 10 < short.sum() < both.sum()


@pytest.mark.parametrize("name,m", [("textured", 128), ("cornell_smoke", 128)])
def test_step_matches_pallas_interpret(name, m, monkeypatch):
    plan, pk = _plan_pk(name, "f32")
    ints, lanes, _ = _lanes(m, plan, SCENES[name], seed=23)
    want, w_sc = _jax_step(plan, pk, ints, lanes, jnp.float32,
                           fn=jb.as_pallas(plan, m, interpret=True))
    spy = _TexelSpy(monkeypatch)
    got, g_sc = _flat(tb.step(_t_plan(plan), _map_pk(pk, torch.tensor),
                              *_torch_args(ints, lanes, torch.float32)),
                      lambda x: x.numpy())
    keep = spy.keep(m)
    assert (~keep).sum() == 0
    bad = (g_sc != w_sc) | (np.abs(got - want)
                            > 1e-3 + 1e-4 * np.abs(want)).any(0)
    assert (bad & keep).sum() <= 1, int(bad.sum())   # one f32 flip of 128


@pytest.mark.parametrize("name", sorted(SCENES))
def test_step_vjp_matches_jax_vjp(name, monkeypatch):
    with _X64():
        plan, pk = _plan_pk(name, "f64")
        ints, lanes, cts = _lanes(M, plan, SCENES[name], seed=24)
        gitem, px, py, fresh, alive, depth = ints
        f = lambda x: jnp.asarray(x, jnp.float64)

        def fn(pk, o, d, time, rad, tp):
            out = jb.step(plan, pk, jnp.asarray(gitem), f(px), f(py),
                          jnp.asarray(fresh), jnp.asarray(alive),
                          jnp.asarray(depth), o, d, time, rad, tp)
            return out[:5], out[5]

        _, vjp, scattering = jax.vjp(
            fn, _map_pk(pk, f), *_split([f(x) for x in lanes]), has_aux=True)
        want = [np.asarray(g) for g in jax.tree.leaves(
            vjp(_split([f(x) for x in cts])))]
        scattering = np.asarray(scattering)
    assert scattering.any() and not scattering.all()
    g = lambda x: torch.tensor(np.asarray(x), dtype=torch.float64)
    spy = _TexelSpy(monkeypatch)
    got = tb.step_vjp(_t_plan(plan), _map_pk(pk, g),
                      *_torch_args(ints, lanes, torch.float64),
                      *_split([g(x) for x in cts]))
    assert (~spy.keep(M)).sum() == 0
    dpk = got[0] if plan.has_atlas else (got[0],)
    got = [x.numpy() for x in (*dpk, *got[1], *got[2], got[3], *got[4],
                               *got[5])]
    n_pk = len(dpk)
    assert len(got) == len(want) == 13 + n_pk
    if name == "textured":
        assert want[1].shape == (plan.img_rows, 128) == (6, 128)
        assert np.abs(want[1]).max() > 0            # the texels' cotangent
    if name != "cornell_smoke":                     # the texture scales'
        sph = want[0][plan.sph_base:plan.lgt_base].reshape(-1, tb.SPH_SIZE)
        assert np.abs(sph[:, tb.S_TEXS]).max() > 0
    for k, (a, b) in enumerate(zip(got, want)):
        assert np.isfinite(a).all(), k
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-10 * float(np.abs(b).max()),
                                   err_msg=f"cotangent {k}")


def test_bounce_step_function_carries_the_atlas():
    # BounceStep with the plain pair: the atlas is a differentiable input
    plan, pk = _plan_pk("textured", "f32")
    plan = _t_plan(plan)
    ints, lanes, cts = _lanes(M, plan, SCENES["textured"], seed=25)
    pk = tuple(torch.tensor(x).requires_grad_() for x in pk)
    args = _torch_args(ints, lanes, torch.float32)
    out = tb.step_with_vjp((tb.step, tb.step_vjp), plan, pk, *args)
    want = tb.step(plan, pk, *args)
    assert torch.equal(out[5], want[5])
    loss = lambda o: sum((x * torch.tensor(c, dtype=torch.float32)).sum()
                         for x, c in zip(tb.flat_lanes(*o[:5]), cts))
    got_g = torch.autograd.grad(loss(out), pk)
    want_g = torch.autograd.grad(loss(want), pk)
    for a, b in zip(got_g, want_g):
        assert torch.equal(a, b)
    assert float(got_g[1].abs().max()) > 0


# --- renders --------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_f64_matches_jax_pool(name):
    kw = dict(nx=16, ny=16, spp=2, max_depth=100, seed=0, dtype="f64",
              light_sampling=name != "textured")
    with _X64():
        j_scene, j_cam = _jax_scene(name, "f64")
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


@pytest.mark.parametrize("name", ["textured", "cornell_smoke"])
def test_strided_pools_match_fifo(name):
    spec = t_scenes.SCENES[name]()
    scene = t_build.compile_scene(spec.objects, sky=spec.sky, device="cpu")
    cam = spec.camera(aspect=1.0, device="cpu")
    cfg = TConfig(nx=16, ny=16, spp=2, max_depth=6, pool_rays=128,
                  light_sampling=name != "textured")
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


DIFF_CFG = dict(nx=16, ny=16, spp=2, max_depth=12, pool_rays=256, dtype="f64")


@pytest.fixture(scope="module", params=["textured", "cornell_smoke"])
def jax_diff_reference(request):
    """The f64 JAX render_diff_fused of one scene on DIFF_CFG, its jax.grad,
    and the scene and camera as numpy arrays."""
    name = request.param
    with _X64():
        scene, cam = _jax_scene(name, "f64")
        cfg = JConfig(**DIFF_CFG, light_sampling=name != "textured")
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
            name=name, n_iters=n_iters, raw=np.asarray(raw),
            segments=int(segs), leftover=int(leftover),
            grads={k: np.asarray(v) for k, v in g_par.items()},
            grad_lookfrom=np.asarray(g_cam.lookfrom),
            arrays=arrays, meta=meta, cam=cam_arrays)


def _diff_cfg(name):
    return TConfig(**DIFF_CFG, light_sampling=name != "textured")


def test_diff_render_matches_jax_and_forward(jax_diff_reference):
    ref = jax_diff_reference
    scene, cam = _port_scene(ref["arrays"], ref["meta"], ref["cam"],
                             torch.float64)
    cfg = _diff_cfg(ref["name"])
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
        t_build.combine(params, rest), cam, _diff_cfg(ref["name"]),
        ref["n_iters"])
    assert int(leftover) == 0
    leaves = [*params.values(), cam.lookfrom]
    grads = torch.autograd.grad(raw.mean(), leaves, allow_unused=True)
    assert set(params) == set(ref["grads"])
    want = {**ref["grads"], "lookfrom": ref["grad_lookfrom"]}
    # textured's radius-100 ground sphere feeds 1 / sqrt(disc) in the adjoint
    tol = 1e-10 if ref["name"] == "textured" else 1e-12
    for name, leaf, g in zip([*params, "lookfrom"], leaves, grads):
        g = np.zeros(leaf.shape) if g is None else g.numpy()
        w = want[name]
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=tol * np.abs(w).max(initial=0.0),
                                   err_msg=name)
    moved = (("images", "tex_scale", "sph_c0", "sky_a", "lookfrom")
             if ref["name"] == "textured"
             else ("med_neg_inv_d", "med_pmin", "med_pmax", "tex_color",
                   "rect_k", "lookfrom"))
    for name in moved:
        assert np.abs(want[name]).max() > 0, name


def test_render_f32_matches_config3_golden():
    spec = t_scenes.textured_scene()
    scene = t_build.compile_scene(spec.objects, sky=spec.sky, device="cpu")
    cam = spec.camera(aspect=1.0, device="cpu")
    cfg = TConfig(nx=64, ny=64, spp=4, max_depth=100, seed=0)
    mean, state = t_render.render_image(scene, cam, cfg)
    assert mean.dtype == torch.float32 and int(state.sample_count) == 4
    ref = np.load(os.path.join(GOLDENS, "config3_textured.npz"))["image"]
    img = mean.numpy().astype(np.float64)
    assert img.shape == ref.shape and np.isfinite(img).all()
    diff = np.abs(img - ref)
    assert diff.mean() < 5e-3, diff.mean()
    assert (diff.max(axis=-1) > 0.05).mean() < 0.01
