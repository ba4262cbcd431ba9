"""PyTorch port, the strided work pools against the JAX package.

  * `pool_strided.render_pool_strided` (plain step on the CPU) against the
    JAX `render_pool_strided` with the jnp step, on Cornell 8x8 spp2 depth
    6 with a 128-lane pool (tests/test_experimental_pools.py's config;
    m > n_pix, so two lanes can finish one pixel in one iteration) and on
    16x16 (m divides n_pix): f64 image within 1e-12 with the exact segment
    and iteration counts; f32 (8x8) image within rtol/atol 1e-5 with the
    exact segment count; the static form drains (leftover 0) and equals its
    own drain bitwise; its f64 gradient w.r.t. `tex_color` equals
    `jax.grad` of the JAX static form within 1e-12 of the largest entry;
  * `bounce.step_packed` against the JAX `as_pallas_packed` in interpret
    mode over three calls from the initial state, and
    `persist.chunk_plain` against the JAX persistent kernel (`_make_call`,
    T=2, interpret mode): int rows and segment counts exact, float rows
    within the f32 step bounds of tests/test_torch_bounce.py (rtol 1e-4,
    atol 1e-3) on all but at most one of the 128 lanes per call;
  * `render_pool_packed` and `render_pool_persistent` against the JAX FIFO
    pool `render_pool_fused` at 8x8: exact segments, image within
    rtol=atol=1e-5 (the bound of tests/test_experimental_pools.py: same
    paths, only the grouping of the framebuffer adds differs); at 16x16 the
    three strided pools equal each other bitwise (same paths, same order
    of adds) and the port's FIFO pool within that bound.

f32 and the JAX package.  XLA's CPU compiler contracts a*b + c into FMAs
and its transcendentals round differently from PyTorch's, so an f32 path
can take a branch the other way (ROADMAP C, "f32 branch flips"): at 16x16
the f32 strided pool traces 1432 segments in the port and 1435 in JAX.
Exact counts against JAX are held in f64, and in f32 at 8x8, where no path
flips; a flip moves a whole lane, hence the one-lane allowance of the
128-lane step comparisons.

The kernels themselves (K1, K3, K4) run only on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scheme_raytrace_tpu import scenes as j_scenes
from scheme_raytrace_tpu.config import RenderConfig as JConfig
from scheme_raytrace_tpu.integrator import bounce as jb
from scheme_raytrace_tpu.integrator import persist as j_persist
from scheme_raytrace_tpu.integrator import pool_fused as j_fused
from scheme_raytrace_tpu.integrator import pool_strided as j_strided
from scheme_raytrace_tpu.scene import build as j_build
from scheme_raytrace_torch.camera import CAMERA_FIELDS, camera_from_arrays
from scheme_raytrace_torch.config import RenderConfig as TConfig
from scheme_raytrace_torch.integrator import bounce as tb
from scheme_raytrace_torch.integrator import persist as t_persist
from scheme_raytrace_torch.integrator import pool_packed as t_packed
from scheme_raytrace_torch.integrator import pool_strided as t_strided
from scheme_raytrace_torch.scene import build as t_build

CFG = dict(spp=2, max_depth=6, light_sampling=True, pool_rays=128)
SIZES = {"8x8": 8, "16x16": 16}


def _cfg(size, dtype_name):
    n = SIZES[size]
    return dict(CFG, nx=n, ny=n, dtype=dtype_name)


def _jax_scene(dtype_name):
    dt = jnp.float64 if dtype_name == "f64" else jnp.float32
    spec = j_scenes.cornell_box()
    scene = j_build.compile_scene(spec.objects, sky=spec.sky, dtype=dt)
    return scene, spec.camera(dtype=dt, aspect=1.0)


def _port_scene(j_scene, j_cam, dtype):
    """The port's scene and camera from the JAX ones' arrays."""
    arrays = {f: np.asarray(getattr(j_scene, f)) for f in j_build._DATA_FIELDS}
    meta = {f: getattr(j_scene, f) for f in j_build._META_FIELDS}
    cam = {k: np.asarray(getattr(j_cam, k)) for k in CAMERA_FIELDS}
    return (t_build.scene_from_arrays(arrays, meta, dtype=dtype,
                                      device="cpu"),
            camera_from_arrays(cam, dtype=dtype, device="cpu"))


class _X64:
    """jax_enable_x64 for an f64 block, restored on exit."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        if self.on:
            jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        if self.on:
            jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("dtype_name,size", [("f64", "8x8"), ("f64", "16x16"),
                                             ("f32", "8x8")])
def test_strided_pool_matches_jax(dtype_name, size):
    kw = _cfg(size, dtype_name)
    f64 = dtype_name == "f64"
    with _X64(f64):
        j_scene, j_cam = _jax_scene(dtype_name)
        cfg = JConfig(**kw, use_pallas=False)
        raw0 = jnp.zeros((cfg.n_pixels, 3), j_scene.sky_a.dtype)
        raw, segs, iters = j_strided.render_pool_strided(j_scene, j_cam, cfg,
                                                         raw0, 0)
        want, w_segs, w_iters = np.asarray(raw), int(segs), int(iters)
        t_dt = torch.float64 if f64 else torch.float32
        scene, cam = _port_scene(j_scene, j_cam, t_dt)
    cfg = TConfig(**kw)
    raw0 = torch.zeros(cfg.n_pixels, 3, dtype=t_dt)
    got, segs, iters = t_strided.render_pool_strided(scene, cam, cfg, raw0, 0)
    assert want.max() > 0
    assert int(segs) == w_segs
    if f64:
        assert iters == w_iters
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the static form runs the drain's blocks: it drains and equals it
    raw_s, segs_s, leftover = t_strided.render_pool_strided(
        scene, cam, cfg, raw0, 0, static_iters=iters)
    assert int(leftover) == 0 and int(segs_s) == int(segs)
    assert torch.equal(raw_s, got)


def test_strided_static_grad_matches_jax_grad():
    kw = _cfg("8x8", "f64")
    with _X64(True):
        j_scene, j_cam = _jax_scene("f64")
        cfg = JConfig(**kw, use_pallas=False)
        raw0 = jnp.zeros((cfg.n_pixels, 3), jnp.float64)
        _, _, iters = j_strided.render_pool_strided(j_scene, j_cam, cfg, raw0,
                                                    0)
        n_iters = int(iters)
        params, rest = j_build.partition(j_scene)

        def loss(tex_color):
            p = dict(params, tex_color=tex_color)
            raw, _, leftover = j_strided.render_pool_strided(
                j_build.combine(p, rest), j_cam, cfg, raw0, 0,
                static_iters=n_iters)
            return jnp.mean(raw), leftover

        (_, j_left), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            params["tex_color"])
        want = np.asarray(g)
        assert int(j_left) == 0
        scene, cam = _port_scene(j_scene, j_cam, torch.float64)
    t_params, t_rest = t_build.partition(scene)
    leaf = t_params["tex_color"].clone().requires_grad_()
    raw, _, leftover = t_strided.render_pool_strided(
        t_build.combine(dict(t_params, tex_color=leaf), t_rest), cam,
        TConfig(**kw), torch.zeros(64, 3, dtype=torch.float64), 0,
        static_iters=n_iters)
    assert int(leftover) == 0
    got, = torch.autograd.grad(raw.mean(), [leaf])
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


def _packed_setup(size="8x8"):
    """The f32 plan and pk of both packages, and the pool's queue."""
    kw = _cfg(size, "f32")
    j_scene, j_cam = _jax_scene("f32")
    cfg = JConfig(**kw, use_pallas=False)
    plan = jb.make_plan(j_scene, cfg)
    pk = np.asarray(jb.pack(j_scene, j_cam, plan, jnp.float32))
    t_plan = tb.BouncePlan(**{k: getattr(plan, k)
                              for k in tb.BouncePlan.__dataclass_fields__})
    n_pix = cfg.n_pixels
    n_work = n_pix * cfg.spp
    m = t_strided.pool_size(TConfig(**kw), n_work)
    return plan, t_plan, pk, dict(m=m, n_work=n_work, n_pix=n_pix, pix0=0,
                                  total_pix=n_pix)


def _jax_state(m):
    """The JAX packed pools' initial state, as numpy."""
    rows = m // 128
    st = np.zeros((jb.N_PACKED * rows, 128), np.float32)
    st[0:rows] = np.arange(m, dtype=np.int32).reshape(rows, 128).view(
        np.float32)
    st[rows:2 * rows] = 1.0
    return st


MAX_FLIPS = 1        # lanes per 128-lane call (see the module docstring)


def _flipped(got, want):
    """Lanes (columns) outside the f32 step bounds, rtol 1e-4 / atol 1e-3."""
    return (np.abs(got - want) > 1e-3 + 1e-4 * np.abs(want)).any(0)


def _assert_states_close(got, want):
    """[N_PACKED, m] states: int rows (item, depth) and fresh exact, float
    rows within the f32 step bounds on all but MAX_FLIPS lanes; returns the
    flipped lanes."""
    g_i, w_i = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(g_i[0], w_i[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(g_i[2], w_i[2])
    flips = _flipped(got[3:], want[3:])
    assert flips.sum() <= MAX_FLIPS, np.nonzero(flips)
    return flips


def test_step_packed_matches_pallas_interpret():
    plan, t_plan, pk, q = _packed_setup()
    m = q["m"]
    assert tb.initial_packed_state(m, "cpu").numpy().tobytes() == \
        _jax_state(m).tobytes()
    kern = jax.jit(jb.as_pallas_packed(plan, m, q["n_work"], q["n_pix"], 0,
                                       q["total_pix"], interpret=True))
    sb = 3                  # a resumed render: pass keys start at 3
    state = _jax_state(m)
    terminated = 0
    for _ in range(3):
        want = np.asarray(kern(jnp.asarray(pk).reshape(1, -1),
                               jnp.asarray([sb], jnp.int32),
                               jnp.asarray(state))).reshape(jb.N_PACKED, m)
        got = tb.step_packed(t_plan, torch.tensor(pk), sb,
                             torch.tensor(state.reshape(jb.N_PACKED, m)),
                             **q).numpy()
        _assert_states_close(got, want)
        terminated += int((want[1] != 0).sum())
        state = want.reshape(-1, 128)
    assert terminated > 0


def test_chunk_plain_matches_persistent_interpret():
    plan, t_plan, pk, q = _packed_setup()
    m, T = q["m"], 2
    call = jax.jit(j_persist._make_call(plan, m, q["n_work"], q["n_pix"], 0,
                                        q["total_pix"], T=T, interpret=True))
    state = _jax_state(m)
    for _ in range(2):                    # two chunks: a warm pool too
        w_state, w_flush, w_segs = (np.asarray(x) for x in call(
            jnp.asarray(pk).reshape(1, -1), jnp.asarray([0], jnp.int32),
            jnp.asarray(state)))
        g_state, g_flush, g_segs = t_persist.chunk_plain(
            t_plan, torch.tensor(pk), 0,
            torch.tensor(state.reshape(jb.N_PACKED, m)), T=T, **q)
        flips = _assert_states_close(g_state.numpy(),
                                     w_state.reshape(jb.N_PACKED, m))
        w_flush = w_flush.reshape(T, 4, m)
        g_flush = g_flush.numpy()
        np.testing.assert_array_equal(g_flush[:, 0].view(np.int32),
                                      w_flush[:, 0].view(np.int32))
        for t in range(T):
            flips |= _flipped(g_flush[t, 1:], w_flush[t, 1:])
        assert flips.sum() <= MAX_FLIPS, np.nonzero(flips)
        np.testing.assert_array_equal(g_segs.numpy(), w_segs)
        state = w_state
    assert (w_flush[:, 0].view(np.int32) >= 0).any()


@pytest.fixture(scope="module")
def fifo_reference():
    """The JAX FIFO pool (jnp step) at 8x8, f32, and the port's scene."""
    j_scene, j_cam = _jax_scene("f32")
    cfg = JConfig(**_cfg("8x8", "f32"), use_pallas=False)
    raw, segs, _ = j_fused.render_pool_fused(
        j_scene, j_cam, cfg, jnp.zeros((cfg.n_pixels, 3), jnp.float32), 0)
    return (np.asarray(raw), int(segs),
            _port_scene(j_scene, j_cam, torch.float32))


POOLS = {"packed": t_packed.render_pool_packed,
         "persistent": t_persist.render_pool_persistent}


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_packed_pools_match_jax_fifo_pool(fifo_reference, pool):
    want, w_segs, (scene, cam) = fifo_reference
    cfg = TConfig(**_cfg("8x8", "f32"))
    raw, segs, iters = POOLS[pool](scene, cam, cfg,
                                   torch.zeros(cfg.n_pixels, 3), 0)
    assert np.isfinite(raw.numpy()).all() and want.max() > 0
    assert int(segs) == w_segs
    np.testing.assert_allclose(raw.numpy(), want, rtol=1e-5, atol=1e-5)
    step = t_strided.FLUSH_EVERY if pool == "packed" else t_persist.CHUNK_T
    assert iters % step == 0


def test_strided_pools_agree_bitwise():
    # 16x16 (m divides n_pix), f32, a resumed render (sample_base 2): the
    # three strided pools trace the same paths and add them in the same
    # order, so their images are bitwise equal; the FIFO pool sums each
    # pixel's passes first, so it agrees to the grouping of the adds
    from scheme_raytrace_torch import scenes as t_scenes
    from scheme_raytrace_torch.integrator import pool_fused as t_fused
    spec = t_scenes.cornell_box()
    scene = t_build.compile_scene(spec.objects, sky=spec.sky, device="cpu")
    cam = spec.camera(aspect=1.0, device="cpu")
    cfg = TConfig(**_cfg("16x16", "f32"))
    raw0 = torch.rand(cfg.n_pixels, 3, generator=torch.Generator().manual_seed(0))
    want, w_segs, w_iters = t_strided.render_pool_strided(scene, cam, cfg,
                                                          raw0, 2)
    for pool, fn in POOLS.items():
        raw, segs, iters = fn(scene, cam, cfg, raw0, 2)
        assert int(segs) == int(w_segs), pool
        assert torch.equal(raw, want), pool
        assert iters >= w_iters
    fifo, f_segs, _ = t_fused.render_pool_fused(scene, cam, cfg, raw0, 2)
    assert int(f_segs) == int(w_segs)
    np.testing.assert_allclose(want.numpy(), fifo.numpy(), rtol=1e-5,
                               atol=1e-5)
