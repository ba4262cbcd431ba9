"""PyTorch port: the differentiable wavefront path against the JAX package
(CPU).

  * threefry (core/rng.py) bitwise `jax.random`'s: `key` for four seeds,
    `fold_in` of pass indices, `split`, `random_bits` at 32 and 64 bits and
    `uniform` in f32 and f64 (f64 under jax_enable_x64) on four shapes, and
    a batch of keys as `jax.vmap` over them;
  * `camera.get_rays` and `shade.shade_uniforms` bitwise in f64;
  * `render.render_pass` in the while mode, f64, against JAX's on the
    flagship workload (Cornell with light sampling, depth 8) at 16^2 and on
    cornell_smoke at 8^2: the image within 1e-9, `trace_rays_full`'s
    segments exact;
  * the scan mode's image bitwise the while mode's, f32 and f64; several
    passes in one wavefront (`render_passes`) bitwise one pass at a time;
  * the roulette's clip at a tie: a white Lambertian (albedo exactly 1)
    under roulette from depth 0 keeps lanes' throughput at 1.0, the clip's
    upper bound; its `tex_color` gradient equals `jax.grad`'s, and with
    `torch.clamp` in the clip it would not;
  * `render_with_stats` runs the pool whatever `config.differentiable`
    says, as JAX's does;
  * `core/vecmath.take`, the per-lane gather of the ops, equals indexing in
    values and gradients.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scheme_raytrace_tpu import camera as j_camera
from scheme_raytrace_tpu import render as j_render
from scheme_raytrace_tpu import scenes as j_scenes
from scheme_raytrace_tpu.config import RenderConfig as JConfig
from scheme_raytrace_tpu.core import rng as j_rng
from scheme_raytrace_tpu.integrator import shade as j_shade
from scheme_raytrace_tpu.integrator import wavefront as j_wave
from scheme_raytrace_tpu.scene import build as j_build
from scheme_raytrace_tpu.scene import objects as j_ob
from scheme_raytrace_torch import camera as t_camera
from scheme_raytrace_torch import render as t_render
from scheme_raytrace_torch.camera import CAMERA_FIELDS, camera_from_arrays
from scheme_raytrace_torch.config import RenderConfig as TConfig
from scheme_raytrace_torch.core import rng as t_rng
from scheme_raytrace_torch.core import vecmath as t_vm
from scheme_raytrace_torch.integrator import shade as t_shade
from scheme_raytrace_torch.scene import build as t_build

SEEDS = (0, 1, 7, 2 ** 31 - 1)
SHAPES = ((1,), (7,), (5, 2), (1000, 12))


@contextlib.contextmanager
def x64(on=True):
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", on)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _kd(key):
    """A JAX key's two uint32 words as int64 numpy."""
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def _tk(seed):
    return t_rng.root_key(seed, device="cpu")


def _bits_equal(a, b):
    """Bitwise equality of two float arrays of one dtype."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    view = np.int64 if a.dtype == np.float64 else np.int32
    return np.array_equal(a.view(view), b.view(view))


def _pair(spec, f64=True, sky=None):
    """(JAX scene, JAX camera, port scene, port camera); call under x64."""
    jd, td = ((jnp.float64, torch.float64) if f64
              else (jnp.float32, torch.float32))
    js = j_build.compile_scene(spec.objects, sky=sky or spec.sky, dtype=jd)
    jc = spec.camera(dtype=jd, aspect=1.0)
    ts = t_build.scene_from_arrays(
        {f: np.asarray(getattr(js, f)) for f in j_build._DATA_FIELDS},
        {f: getattr(js, f) for f in j_build._META_FIELDS}, dtype=td,
        device="cpu")
    tc = camera_from_arrays({k: np.asarray(getattr(jc, k))
                             for k in CAMERA_FIELDS}, dtype=td, device="cpu")
    return js, jc, ts, tc


# --- threefry ---------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_root_key_fold_in_split(seed):
    jk, tk = jax.random.key(seed), _tk(seed)
    assert np.array_equal(_kd(jk), tk.numpy())
    for p in (0, 1, 1000):
        want = _kd(jax.random.fold_in(jk, p))
        assert np.array_equal(want, t_rng.fold_in(tk, p).numpy())
        assert np.array_equal(want, t_rng.fold_in(
            tk, torch.tensor(p, dtype=torch.int32)).numpy())
    assert np.array_equal(_kd(jax.random.split(jk, 3)),
                          t_rng.split(tk, 3).numpy())
    assert np.array_equal(_kd(jax.random.split(jk)), t_rng.split(tk).numpy())
    # the bounce key of the wavefront, and a [S] tensor of sites at once
    want = _kd(j_rng.bounce_key(jk, 3, j_rng.SITE_SCATTER))
    assert np.array_equal(want, t_rng.bounce_key(tk, 3,
                                                 t_rng.SITE_SCATTER).numpy())
    sites = torch.tensor([t_rng.SITE_MEDIUM, t_rng.SITE_SCATTER,
                          t_rng.SITE_RR])
    got = t_rng.bounce_key(tk, 3, sites).numpy()
    for i, s in enumerate(sites.tolist()):
        assert np.array_equal(got[i], _kd(j_rng.bounce_key(jk, 3, s)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_f32(seed, shape):
    jk, tk = jax.random.key(seed), _tk(seed)
    want = np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64)
    assert np.array_equal(want, t_rng.random_bits(tk, 32, shape).numpy())
    u = t_rng.uniform(tk, shape, torch.float32).numpy()
    assert _bits_equal(jax.random.uniform(jk, shape, jnp.float32), u)
    assert ((u >= 0.0) & (u < 1.0)).all()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_f64(seed, shape):
    with x64():
        jk, tk = jax.random.key(seed), _tk(seed)
        want = np.asarray(jax.random.bits(jk, shape, jnp.uint64))
        got = t_rng.random_bits(tk, 64, shape).numpy()
        assert np.array_equal(want.view(np.int64), got)
        u = t_rng.uniform(tk, shape, torch.float64).numpy()
        assert _bits_equal(jax.random.uniform(jk, shape, jnp.float64), u)
        assert ((u >= 0.0) & (u < 1.0)).all()


def test_batched_keys_are_vmap():
    """A [K, 2] batch of keys draws K independent results, each the single
    key's (the wavefront's several passes at once)."""
    jk = jax.random.split(jax.random.key(5), 4)
    tk = torch.tensor(_kd(jk))
    got = t_rng.uniform(tk, (6, 3), torch.float32).numpy()
    assert got.shape == (4, 6, 3)
    for i in range(4):
        assert _bits_equal(jax.random.uniform(jk[i], (6, 3), jnp.float32),
                           got[i])
    sub = t_rng.split(tk, 3).numpy()
    for i in range(4):
        assert np.array_equal(_kd(jax.random.split(jk[i], 3)), sub[i])


def test_uniform_rejects_other_widths():
    with pytest.raises(ValueError):
        t_rng.uniform(_tk(0), (2,), torch.float16)
    with pytest.raises(ValueError):
        t_rng.random_bits(_tk(0), 16, (2,))


# --- the per-lane gather ------------------------------------------------------

@pytest.mark.parametrize("rows,shape", [(5, ()), (300, (3,)), (7, (3, 3)),
                                        (2000, (3,))],
                         ids=["scalar", "chunks", "matrix", "embedding"])
def test_take_matches_indexing(rows, shape):
    """vecmath.take: indexing's values and gradient, by the one-hot
    product (up to TAKE_ROWS_MAX rows, in chunks) or embedding's."""
    g = torch.Generator().manual_seed(rows)
    table = torch.randn((rows,) + shape, dtype=torch.float64, generator=g,
                        requires_grad=True)
    idx = torch.randint(0, rows, (97,), generator=g)
    idx[:40] = idx[0]                              # a row many lanes share
    ct = torch.randn((97,) + shape, dtype=torch.float64, generator=g)
    got = t_vm.take(table, idx)
    assert torch.equal(got, table[idx])
    want = torch.autograd.grad(table[idx], table, ct)[0]
    np.testing.assert_allclose(torch.autograd.grad(got, table, ct)[0],
                               want, rtol=1e-14, atol=1e-14)


# --- camera rays and the shade matrix ----------------------------------------

def test_get_rays_and_shade_uniforms_f64():
    with x64():
        # a lens of radius 0.05 and a shutter open over [0, 1]
        jc = j_camera.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0),
                                  vfov=20.0, aperture=0.1, focus_dist=10.0,
                                  time0=0.0, time1=1.0, dtype=jnp.float64)
        tc = camera_from_arrays({k: np.asarray(getattr(jc, k))
                                 for k in CAMERA_FIELDS},
                                dtype=torch.float64, device="cpu")
        rs = np.random.default_rng(3)
        s, t = rs.uniform(size=(2, 40))
        key = jax.random.fold_in(jax.random.key(0), 2)
        want = j_camera.get_rays(jc, jnp.asarray(s), jnp.asarray(t), key)
        got = t_camera.get_rays(tc, torch.tensor(s), torch.tensor(t),
                                torch.tensor(_kd(key)))
        for w, g in zip(want, got):
            assert _bits_equal(w, g.numpy())
        u_want = j_shade.shade_uniforms(key, 33, jnp.float64)
        u_got = t_shade.shade_uniforms(torch.tensor(_kd(key)), 33,
                                       torch.float64)
        assert _bits_equal(u_want, u_got.numpy())


# --- render_pass against JAX -------------------------------------------------

def _jax_pass(js, jc, cfg):
    """JAX's render_pass image and its trace_rays_full segments (the pass's
    keys, as render_pass derives them)."""
    def run(scene, cam):
        st = j_render.render_pass(scene, cam, cfg, j_render.init_state(cfg),
                                  jnp.zeros((), jnp.int32))
        key = jax.random.fold_in(j_rng.root_key(cfg.seed), 0)
        k_jit, k_lens, k_trace = jax.random.split(key, 3)
        u, v = j_render._pixel_uv(cfg, k_jit, cfg.jnp_dtype)
        o, d, time = j_camera.get_rays(cam, u, v, k_lens)
        full = j_wave.trace_rays_full(scene, o, d, time, k_trace, cfg)
        return st.raw_sum, full.segments, full.depth
    image, segs, depth = jax.jit(run)(js, jc)
    return np.asarray(image), int(segs), int(depth)


def _port_pass(ts, tc, cfg):
    st = t_render.render_pass(ts, tc, cfg, t_render.init_state(
        cfg, device="cpu"), 0)
    key = t_rng.fold_in(t_rng.root_key(cfg.seed, "cpu"), 0)
    full = t_render._trace_passes(ts, tc, cfg, key, cfg.torch_dtype)
    assert torch.equal(full.radiance.reshape(st.raw_sum.shape), st.raw_sum)
    return st.raw_sum.numpy(), int(full.segments), full.depth


@pytest.mark.parametrize("name,nx,kw", [
    ("cornell", 16, dict(light_sampling=True, max_depth=8)),
    ("cornell_smoke", 8, dict(light_sampling=True, max_depth=8)),
], ids=["cornell-light-d8-16", "cornell_smoke-8"])
def test_render_pass_matches_jax_f64(name, nx, kw):
    with x64():
        js, jc, ts, tc = _pair(j_scenes.SCENES[name]())
        base = dict(nx=nx, ny=nx, spp=1, seed=0, dtype="f64", **kw)
        want, w_segs, w_depth = _jax_pass(js, jc, JConfig(**base))
        got, g_segs, g_depth = _port_pass(ts, tc, TConfig(**base))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    assert (g_segs, g_depth) == (w_segs, w_depth)
    assert got.max() > 0.0 and g_segs > nx * nx


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_scan_image_equals_while_image(dtype):
    """The scan runs max_depth + 1 bounces whatever lanes are left and the
    while mode stops when none is: the same image bit for bit, the same
    segments."""
    with x64(dtype == "f64"):
        _, _, ts, tc = _pair(j_scenes.cornell_box(), f64=dtype == "f64")
    cfg = TConfig(nx=12, ny=12, spp=1, max_depth=6, light_sampling=True,
                  dtype=dtype)
    key = t_rng.fold_in(t_rng.root_key(0, "cpu"), 3)
    wh = t_render._trace_passes(ts, tc, cfg, key, cfg.torch_dtype)
    sc = t_render._trace_passes(ts, tc, cfg.replace(differentiable=True),
                                key, cfg.torch_dtype)
    assert sc.depth == cfg.max_depth + 1
    assert torch.equal(wh.radiance, sc.radiance)
    assert int(wh.segments) == int(sc.segments)
    # and through render_pass / render_image, under autograd's recording
    st0 = t_render.init_state(cfg, device="cpu")
    a = t_render.render_pass(ts, tc, cfg, st0, 3).raw_sum
    params, rest = t_build.partition(ts)
    params = {k: v.clone().requires_grad_() for k, v in params.items()}
    b = t_render.render_pass(t_build.combine(params, rest), tc,
                             cfg.replace(differentiable=True), st0, 3).raw_sum
    assert b.requires_grad and torch.equal(a, b.detach())


def test_passes_in_one_wavefront_equal_one_at_a_time():
    """render() traces several passes as one wavefront; each pass draws
    from its own key, so the sum equals pass-by-pass render_pass calls."""
    with x64():
        _, _, ts, tc = _pair(j_scenes.three_spheres())
    cfg = TConfig(nx=6, ny=6, spp=5, max_depth=4, dtype="f64",
                  differentiable=True)
    st = t_render.init_state(cfg, device="cpu")
    st = dataclasses.replace(st, sample_count=st.sample_count + 2)
    batched, segs = t_render.render_passes(ts, tc, cfg, st)
    seq = st
    for _ in range(cfg.spp):
        seq = t_render.render_pass(ts, tc, cfg, seq, seq.sample_count)
    assert int(batched.sample_count) == int(seq.sample_count) == 7
    np.testing.assert_allclose(batched.raw_sum.numpy(), seq.raw_sum.numpy(),
                               rtol=1e-13, atol=1e-15)
    assert int(segs) > cfg.n_pixels * cfg.spp


# --- the roulette's clip at a tie ---------------------------------------------

def _white_spec(objects_mod):
    """A white Lambertian ball (albedo exactly 1) on a grey ground under the
    gradient sky: behind the ball's first hit the throughput stays (1, 1, 1),
    the roulette clip's upper bound."""
    ob = objects_mod
    objs = [ob.Sphere((0.0, 0.0, -1.0), 0.5, ob.Lambertian((1.0, 1.0, 1.0))),
            ob.Sphere((0.0, -100.5, -1.0), 100.0,
                      ob.Lambertian((0.5, 0.5, 0.5)))]
    return j_scenes.SceneSpec(objs, dict(lookfrom=(0, 0, 1), lookat=(0, 0, -1),
                                         vfov=50.0), "gradient")


def _tex_grad(ts, tc, cfg):
    params, rest = t_build.partition(ts)
    params = {k: v.clone().requires_grad_() for k, v in params.items()}
    mean, _ = t_render.render_image(t_build.combine(params, rest), tc, cfg)
    return torch.autograd.grad(mean.mean(), params["tex_color"])[0].numpy()


def test_roulette_clip_tie_gradient(monkeypatch):
    kw = dict(nx=8, ny=8, spp=1, max_depth=2, differentiable=True,
              russian_roulette=True, rr_start_depth=0, dtype="f64")
    spec = _white_spec(j_ob)
    with x64():
        js, jc, ts, tc = _pair(spec)
        params, rest = j_build.partition(js)
        # the tie: some lane's throughput is exactly (1, 1, 1) when rolled
        assert np.asarray(js.tex_color)[0].tolist() == [1.0, 1.0, 1.0]

        def loss(p):
            m, _ = j_render.render_image(j_build.combine(p, rest), jc,
                                         JConfig(**kw), dtype=jnp.float64)
            return jnp.mean(m)
        want = np.asarray(jax.grad(loss)(params)["tex_color"])
    got = _tex_grad(ts, tc, TConfig(**kw))
    scale = 0.05 * np.abs(want).max()
    assert scale > 0.0
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * scale)
    # torch.clamp would pass the whole cotangent to x at the tie
    monkeypatch.setattr(t_vm, "clip",
                        lambda x, lo, hi: torch.clamp(x, lo, hi))
    clamped = _tex_grad(ts, tc, TConfig(**kw))
    assert np.abs(clamped - want).max() > 1e-3 * np.abs(want).max()


# --- render_with_stats --------------------------------------------------------

def test_render_with_stats_runs_the_pool_when_differentiable():
    _, _, ts, tc = _pair(j_scenes.cornell_box(), f64=False)
    cfg = TConfig(nx=8, ny=8, spp=2, max_depth=4, light_sampling=True)
    st = t_render.init_state(cfg, device="cpu")
    a, a_segs, a_iters = t_render.render_with_stats(ts, tc, cfg, st)
    b, b_segs, b_iters = t_render.render_with_stats(
        ts, tc, cfg.replace(differentiable=True), st)
    assert torch.equal(a.raw_sum, b.raw_sum)
    assert (int(a_segs), a_iters) == (int(b_segs), b_iters)
    assert int(b.sample_count) == 2 and a_iters > 0
