"""PyTorch port, the general pool against the JAX package (CPU).

The general (masked-sweep) pool renders what the fused bounce does not
take: BVH traversal, russian roulette, material sort, more than 4,096
prims, big image atlases.  The same scenes (compiled by the JAX package,
carried over as arrays) and configs go through JAX and the port:

  * `hit.scene_hit` on every group (spheres by loop and by sweep, rects,
    media, beziers, the klein, the BVH): f64 within 1e-11 relative to
    max(1, |value|) with the same hits and materials (a sphere's normal is
    (p - c) / r, which multiplies p's round-off by 1/r: on RTOW's r = 0.2
    spheres the JAX package's own brute and BVH hits differ by 1.6e-12,
    as the port's differ from them); f32 within 1e-3 on all but 1% of the
    lanes (there the JAX package's brute and BVH normals differ by 5.4e-4);
  * `shade.shade` with and without light sampling: f64 within 1e-12 with
    the same scatter decisions; `shade_sorted` bit for bit `shade`'s in
    f32 and f64;
  * `pool.render_pool` against the JAX `render_pool` at 8-12^2 spp1-2,
    depth 3-4, f64: segments and iterations exact, the image within 1e-9 —
    the BVH (median and SAH), russian roulette, material sort, media,
    beziers, the klein, image textures and a 4,901-sphere grid, where lanes
    i and i + n_pix flush one pixel in one iteration;
  * `pool.flush_add_` against a lane-order loop, bit for bit;
  * `render_pool_auto`'s routing and its row bands over the general pool.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scheme_raytrace_tpu import scenes as j_scenes
from scheme_raytrace_tpu.config import RenderConfig as JConfig
from scheme_raytrace_tpu.core import rng as j_rng
from scheme_raytrace_tpu.integrator import hit as j_hit
from scheme_raytrace_tpu.integrator import pool as j_pool
from scheme_raytrace_tpu.integrator import shade as j_shade
from scheme_raytrace_tpu.scene import build as j_build
from scheme_raytrace_tpu.scene import objects as j_ob
from scheme_raytrace_torch import render as t_render
from scheme_raytrace_torch import scenes as t_scenes
from scheme_raytrace_torch.camera import CAMERA_FIELDS, camera_from_arrays
from scheme_raytrace_torch.config import RenderConfig as TConfig
from scheme_raytrace_torch.integrator import hit as t_hit
from scheme_raytrace_torch.integrator import pool as t_pool
from scheme_raytrace_torch.integrator import pool_fused as t_fused
from scheme_raytrace_torch.integrator import shade as t_shade
from scheme_raytrace_torch.scene import build as t_build

N = 512
T_MIN, T_MAX = 0.001, 999999999999.0


@contextlib.contextmanager
def x64(on):
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", on)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def grid_objs(n):
    """tools/bench_bvh_crossover.py:26-41's grid_scene(n): sqrt(n)^2
    lambertian spheres of radius 0.2 and the ground sphere."""
    side = int(round(n ** 0.5))
    rng = np.random.default_rng(7)
    objs = [j_ob.Sphere((0, -1000.0, 0), 1000.0,
                        j_ob.Lambertian((0.5, 0.5, 0.5)))]
    for i in range(side):
        for j in range(side):
            c = (i - side / 2 + 0.5, 0.2, j - side / 2 + 0.5)
            objs.append(j_ob.Sphere(c, 0.2, j_ob.Lambertian(
                tuple(rng.uniform(0.1, 0.9, 3)))))
    cam = dict(lookfrom=(side * 0.9, side * 0.35, side * 0.9),
               lookat=(0.0, 0.0, 0.0), vfov=30.0)
    return j_scenes.SceneSpec(objs, cam, "gradient")


def _mixed_spec():
    """Cornell with two spheres inside (tests/test_bvh.py's mixed scene)."""
    spec = j_scenes.cornell_box()
    objs = list(spec.objects) + [
        j_ob.Sphere((190, 90, 190), 90, j_ob.Lambertian((0.7, 0.7, 0.7))),
        j_ob.Sphere((370, 60, 350), 60, j_ob.Metal((0.9, 0.8, 0.7), 0.2))]
    return j_scenes.SceneSpec(objs, spec.camera_kwargs, spec.sky)


def _spec(name):
    if name == "grid4901":
        return grid_objs(4900)
    if name == "mixed":
        return _mixed_spec()
    return j_scenes.SCENES[name]()


def _pair(name, f64, bvh=None, sky=None):
    """(JAX scene, JAX camera, port scene, port camera); call under x64."""
    spec = _spec(name)
    jd, td = ((jnp.float64, torch.float64) if f64
              else (jnp.float32, torch.float32))
    js = j_build.compile_scene(spec.objects, sky=sky or spec.sky, dtype=jd,
                               bvh=bvh)
    jc = spec.camera(dtype=jd, aspect=1.0)
    ts = t_build.scene_from_arrays(
        {f: np.asarray(getattr(js, f)) for f in j_build._DATA_FIELDS},
        {f: getattr(js, f) for f in j_build._META_FIELDS}, dtype=td,
        device="cpu")
    tc = camera_from_arrays({k: np.asarray(getattr(jc, k))
                             for k in CAMERA_FIELDS}, dtype=td, device="cpu")
    return js, jc, ts, tc


def _camera_lanes(js, jc, ts, tc, cfg_kw, f64, seed=0):
    """N camera rays of random work items (the pool's own generator) for
    both packages, and the items' hash draws."""
    items = np.random.default_rng(seed).integers(0, 1 << 20, N)
    jcfg, tcfg = JConfig(**cfg_kw), TConfig(**cfg_kw)
    jd = jnp.float64 if f64 else jnp.float32
    td = torch.float64 if f64 else torch.float32
    j = j_pool._camera_rays(jc, jcfg, jnp.asarray(items, jnp.int32), 0,
                            jcfg.n_pixels, 0, jcfg.n_pixels, jd)
    t = t_pool._camera_rays(tc, tcfg, torch.tensor(items), 0, tcfg.n_pixels,
                            0, tcfg.n_pixels, td)
    return j, t, jcfg, tcfg


def _assert_rec(want, got, f64):
    flips = np.zeros(N, bool)
    if not f64:
        flips = (_np(want.hit) != _np(got.hit)) | (_np(want.mat)
                                                   != _np(got.mat))
        assert flips.mean() <= 0.01
    tol = 1e-11 if f64 else 1e-3
    keep = ~flips
    for w, g in zip(want, got):
        w, g = _np(w)[keep], _np(g)[keep]
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            assert (np.abs(g - w) <= tol * np.maximum(1.0, np.abs(w))).all()


# name -> (bvh, sky, config options)
HIT_CASES = {
    "cornell": (None, None, dict(light_sampling=True)),
    "random": (None, None, {}),
    "random-sah": ("sah", None, dict(traversal="bvh")),
    "mixed-median": ("median", None, dict(traversal="bvh")),
    "cornell_smoke": (None, None, {}),
    "bezier": (None, None, dict(bezier_seeds=16, bezier_newton=6)),
    "cornell_klein": (None, None, {}),
    "textured": (None, None, {}),
}


@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
@pytest.mark.parametrize("case", sorted(HIT_CASES))
def test_scene_hit(case, f64):
    name = case.split("-")[0]
    bvh, sky, kw = HIT_CASES[case]
    cfg_kw = dict(nx=32, ny=32, dtype="f64" if f64 else "f32", **kw)
    with x64(f64):
        js, jc, ts, tc = _pair(name, f64, bvh, sky)
        j, t, jcfg, tcfg = _camera_lanes(js, jc, ts, tc, cfg_kw, f64)
        dt = jnp.float64 if f64 else jnp.float32
        n_med = js.med_kind.shape[0]
        jxi = (j_rng.hash_uniforms(0, j[3], 0, n_med, dt,
                                   group_base=j_rng.GROUP_MEDIUM)
               if js.has_media else None)
        want = j_hit.scene_hit(j[0], j[1], j[2], js, T_MIN, T_MAX, jxi,
                               jcfg)
    txi = (torch.tensor(np.asarray(jxi)) if js.has_media else None)
    got = t_hit.scene_hit(t[0], t[1], t[2], ts, T_MIN, T_MAX, txi, tcfg)
    # the camera rays themselves agree first
    for w, g in zip(j[:3], t[:3]):
        assert np.allclose(_np(g), _np(w), rtol=1e-12 if f64 else 1e-5,
                           atol=1e-12 if f64 else 1e-4)
    assert _np(want.hit).sum() > N // 10
    _assert_rec(want, got, f64)


@pytest.mark.parametrize("light_sampling", [True, False])
@pytest.mark.parametrize("name", ["cornell", "test", "cornell_smoke",
                                  "textured"])
def test_shade_and_shade_sorted(name, light_sampling):
    """shade against JAX's in f64 on the hits of camera rays (lambertian
    with and without the mixture PDF, metal, dielectric, isotropic media,
    every texture), and shade_sorted bitwise shade in f64 and f32."""
    sky = "gradient" if name == "test" else None
    cfg_kw = dict(nx=32, ny=32, dtype="f64", light_sampling=light_sampling)
    with x64(True):
        js, jc, ts, tc = _pair(name, True, sky=sky)
        j, t, jcfg, tcfg = _camera_lanes(js, jc, ts, tc, cfg_kw, True, 1)
        dt = jnp.float64
        xi = (j_rng.hash_uniforms(0, j[3], 0, js.med_kind.shape[0], dt,
                                  group_base=j_rng.GROUP_MEDIUM)
              if js.has_media else None)
        rec = j_hit.scene_hit(j[0], j[1], j[2], js, T_MIN, T_MAX, xi, jcfg)
        u = j_rng.hash_uniforms(0, j[3], 1, j_shade.N_U, dt)
        want = j_shade.shade(u, js, jcfg, j[1], rec)
    trec = t_hit.HitRec(*(torch.tensor(np.asarray(x)) for x in rec))
    tu = torch.tensor(np.asarray(u))
    got = t_shade.shade(tu, ts, tcfg, torch.tensor(np.asarray(j[1])), trec)
    hit = np.asarray(rec.hit)
    np.testing.assert_array_equal(_np(got.alive)[hit],
                                  np.asarray(want.alive)[hit])
    for w, g in zip(want[1:], got[1:]):
        w, g = np.asarray(w)[hit], _np(g)[hit]
        assert (np.abs(g - w) <= 1e-12 * np.maximum(1.0, np.abs(w))).all()
    assert t_shade.N_U == j_shade.N_U
    mtypes = set(np.asarray(js.mat_type)[np.asarray(rec.mat)[hit]].tolist())
    assert len(mtypes) >= 2 or name == "textured"    # textured: lambertian
    for dt in (torch.float64, torch.float32):
        rec_t = t_hit.HitRec(*(x.to(dt) if x.is_floating_point() else x
                               for x in trec))
        d = torch.tensor(np.asarray(j[1])).to(dt)
        a = t_shade.shade(tu.to(dt), ts.astype(dt), tcfg, d, rec_t)
        b = t_shade.shade_sorted(tu.to(dt), ts.astype(dt), tcfg, d, rec_t)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def _render_both(name, cfg_kw, bvh=None, sky=None, pool_rays=None):
    """JAX render_pool and the port's render_pool from zeros in f64."""
    kw = dict(dtype="f64", pool_rays=pool_rays, **cfg_kw)
    with x64(True):
        js, jc, ts, tc = _pair(name, True, bvh, sky)
        jcfg = JConfig(**kw)
        raw0 = jnp.zeros((jcfg.n_pixels, 3), jnp.float64)
        raw, segs, iters = jax.jit(
            lambda s, c: j_pool.render_pool(s, c, jcfg, raw0, 0))(js, jc)
        want = (np.asarray(raw), int(segs), int(iters))
    tcfg = TConfig(**kw)
    got = t_pool.render_pool(ts, tc, tcfg,
                             torch.zeros(tcfg.n_pixels, 3,
                                         dtype=torch.float64), 0)
    return want, (got[0].numpy(), int(got[1]), got[2]), ts, tcfg


# name -> (bvh, sky, config options): each a path `bounce.supported` sends
# to the general pool, or a group the general pool sweeps
RENDER_CASES = {
    "random-sah": ("random", "sah", None, dict(traversal="bvh")),
    "random-median": ("random", "median", None, dict(traversal="bvh")),
    "mixed-sah": ("mixed", "sah", None, dict(traversal="bvh",
                                              light_sampling=True)),
    "test-rr": ("test", None, "gradient", dict(russian_roulette=True,
                                               rr_start_depth=1)),
    "cornell-rr": ("cornell", None, None, dict(russian_roulette=True,
                                               rr_start_depth=2,
                                               light_sampling=True)),
    "test-sort": ("test", None, "gradient", dict(material_sort=True)),
    "cornell_smoke-sort": ("cornell_smoke", None, None,
                           dict(material_sort=True, light_sampling=True)),
    "textured-sort": ("textured", None, None, dict(material_sort=True)),
    "bezier-rr": ("bezier", None, None, dict(russian_roulette=True,
                                             rr_start_depth=1)),
    "klein-sort": ("cornell_klein", None, None, dict(material_sort=True,
                                                     light_sampling=True)),
    "grid4901": ("grid4901", None, None, {}),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_pool_f64_matches_jax(case):
    name, bvh, sky, kw = RENDER_CASES[case]
    small = name in ("cornell_klein", "bezier", "grid4901")
    cfg_kw = dict(nx=8 if small else 12, ny=8 if small else 12,
                  spp=1 if small else 2, max_depth=3 if small else 4,
                  **kw)
    want, got, ts, tcfg = _render_both(name, cfg_kw, bvh, sky)
    from scheme_raytrace_torch.integrator import bounce
    assert not bounce.supported(ts, tcfg) or name in ("test", "textured")
    assert got[1] == want[1] and got[2] == want[2], (got[1:], want[1:])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-9, atol=1e-9)
    assert want[0].max() > 0


def test_duplicate_pixel_flush_matches_jax():
    """m > n_pix: 6^2 pixels, spp 8 over a pool of 128 lanes, so up to four
    lanes flush one pixel in one iteration (items i, i + 36, i + 72, ...)."""
    want, got, *_ = _render_both("cornell", dict(
        nx=6, ny=6, spp=8, max_depth=4, light_sampling=True), pool_rays=128)
    assert got[1] == want[1] and got[2] == want[2]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_flush_add_is_the_lane_order_sum(dtype):
    g = torch.Generator().manual_seed(0)
    m, n_pix = 3000, 50
    pix = torch.randint(0, n_pix, (m,), generator=g)
    done = torch.rand(m, generator=g) < 0.7
    val = ((torch.rand(m, 3, generator=g, dtype=dtype) - 0.5)
           * torch.exp(8 * torch.randn(m, 3, generator=g, dtype=dtype)))
    val = torch.where(done[:, None], val, 0.0)
    raw0 = torch.randn(n_pix, 3, generator=g, dtype=dtype)
    want = raw0.clone()
    for i in range(m):
        if done[i]:
            want[pix[i]] += val[i]
    rev = raw0.clone()
    for i in reversed(range(m)):
        if done[i]:
            rev[pix[i]] += val[i]
    assert not torch.equal(rev, want)                 # the order shows
    buf = torch.cat([raw0, torch.zeros(m, 3, dtype=dtype)])
    got = t_pool.flush_add_(buf, pix, val, done)[:n_pix]
    assert torch.equal(got, want)


def test_render_pool_auto_routes_and_bands(monkeypatch):
    """bounce.supported -> the fused pool, everything else -> the general
    pool (as JAX's render_pool_auto); row bands apply to both, and the
    banded general render equals the whole-frame one bitwise."""
    spec = t_scenes.random_scene(seed=0)
    scene = t_build.compile_scene(spec.objects, sky=spec.sky, bvh="sah",
                                  dtype=torch.float64, device="cpu")
    cam = spec.camera(aspect=1.0, dtype=torch.float64, device="cpu")
    cfg = TConfig(nx=8, ny=8, spp=1, max_depth=3, dtype="f64")
    calls = []
    for mod, fn in ((t_pool, "render_pool"), (t_fused, "render_pool_fused")):
        orig = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, _o=orig, _n=fn, **k:
                            calls.append(_n) or _o(*a, **k))
    z = torch.zeros(64, 3, dtype=torch.float64)
    routed = {}
    for opts in (dict(), dict(traversal="bvh"), dict(russian_roulette=True),
                 dict(material_sort=True)):
        calls.clear()
        routed[tuple(opts)] = t_pool.render_pool_auto(
            scene, cam, cfg.replace(**opts), z, 0)
        assert calls == (["render_pool_fused"] if not opts
                         else ["render_pool"]), (opts, calls)
    whole = routed[("traversal",)]
    monkeypatch.setattr(t_pool, "BAND_PIX", 16)       # 4 bands of 2 rows
    calls.clear()
    banded = t_pool.render_pool_auto(scene, cam, cfg.replace(traversal="bvh"),
                                     z, 0)
    assert calls == ["render_pool"] * 4
    assert int(banded[1]) == int(whole[1])
    assert torch.equal(banded[0], whole[0])


def test_render_image_through_the_general_pool():
    """render.render_image on the CPU renders a BVH scene through the
    general pool, and resumes its stream: spp 2 == spp 1 + spp 1."""
    spec = t_scenes.random_scene(seed=0)
    scene = t_build.compile_scene(spec.objects, sky=spec.sky, bvh="median",
                                  dtype=torch.float64, device="cpu")
    cam = spec.camera(aspect=1.0, dtype=torch.float64, device="cpu")
    cfg = TConfig(nx=8, ny=8, spp=2, max_depth=5, dtype="f64",
                  traversal="bvh")
    mean, state = t_render.render_image(scene, cam, cfg)
    assert int(state.sample_count) == 2 and torch.isfinite(mean).all()
    one = cfg.replace(spp=1)
    st, s_a, _ = t_render.render_with_stats(
        scene, cam, one, t_render.init_state(one, device="cpu"))
    st, s_b, _ = t_render.render_with_stats(scene, cam, one, st)
    _, s2, _ = t_render.render_with_stats(
        scene, cam, cfg, t_render.init_state(cfg, device="cpu"))
    assert int(s_a) + int(s_b) == int(s2)
    np.testing.assert_allclose(st.raw_sum.numpy(), state.raw_sum.numpy(),
                               rtol=1e-12, atol=1e-12)
