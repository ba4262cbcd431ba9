"""PyTorch port: parallel/ over torch.distributed against the JAX package's
parallel/ on its CPU mesh (CPU).

  * each shard's body, in process and with no collective, against the JAX
    function on the same shard ids, float64: `_pass_rows` (image within
    1e-9), the row-band pool at each band's first pixel and the balanced
    pool at each offset (image within 1e-9, segments and iterations exact);
    the per-shard segments of both equal JAX's, so the balance claim of
    tests/test_parallel.py holds for the port too;
  * one gloo group of 4 processes and one of 2 (`distributed.spawn`; the
    children run tests/parallel_ranks.py and never load JAX), each rank
    running every entry point once.  World 4 against JAX's sharded
    functions on make_mesh(4) of the 8 CPU devices: the two pools and
    render_sharded in float64 (within 1e-9, exact segments and iterations),
    train_step's gradients in float64 (within 1e-9: a doubled reduction
    would be 4 times them), train_step_fused in float32 at
    tests/test_parallel.py's bounds and in float64 against the port's own
    unsharded step (1e-12).  World 2 against the port's single-process
    paths: the pools bitwise, render_sharded and train_step against the
    shard bodies of shards 0 and 1, train_step_fused against the unsharded
    step, and ten training steps that fit a target;
  * a shard never bands (`render_pool_auto(bands=False)`), so its
    iterations are JAX's unbanded pool's;
  * the asserts JAX keeps: rows and pixels that do not divide over the
    ranks, and a scene the balanced pool does not cover.

The JAX sharded functions are compiled once each, all at mesh size 4, on
tests/test_parallel.py's sizes (8^2 for the steps); the pools run its
imbalanced scene at spp 8 (spp <= 8 keeps JAX's flush window at the port's
8 iterations, so iteration counts compare).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scheme_raytrace_tpu import parallel as j_par
from scheme_raytrace_tpu import scenes as j_scenes
from scheme_raytrace_tpu.camera import make_camera as j_make_camera
from scheme_raytrace_tpu.config import RenderConfig as JConfig
from scheme_raytrace_tpu.integrator import pool_fused as j_fused
from scheme_raytrace_tpu.parallel import render as j_prender
from scheme_raytrace_tpu.scene import build as j_build
from scheme_raytrace_tpu.scene import objects as j_ob
from scheme_raytrace_torch import parallel as t_par
from scheme_raytrace_torch.camera import CAMERA_FIELDS
from scheme_raytrace_torch.integrator import diff_fused as t_diff
from scheme_raytrace_torch.integrator import pool as t_pool
from scheme_raytrace_torch.integrator import pool_fused as t_fused
from scheme_raytrace_torch.parallel import distributed as t_dist
from scheme_raytrace_torch.parallel import mesh as t_mesh
from scheme_raytrace_torch.parallel import render as t_prender
from scheme_raytrace_torch.scene import build as t_build

import parallel_ranks

N = 4                       # JAX mesh size and the big gloo group
BALANCE_OBJS = [            # tests/test_parallel.py's imbalanced frame
    j_ob.Sphere((0, -100.5, -2), 100, j_ob.Lambertian((0.6, 0.6, 0.6))),
    j_ob.Sphere((0, -0.2, -2), 0.6, j_ob.Lambertian((0.7, 0.4, 0.3))),
    j_ob.Sphere((-0.9, -0.3, -2), 0.4, j_ob.Lambertian((0.3, 0.5, 0.7)))]
BALANCE_CAM = dict(lookfrom=(0, 0.4, 1), lookat=(0, -0.2, -2), vfov=50.0)
POOL_CFG = dict(nx=16, ny=16, spp=8, max_depth=8, pool_rays=128, dtype="f64")
WAVE_CFG = dict(nx=16, ny=16, spp=2, max_depth=4, dtype="f64")
STEP_OBJS = [j_ob.Sphere((0, 0, -3), 2.0, j_ob.Lambertian((0.4, 0.5, 0.6)))]
STEP_CAM = dict(lookfrom=(0, 0, 0), lookat=(0, 0, -1), vfov=30.0)
STEP_CFG = dict(nx=8, ny=8, spp=1, max_depth=2, dtype="f64")
FUSED_OBJS = [
    j_ob.Sphere((0, -100.5, -3), 100, j_ob.Lambertian((0.5, 0.5, 0.5))),
    j_ob.Sphere((0, 0, -3), 1.5, j_ob.Lambertian((0.4, 0.5, 0.6))),
    j_ob.Sphere((0, 3, -3), 1.0, j_ob.DiffuseLight((4, 4, 4)))]
FUSED_CAM = dict(lookfrom=(0, 0, 2), lookat=(0, 0, -1), vfov=40.0)
FUSED_CFG = dict(nx=8, ny=8, spp=2, max_depth=4, light_sampling=True,
                 pool_rays=128)
LR = 1e-2
WHITE_SKY = (np.ones(3), np.ones(3))


@contextlib.contextmanager
def x64(on=True):
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", on)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _case(kind, objs, cam_kw, cfg, sky, **extra):
    """(JAX scene, JAX camera, JAX config, the case as numpy for a rank);
    call under x64 for a float64 config."""
    jd = jnp.float64 if cfg.get("dtype") == "f64" else jnp.float32
    js = j_build.compile_scene(objs, sky=sky, dtype=jd)
    jc = j_make_camera(**{**cam_kw, "aspect": 1.0}, dtype=jd)
    case = dict(
        kind=kind, cfg=cfg,
        scene={f: np.asarray(getattr(js, f)) for f in j_build._DATA_FIELDS},
        meta={f: getattr(js, f) for f in j_build._META_FIELDS},
        cam={k: np.asarray(getattr(jc, k)) for k in CAMERA_FIELDS},
        params={k: np.asarray(v)
                for k, v in j_build.partition(js)[0].items()}, **extra)
    return js, jc, JConfig(**cfg), case


def _port(case):
    """(port scene, port camera, port config, torch dtype) of a case."""
    return parallel_ranks._inputs(case)


def _grads(params, new):
    """The summed gradient of every leaf, from the SGD update."""
    return {k: (np.asarray(params[k]) - np.asarray(new[k])) / LR
            for k in params}


# --- the cases, the ranks' results and the JAX references ------------------

@pytest.fixture(scope="module")
def cases():
    with x64():
        pool = _case("pool_sharded", BALANCE_OBJS, BALANCE_CAM, POOL_CFG,
                     "gradient")
        bal = (*pool[:3], dict(pool[3], kind="pool_balanced"))
        spec = j_scenes.test_scene()
        wave = _case("render_sharded", spec.objects, spec.camera_kwargs,
                     WAVE_CFG, "gradient")
        step = _case("train_step", STEP_OBJS, STEP_CAM, STEP_CFG, WHITE_SKY,
                     target=np.zeros((8, 8, 3)), lr=LR)
        fused64 = _case("train_step_fused", FUSED_OBJS, FUSED_CAM,
                        dict(FUSED_CFG, dtype="f64"), WHITE_SKY,
                        target=np.zeros((8, 8, 3)), lr=LR)
    fused32 = _case("train_step_fused", FUSED_OBJS, FUSED_CAM, FUSED_CFG,
                    WHITE_SKY, target=np.zeros((8, 8, 3), np.float32), lr=LR)
    return dict(pool_sharded=pool, pool_balanced=bal, render_sharded=wave,
                train_step=step, train_step_fused=fused32,
                train_step_fused64=fused64)


@pytest.fixture(scope="module")
def world4(cases):
    return t_dist.spawn(parallel_ranks.run_entry_points, N,
                        {k: v[3] for k, v in cases.items()})


@pytest.fixture(scope="module")
def world2(cases):
    # ten steps from a perturbed albedo towards a target rendered from the
    # true one (tests/test_parallel.py's test_train_step_reduces_loss)
    start = [j_ob.Sphere((0, 0, -3), 2.0, j_ob.Lambertian((0.8, 0.2, 0.3)))]
    loop = _case("train_loop", start, STEP_CAM,
                 dict(STEP_CFG, dtype="f32"), WHITE_SKY,
                 target_scene=_case("", STEP_OBJS, STEP_CAM, {},
                                    WHITE_SKY)[3]["scene"], lr=0.1, steps=10)
    return t_dist.spawn(parallel_ranks.run_entry_points, 2,
                        {**{k: v[3] for k, v in cases.items()},
                         "train_loop": loop[3]})


@pytest.fixture(scope="module")
def jax_sharded(cases):
    """JAX's sharded entry points on make_mesh(4): one compile each."""
    mesh = j_par.make_mesh(N)
    out = {}
    with x64():
        for name in ("pool_sharded", "pool_balanced"):
            js, jc, jcfg, _ = cases[name]
            fn = (j_par.render_pool_sharded if name == "pool_sharded"
                  else j_par.render_pool_balanced)
            raw, segs, iters = fn(js, jc, jcfg, mesh)
            out[name] = (np.asarray(raw), int(segs), int(iters))
        js, jc, jcfg, _ = cases["render_sharded"]
        out["render_sharded"] = np.asarray(j_par.render_sharded(js, jc, jcfg,
                                                                mesh))
        js, jc, jcfg, case = cases["train_step"]
        params, rest = j_build.partition(js)
        new, loss = j_par.train_step(params, rest, jc, jcfg,
                                     jnp.asarray(case["target"]), mesh, lr=LR)
        out["train_step"] = (_grads(params, new), float(loss))
    return out


def _jax_fused(cases, n_iters):
    """JAX's train_step_fused (float32) on make_mesh(4) at the port's
    calibrated trip count (JAX's calibration is another sharded compile)."""
    js, jc, jcfg, case = cases["train_step_fused"]
    params, rest = j_build.partition(js)
    new, loss, leftover = j_par.train_step_fused(
        params, rest, jc, jcfg, jnp.asarray(case["target"]),
        j_par.make_mesh(N), n_iters, lr=LR)
    assert int(leftover) == 0
    return _grads(params, new), float(loss)


# --- JAX's shard bodies, compiled once with the shard as an operand ---------

@functools.partial(jax.jit, static_argnames=("config", "n_local"))
def _j_band(scene, cam, pix0, *, config, n_local):
    raw0 = jnp.zeros((n_local, 3), config.jnp_dtype)
    return j_fused.render_pool_fused(scene, cam, config, raw0, 0, pix0=pix0,
                                     total_pix=config.n_pixels)


@functools.partial(jax.jit, static_argnames=("config", "n"))
def _j_balanced(scene, cam, offset, *, config, n):
    raw0 = jnp.zeros((config.n_pixels, 3), config.jnp_dtype)
    return j_fused.render_pool_fused(scene, cam, config, raw0, 0,
                                     total_pix=config.n_pixels,
                                     item_stride=n, item_offset=offset)


@functools.partial(jax.jit, static_argnames=("config", "rows"))
def _j_pass_rows(scene, cam, pass_idx, shard, *, config, rows):
    return j_prender._pass_rows(scene, cam, config, pass_idx, shard, rows,
                                config.jnp_dtype)


@pytest.fixture(scope="module")
def pool_bodies(cases):
    """Per shard of N: (port, JAX) (raw, segments, iters) of the row-band
    and the balanced bodies, float64."""
    js, jc, jcfg, case = cases["pool_sharded"]
    ts, tc, tcfg, td = _port(case)
    lp = tcfg.n_pixels // N
    out = {"band": [], "balanced": []}
    with x64():
        for s in range(N):
            t = t_fused.render_pool_fused(ts, tc, tcfg,
                                          torch.zeros(lp, 3, dtype=td), 0,
                                          pix0=s * lp,
                                          total_pix=tcfg.n_pixels)
            j = _j_band(js, jc, jnp.int32(s * lp), config=jcfg, n_local=lp)
            out["band"].append((t, j))
            t = t_fused.render_pool_fused(
                ts, tc, tcfg, torch.zeros(tcfg.n_pixels, 3, dtype=td), 0,
                item_stride=N, item_offset=s)
            j = _j_balanced(js, jc, jnp.int32(s), config=jcfg, n=N)
            out["balanced"].append((t, j))
    return out


def _same_pool(t, j, tol=1e-9):
    raw, segs, iters = t
    np.testing.assert_allclose(raw.numpy(), np.asarray(j[0]), rtol=tol,
                               atol=tol)
    assert int(segs) == int(j[1])
    assert int(iters) == int(j[2])


@pytest.mark.parametrize("shard", range(N))
@pytest.mark.parametrize("mode", ["band", "balanced"])
def test_pool_shard_body_matches_jax(pool_bodies, mode, shard):
    t, j = pool_bodies[mode][shard]
    assert float(t[0].abs().max()) > 0
    _same_pool(t, j)


def test_balanced_pool_balances_per_shard_work(pool_bodies):
    # tests/test_parallel.py's claim, on the port's per-shard segments,
    # which equal JAX's shard for shard (test above)
    band = np.array([int(t[1]) for t, _ in pool_bodies["band"]], float)
    bal = np.array([int(t[1]) for t, _ in pool_bodies["balanced"]], float)
    assert band.sum() == bal.sum()
    assert band.max() / band.min() > 1.5, band
    assert bal.max() / bal.min() < 1.15, bal


def test_a_shard_never_bands(cases, monkeypatch):
    """render_pool_auto(bands=False), what a shard runs, drains a frame
    larger than BAND_PIX in one go, as JAX's pool under vary_axes does: its
    iterations are JAX's unbanded pool's; banded, the image is the same
    bitwise but the iterations are the bands' sum."""
    js, jc, jcfg, case = cases["pool_sharded"]
    ts, tc, tcfg, td = _port(case)
    monkeypatch.setattr(t_pool, "BAND_PIX", tcfg.n_pixels // 4)
    raw0 = torch.zeros(tcfg.n_pixels, 3, dtype=td)
    whole = t_pool.render_pool_auto(ts, tc, tcfg, raw0, 0, bands=False)
    banded = t_pool.render_pool_auto(ts, tc, tcfg, raw0, 0)
    with x64():
        want = _j_band(js, jc, jnp.int32(0), config=jcfg,
                       n_local=tcfg.n_pixels)
    _same_pool(whole, want)
    assert torch.equal(banded[0], whole[0])
    assert int(banded[1]) == int(whole[1]) and banded[2] > whole[2]


@pytest.mark.parametrize("shard", range(N))
def test_pass_rows_shard_body_matches_jax(cases, shard):
    js, jc, jcfg, case = cases["render_sharded"]
    ts, tc, tcfg, td = _port(case)
    rows = tcfg.ny // N
    with x64():
        for p in range(tcfg.spp):
            want = np.asarray(_j_pass_rows(js, jc, jnp.int32(p),
                                           jnp.int32(shard), config=jcfg,
                                           rows=rows))
            got = t_prender._pass_rows(ts, tc, tcfg, p, shard, rows, td)
            assert want.max() > 0
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                                       atol=1e-9)


# --- the gloo groups ----------------------------------------------------------

@pytest.mark.parametrize("world", ["world4", "world2"])
def test_ranks_load_no_jax_and_agree(request, world):
    res = request.getfixturevalue(world)
    assert [r["rank"] for r in res] == list(range(len(res)))
    for r in res:
        assert r["size"] == len(res) and r["jax_loaded"] is False
    flat = lambda x: (np.concatenate([flat(v) for v in x.values()])
                      if isinstance(x, dict) else
                      np.concatenate([flat(v) for v in x])
                      if isinstance(x, (list, tuple))
                      else np.ravel(np.asarray(x, np.float64)))
    for name in res[0]:
        if name not in ("rank", "size", "jax_loaded"):
            for r in res[1:]:
                np.testing.assert_array_equal(flat(r[name]),
                                              flat(res[0][name]))


@pytest.mark.parametrize("name", ["pool_sharded", "pool_balanced"])
def test_world4_pools_match_jax(world4, jax_sharded, name):
    raw, segs, iters = world4[0][name]
    want = jax_sharded[name]
    assert raw.shape == (16, 16, 3) and raw.max() > 0
    np.testing.assert_allclose(raw, want[0], rtol=1e-9, atol=1e-9)
    assert int(segs) == want[1] and int(iters) == want[2]


def test_world4_render_sharded_matches_jax(world4, jax_sharded):
    got, want = world4[0]["render_sharded"], jax_sharded["render_sharded"]
    assert got.shape == (16, 16, 3) and want.max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_world4_train_step_matches_jax(world4, jax_sharded, cases):
    # JAX's gradient psum comes from AD, the port's from one explicit
    # all-reduce: a second reduction would scale the port's by 4
    new, loss = world4[0]["train_step"]
    got = _grads(cases["train_step"][3]["params"], new)
    want, want_loss = jax_sharded["train_step"]
    assert float(loss) == pytest.approx(want_loss, rel=1e-12)
    assert max(np.abs(g).max() for g in want.values()) > 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=1e-9,
                                   err_msg=k)


def test_world4_train_step_fused_matches_jax(world4, cases):
    new, loss, leftover, n_iters = world4[0]["train_step_fused"]
    assert int(leftover) == 0
    got = _grads(cases["train_step_fused"][3]["params"], new)
    want, want_loss = _jax_fused(cases, int(n_iters))
    assert float(loss) == pytest.approx(want_loss, rel=1e-5)
    for k in want:
        atol = 2e-2 * max(1e-6, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k], want[k], rtol=0.1, atol=atol,
                                   err_msg=k)


def _unsharded_fused(case):
    """The port's single-process fwd+bwd step (diff_fused) on a case:
    (gradients, loss)."""
    ts, tc, tcfg, td = _port(case)
    params, rest = t_build.partition(ts)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    n_iters = t_diff.calibrate_iters(ts, tc, tcfg)
    raw, _, leftover = t_diff.render_diff_fused(
        t_build.combine(leaves, rest), tc, tcfg, n_iters)
    assert int(leftover) == 0
    img = (raw / tcfg.spp).reshape(tcfg.ny, tcfg.nx, 3)
    target = torch.as_tensor(case["target"], dtype=td)
    loss = torch.sum((img - target) ** 2) / (tcfg.ny * tcfg.nx * 3)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return ({k: np.zeros(v.shape) if g is None else g.numpy()
             for (k, v), g in zip(leaves.items(), grads)}, float(loss.detach()))


@pytest.mark.parametrize("world", ["world4", "world2"])
def test_train_step_fused_f64_matches_unsharded(request, cases, world):
    res = request.getfixturevalue(world)
    case = cases["train_step_fused64"][3]
    new, loss, leftover, _ = res[0]["train_step_fused64"]
    assert int(leftover) == 0
    got = _grads(case["params"], new)
    want, want_loss = _unsharded_fused(case)
    assert float(loss) == pytest.approx(want_loss, rel=1e-12)
    assert max(np.abs(g).max() for g in want.values()) > 0
    for k in want:
        scale = max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12,
                                   atol=1e-12 * scale, err_msg=k)


@pytest.mark.parametrize("name", ["pool_sharded", "pool_balanced"])
def test_world2_pools_equal_unsharded(world2, cases, name):
    ts, tc, tcfg, td = _port(cases[name][3])
    raw0 = torch.zeros(tcfg.n_pixels, 3, dtype=td)
    want, w_segs, _ = t_pool.render_pool_auto(ts, tc, tcfg, raw0, 0)
    raw, segs, iters = world2[0][name]
    np.testing.assert_array_equal(raw.reshape(-1, 3), want.numpy())
    assert int(segs) == int(w_segs)
    # iterations: the slower of the two shards' drains
    lp = tcfg.n_pixels // 2
    if name == "pool_sharded":
        shards = [t_fused.render_pool_fused(ts, tc, tcfg, raw0[:lp], 0,
                                            pix0=s * lp)
                  for s in range(2)]
    else:
        shards = [t_fused.render_pool_fused(ts, tc, tcfg, raw0, 0,
                                            item_stride=2, item_offset=s)
                  for s in range(2)]
    assert int(iters) == max(i for _, _, i in shards)


def test_world2_render_sharded_equals_shard_bodies(world2, cases):
    ts, tc, tcfg, td = _port(cases["render_sharded"][3])
    rows = tcfg.ny // 2
    want = torch.cat([t_prender._mean_image_local(ts, tc, tcfg, rows, td, s)
                      for s in range(2)])
    np.testing.assert_array_equal(world2[0]["render_sharded"], want.numpy())


def test_world2_train_step_equals_shard_bodies(world2, cases):
    # the loss of tests/test_parallel.py's psum test, built unsharded from
    # the shard bodies: the all-reduce is the only difference
    case = cases["train_step"][3]
    ts, tc, tcfg, td = _port(case)
    params, rest = t_build.partition(ts)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    scene = t_build.combine(leaves, rest)
    dcfg, rows = tcfg.replace(differentiable=True), tcfg.ny // 2
    target = torch.as_tensor(case["target"], dtype=td)
    loss = sum(torch.sum((t_prender._mean_image_local(scene, tc, dcfg, rows,
                                                      td, s)
                          - target[s * rows:(s + 1) * rows]) ** 2)
               for s in range(2)) / (tcfg.ny * tcfg.nx * 3)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    new, got_loss = world2[0]["train_step"]
    got = _grads(case["params"], new)
    assert float(got_loss) == pytest.approx(float(loss.detach()), rel=1e-12)
    for (k, v), g in zip(leaves.items(), grads):
        g = np.zeros(v.shape) if g is None else g.numpy()
        np.testing.assert_allclose(got[k], g, rtol=1e-12, atol=1e-12,
                                   err_msg=k)


def test_train_step_reduces_loss(world2):
    losses = world2[0]["train_loop"]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.5, losses


# --- what the entry points reject -------------------------------------------

def test_uneven_rows_rejected(cases):
    ts, tc, tcfg, _ = _port(cases["render_sharded"][3])
    mesh = t_mesh.Mesh(None, 0, 8, torch.device("cpu"))
    with pytest.raises(AssertionError):
        t_par.render_sharded(ts, tc, tcfg.replace(ny=12), mesh)
    with pytest.raises(AssertionError):
        t_par.render_pool_sharded(ts, tc, tcfg.replace(ny=12), mesh)
    with pytest.raises(AssertionError):
        t_par.render_pool_balanced(ts, tc, tcfg.replace(nx=15, ny=15), mesh)
    # the balanced pool runs the fused pool: no BVH traversal
    with pytest.raises(AssertionError):
        t_par.render_pool_balanced(ts, tc, tcfg.replace(traversal="bvh",
                                                        russian_roulette=True),
                                   mesh)


def test_make_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialize"):
        t_par.make_mesh()


def test_params_from_arrays_carries_jax_leaves(cases):
    case = cases["train_step_fused64"][3]
    got = t_build.params_from_arrays(case["params"], device="cpu",
                                     dtype=torch.float64)
    ts, *_ = _port(case)
    want, _ = t_build.partition(ts)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
