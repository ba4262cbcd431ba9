"""PyTorch port: the tile of threads a lane in K1 and K2, on the CPU.

K1 (csrc/bounce_step.cu) and K2 (csrc/bounce_step_bwd.cu) carry each lane on
a tile of w threads (w = 1, 2, 4 or 8, `bounce.tile_width`): the rect and
sphere sweeps and every ribbon's seeds split over the tile, and the tile
combines the shares with shuffles.  The card holds every w bit for bit
against w = 1 (chip_smoke.py's kernel-tile phase, tests/test_torch_cuda.py);
here, without a card:

  * the two tie plans of chip_smoke.py (a Cornell wall and a sphere, each
    duplicated right behind itself in pack order with another material):
    lanes tie, the first primitive in pack order wins, and the plain step on
    them equals the JAX `bounce.step`;
  * `tile_width` for every scene of `scenes.SCENES`;
  * the launch's block count and K2's rows of partials at every w;
  * a numpy model of the tile's combines, held against the sequential folds
    they replace on seeded inputs with forced ties: the first minimum of
    (t, pack offset) over interleaved shares (rects, spheres), the join of
    the bezier probe's records over runs of consecutive seeds (ties > 1,
    mixed same_s), and K2's re-march of tied seeds, taken in seed order.
    The model is the written spec of the tile's combine.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import dataclasses
import inspect
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from scheme_raytrace_tpu import scenes as j_scenes
from scheme_raytrace_tpu.config import RenderConfig as JConfig
from scheme_raytrace_tpu.integrator import bounce as jb
from scheme_raytrace_tpu.scene import build as j_build
from scheme_raytrace_tpu.scene import objects as j_ob
from scheme_raytrace_torch import scenes
from scheme_raytrace_torch.config import RenderConfig
from scheme_raytrace_torch.integrator import bounce
from scheme_raytrace_torch.scene import compile_scene

CSRC = pathlib.Path(bounce.__file__).resolve().parent.parent / "csrc"
M = 64

# tie plan -> (the scene without its duplicate, light sampling)
TIES = {"cornell_tie": (scenes.cornell_box, True),
        "spheres_tie": (scenes.three_spheres, False)}


CFG = dict(nx=16, ny=16, spp=1, max_depth=8, seed=0)


def _cfg(name, dtype_name):
    return RenderConfig(**CFG, light_sampling=TIES[name][1], dtype=dtype_name)


def _plan_pk(spec, name, dtype):
    scene = compile_scene(spec.objects, sky=spec.sky, lights=spec.lights,
                          dtype=dtype, device="cpu")
    cam = spec.camera(dtype=dtype, aspect=1.0, device="cpu")
    cfg = _cfg(name, "f64" if dtype == torch.float64 else "f32")
    plan = bounce.pool_plan(scene, cfg)
    return plan, bounce.pack(scene, cam, plan, dtype)


def _inputs(name, dtype):
    _, box, aim = chip_smoke.TIE_SCENES[name]
    return chip_smoke.lane_inputs(M, _cfg(name, "f32"), dtype, "cpu", seed=5,
                                  box=box, aim=aim)


def _without_duplicate_but_with(spec):
    """The tie plan with its first copy removed: the duplicate alone."""
    objs = list(spec.objects)
    del objs[1]
    return dataclasses.replace(spec, objects=objs)


@pytest.mark.parametrize("name", sorted(TIES))
def test_tie_plans_tie_and_keep_the_first(name):
    dt = torch.float64
    tie = chip_smoke.TIE_SCENES[name][0]()
    ins = _inputs(name, dt)
    recs = {}
    for key, spec in (("tie", tie), ("first", TIES[name][0]()),
                      ("second", _without_duplicate_but_with(tie))):
        plan, pk = _plan_pk(spec, name, dt)
        recs[key] = (bounce.hit_record(plan, pk, *ins[:4], *ins[5:9])[3],
                     chip_smoke.flat(bounce.step(plan, pk, *ins)))
    first, second, both = recs["first"][0], recs["second"][0], recs["tie"][0]
    # a lane ties where the first copy alone and the duplicate alone are hit
    # at one t, with their own albedos
    ties = (first["hit"] & second["hit"] & (first["t"] == second["t"])
            & (first["alb0"][2] != second["alb0"][2]))
    assert int(ties.sum()) >= M // 4, int(ties.sum())
    # the plan with both keeps the first in pack order on every tie
    assert torch.equal(both["t"][ties], first["t"][ties])
    assert torch.equal(both["alb0"][2][ties], first["alb0"][2][ties])
    assert torch.equal(both["mtype"][ties], first["mtype"][ties])
    # and its whole step is the step without the duplicate, bit for bit,
    # while a pick of the duplicate would show in the outputs of every tied
    # lane that scatters (another albedo or another rule)
    (g, g_sc), (w, w_sc) = recs["tie"][1], recs["first"][1]
    assert torch.equal(g, w) and torch.equal(g_sc, w_sc)
    scattered = ties & w_sc
    assert int(scattered.sum()) >= M // 8, int(scattered.sum())
    assert bool((recs["second"][1][0] != w)[:, scattered].any(0).all())


@pytest.mark.parametrize("dtype_name", ["f32", "f64"])
@pytest.mark.parametrize("name", sorted(TIES))
def test_tie_plans_step_matches_jax(name, dtype_name):
    # the plain step on the tie plan against the JAX step on its twin (the
    # same objects from the JAX package), numpy-seeded lanes
    j_spec = getattr(chip_smoke, name + "_spec")(j_scenes, j_ob)
    t_dt = torch.float64 if dtype_name == "f64" else torch.float32
    j_dt = jnp.float64 if dtype_name == "f64" else jnp.float32
    ins = _inputs(name, t_dt)
    if dtype_name == "f64":
        jax.config.update("jax_enable_x64", True)
    try:
        j_scene = j_build.compile_scene(j_spec.objects, sky=j_spec.sky,
                                        lights=j_spec.lights, dtype=j_dt)
        j_cam = j_spec.camera(dtype=j_dt, aspect=1.0)
        j_plan = jb.make_plan(j_scene, JConfig(
            **CFG, light_sampling=TIES[name][1], dtype=dtype_name))
        j_pk = jb.pack(j_scene, j_cam, j_plan, j_dt)
        f = lambda x: jnp.asarray(x.numpy(), j_dt)
        gitem, px, py, fresh, alive, depth, o, d, time, rad, tp = ins
        out = jb.step(j_plan, j_pk, jnp.asarray(gitem.numpy()), f(px), f(py),
                      jnp.asarray(fresh.numpy()), jnp.asarray(alive.numpy()),
                      jnp.asarray(depth.numpy()), tuple(f(x) for x in o),
                      tuple(f(x) for x in d), f(time),
                      tuple(f(x) for x in rad), tuple(f(x) for x in tp))
        want = np.stack([np.asarray(x) for x in (*out[0], *out[1], out[2],
                                                 *out[3], *out[4])])
        want_sc = np.asarray(out[5])
    finally:
        jax.config.update("jax_enable_x64", False)
    plan, pk = _plan_pk(chip_smoke.TIE_SCENES[name][0](), name, t_dt)
    assert plan == bounce.BouncePlan(**{
        k: getattr(j_plan, k) for k in bounce.BouncePlan.__dataclass_fields__})
    got, got_sc = chip_smoke.flat(bounce.step(plan, pk, *ins))
    np.testing.assert_array_equal(got_sc.numpy(), want_sc)
    rtol, atol = (1e-9, 1e-9) if dtype_name == "f64" else (1e-4, 1e-3)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


# --- tile_width -------------------------------------------------------------

# scene -> (K1's, K2's) width on its plan: the H100's sweep (PERF.md)
TILE_WIDTH = {"three_spheres": (1, 1), "textured": (1, 1), "test": (1, 1),
              "grid": (2, 2), "bezier": (4, 2), "simple_light": (1, 1),
              "cornell": (2, 2), "cornell_bezier": (4, 2),
              "cornell_smoke": (1, 1), "klein": (1, 1),
              "cornell_klein": (1, 1), "random": (2, 2),
              "points_chain": (4, 2)}


@pytest.mark.parametrize("name", sorted(scenes.SCENES))
def test_tile_width_of_every_scene(name):
    spec = scenes.SCENES[name]()
    scene = compile_scene(spec.objects, sky=spec.sky, lights=spec.lights,
                          device="cpu")
    plan = bounce.pool_plan(scene, RenderConfig(nx=8, ny=8, spp=1))
    got = (bounce.tile_width(plan), bounce.tile_width(plan, bwd=True))
    assert all(w in bounce.TILE_WIDTHS for w in got)
    assert got == TILE_WIDTH[name]


# --- the launch -------------------------------------------------------------

def _cuda_int(name, text):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


@pytest.mark.parametrize("w", [1, 2, 4, 8])
def test_block_count_and_partials_rows(w):
    common = (CSRC / "bounce_common.cuh").read_text()
    threads = _cuda_int("kThreads", common)
    assert threads == bounce.THREADS
    assert _cuda_int("kMaxTile", common) == max(bounce.TILE_WIDTHS)
    # the kernels' block count: lane_blocks, which K1 and K2 launch with
    body = re.search(r"inline int lane_blocks\(int m, int w\) \{\s*return "
                     r"([^;]+);", common).group(1)
    assert body == "(m * w + kThreads - 1) / kThreads"
    for src in ("bounce_step.cu", "bounce_step_bwd.cu"):
        assert re.search(r"<<<lane_blocks\(s\.m, w\), kThreads",
                         (CSRC / src).read_text()), src
    # K2's wrapper allocates its partials with bwd_partials: a row a block
    assert "bwd_partials(plan, m, w, dt, dev)" in inspect.getsource(
        bounce.step_cuda_bwd)
    plan = bounce.pool_plan(*_textured())
    for m in (1, 255, 256, 257, 24 * 1024, 64 * 1024, 64 * 1024 + 31):
        blocks = (m * w + threads - 1) // threads
        assert bounce.kernel_blocks(m, w) == blocks
        rows = bounce.bwd_partials(plan, m, w, torch.float32, "cpu")
        assert tuple(rows.shape) == (blocks,
                                     plan.size + plan.img_rows * 128)
    with pytest.raises(ValueError, match="tile width"):
        bounce.check_tile(3)


def _textured():
    spec = scenes.textured_scene()
    return (compile_scene(spec.objects, sky=spec.sky, device="cpu"),
            RenderConfig(nx=8, ny=8, spp=1))


# --- the numpy model of the tile's combines ---------------------------------
# Thread r of a tile of w: rects and spheres r, r + w, ... (interleaved);
# the bezier probe's seeds in the r-th of w runs of consecutive seeds,
# [r n / w, (r + 1) n / w).  The shuffles are a butterfly over offsets
# 1, 2, 4, ...: at offset `off` thread r meets thread r ^ off.

def _butterfly(values, join):
    """The tile's xor butterfly: every thread ends with the join of all;
    join(mine, other, r, off) is thread r's step at offset off."""
    vals, w = list(values), len(values)
    off = 1
    while off < w:
        vals = [join(vals[r], vals[r ^ off], r, off) for r in range(w)]
        off <<= 1
    assert all(v == vals[0] for v in vals)      # every thread agrees
    return vals[0]


def first_min_seq(ts, big):
    """The sequential sweep: (t, pack index) of the first at the least t
    under `big`, with the strict `<`; (big, -1) when none."""
    best = (big, -1)
    for k, t in enumerate(ts):
        if t < best[0]:
            best = (t, k)
    return best


def first_min_tile(ts, big, w):
    """The tile's: each thread folds its interleaved share as the sweep
    does, then the butterfly keeps the lexicographic minimum of (t, k)."""
    shares = []
    for r in range(w):
        best = (big, -1)
        for k in range(r, len(ts), w):
            if ts[k] < best[0]:
                best = (ts[k], k)
        shares.append(best)

    def join(a, b, r, off):
        return b if (b[0] < a[0] or (b[0] == a[0] and b[1] < a[1])) else a
    return _butterfly(shares, join)


def bezier_seq(seeds, big):
    """The probe's sequential fold over seeds (zc, s, accepted): the record
    (t, s of the first seed at t, ties, same_s)."""
    t, s0, ties, same = big, 0.0, 0, True
    for zc, s, ok in seeds:
        if not ok:
            continue
        if zc < t:
            t, s0, ties, same = zc, s, 1, True
        elif zc == t:
            ties += 1
            same = same and s == s0
    return (t, s0, ties, same)


def bezier_join(a, b):
    """csrc/bounce_common.cuh bezier_join: a's seeds before b's."""
    if b[0] < a[0]:
        return b
    if not b[0] == a[0]:
        return a
    return (a[0], a[1], a[2] + b[2], a[3] and b[3] and b[1] == a[1])


def bezier_tile(seeds, big, w):
    n = len(seeds)
    runs = [bezier_seq(seeds[r * n // w:(r + 1) * n // w], big)
            for r in range(w)]
    return _butterfly(runs, lambda h, o, r, off: (
        bezier_join(o, h) if r & off else bezier_join(h, o)))


def remarch_seq(seeds, t):
    """K2's re-march: the tied seeds (k, s) in the order it adds them."""
    return [(k, s) for k, (zc, s, ok) in enumerate(seeds) if ok and zc == t]


def remarch_tile(seeds, t, w):
    """The tile's: w seeds side by side, one a thread, each thread then
    taking the w roots in seed order."""
    out, n = [], len(seeds)
    for k0 in range(0, n, w):
        tied = [k0 + r < n and seeds[k0 + r][2] and seeds[k0 + r][0] == t
                for r in range(w)]
        out += [(k0 + q, seeds[k0 + q][1]) for q in range(w)
                if k0 + q < n and tied[q]]
    return out


def _seeds(r, n, big):
    """n seeds with forced ties: zc from a few values (big among them),
    roots from a few, some not accepted."""
    zc = r.choice([0.5, 0.75, 1.0, big], n)
    s = r.choice([0.25, 0.5, 0.5, 0.75], n)
    ok = r.random(n) < 0.8
    return list(zip(zc.tolist(), s.tolist(), ok.tolist()))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("w", [1, 2, 4, 8])
def test_tile_first_min_model(w, seed):
    r = np.random.default_rng(seed)
    big = 1e8
    for n in (1, 3, 7, 18, 64, 227):
        for _ in range(20):
            # few distinct t values: most candidates tie with another
            ts = r.choice([2.0, 3.0, 5.0, big, big * 2], n).tolist()
            assert first_min_tile(ts, big, w) == first_min_seq(ts, big)
            # a sphere sweep enters with the rects' best: (t_rect, -1) on a
            # thread that beats nothing never wins over a sphere below it
            t_rect = float(r.choice([2.0, 3.0, big]))
            assert (first_min_tile(ts, t_rect, w)
                    == first_min_seq(ts, t_rect))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("w", [1, 2, 4, 8])
def test_tile_bezier_join_model(w, seed):
    r = np.random.default_rng(100 + seed)
    big = 1e8
    seen_multi = seen_mixed = 0
    for n in (32, 7, 13, 3):
        for _ in range(50):
            seeds = _seeds(r, n, big)
            want = bezier_seq(seeds, big)
            assert bezier_tile(seeds, big, w) == want
            seen_multi += want[2] > 1 and want[0] < big
            seen_mixed += want[2] > 1 and not want[3]
    # the draws reach ties > 1 and tied seeds at different roots
    assert seen_multi > 50 and seen_mixed > 20


@pytest.mark.parametrize("w", [1, 2, 4, 8])
def test_tile_remarch_order_model(w):
    r = np.random.default_rng(7)
    big = 1e8
    for n in (32, 7, 13):
        for _ in range(50):
            seeds = _seeds(r, n, big)
            t = bezier_seq(seeds, big)[0]
            assert remarch_tile(seeds, t, w) == remarch_seq(seeds, t)
