"""PyTorch port, the bezier scenes against the JAX package (CPU).

The same numpy-seeded inputs go through the JAX function and the port's:

  * the plain `bounce.step` against the JAX `bounce.step` on `bezier`
    (BASELINE config 5: ground, six marker spheres, three curves),
    `cornell_bezier` (config 6: the Cornell walls and one fat curve, light
    sampling on), `points_chain` (the helix stand-in, 11 curves: more than
    `pallas_ok`'s bound of 8) and a scene of one medium, one bezier and one
    sphere, 256 lanes aimed into the curves' bounding box, with fresh, live
    and dead lanes and depths at the cap; the share of lanes that end on a
    ribbon is asserted.  f64: the same scattering decisions and every output
    within 1e-9.  f32: rtol 1e-4 / atol 1e-3 on all but one lane in a
    thousand, scattering included.  And against the Pallas kernel in
    interpret mode on the small scene;
  * `bounce.step_vjp` against `jax.vjp` of the JAX step in f64: every
    cotangent within 1e-12 of that output's largest, the twelve
    control-point slots of every curve nonzero and the width's slot zero on
    both sides;
  * the fold over seeds: a lane whose seeds reach two different roots at one
    distance, bit for bit (a planar loop seen along its normal), where the
    minimum over seeds splits the cotangent in seed order; taking the first
    seed alone gives another gradient, and the port's equals JAX's;
  * the curvature floor max(g'', 0.05 |c'|^2 + 1e-12): a lane where both
    sides are equal, bit for bit (one seed, no Newton step, so that g' is
    not zero there and the floor's cotangent counts): the gradient there is
    the mean of the gradients a few ulps to either side, where each side
    wins, and all three equal JAX's;
  * the hit distance's gradient in the control points against central
    finite differences, as tests/test_grads.py holds the JAX one;
  * f64 `render_with_stats` at 16^2 spp2 on `bezier` and `cornell_bezier`
    against the JAX pool: image within 1e-9, exact segments and iterations;
    the three strided pools against the FIFO pool on `cornell_bezier`;
  * f64 `render_diff_fused` on `bezier` (8^2 spp1) and `cornell_bezier`
    (16^2 spp2), depth 6, against the JAX one and `jax.grad`: image,
    segments, leftover, and the gradient of every float scene leaf (`bez_cp`
    among them, `bez_w` zero on both sides) and the camera's lookfrom within
    1e-12 of the leaf's largest (1e-10 behind `bezier`'s radius-100 ground
    sphere);
  * the f32 64^2 spp4 renders against the config-5 and config-6 goldens with
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
M = 256           # lanes of the step comparisons
MAX_FLIP_FRAC = 1e-3


def _small_spec():
    """One medium, one bezier and one sphere: the scene of
    tests/test_bounce_vjp.py's exotic-groups case."""
    cp = np.array([[-1, 0, -2], [-0.3, 1, -2], [0.3, -1, -2], [1, 0, -2]],
                  float)
    return j_scenes.SceneSpec([
        j_ob.Sphere((0, -100.5, -1), 100, j_ob.Lambertian((0.5, 0.5, 0.5))),
        j_ob.ConstantMedium(j_ob.Sphere((0, 0.5, -1), 0.6,
                                        j_ob.Lambertian((1, 1, 1))),
                            0.8, (0.9, 0.9, 0.9)),
        j_ob.Bezier(cp, 0.4, j_ob.Lambertian((0.7, 0.4, 0.2))),
    ], j_scenes.default_camera(), "gradient")


# name -> (spec function, light sampling, the box the lane origins are drawn
# from); the directions are aimed into the control points' bounding box
SCENES = {
    "bezier": (j_scenes.test_bezier, False, ((-3, -0.4, -4), (3, 2, 4))),
    "cornell_bezier": (j_scenes.cornell_bezier, True,
                       ((0, 0, 0), (555, 555, 555))),
    "points_chain": (j_scenes.points_chain_scene, False,
                     ((-2.5, -0.4, -2.5), (2.5, 2.5, 2.5))),
    "small": (_small_spec, False, ((-2, -0.4, -3), (2, 1.5, 1))),
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


def _plan_pk(name, dtype_name, **plan_changes):
    """The JAX pool plan and `pack`'s result as numpy, with the curves'
    bounding box."""
    j_scene, j_cam = _jax_scene(name, dtype_name)
    dt = jnp.float64 if dtype_name == "f64" else jnp.float32
    cfg = JConfig(nx=16, ny=16, spp=1, max_depth=8, dtype=dtype_name,
                  light_sampling=SCENES[name][1])
    plan = dataclasses.replace(jb.make_plan(j_scene, cfg), **plan_changes)
    assert not plan.has_atlas and plan.n_beziers > 0
    cp = np.asarray(j_scene.bez_cp, np.float64).reshape(-1, 3)
    return (plan, np.asarray(jb.pack(j_scene, j_cam, plan, dt)),
            (cp.min(0), cp.max(0)))


def _lanes(m, plan, box, aim, seed):
    """Numpy draws of the step's inputs: random gitems (negatives included),
    fresh/alive masks, depths with some at the cap, origins inside `box`,
    directions aimed at random points of `aim`, nonzero radiance and
    throughput; and normal cotangents for the 13 float outputs."""
    r = np.random.default_rng(seed)
    gitem = r.integers(-2 ** 31, 2 ** 31, m, dtype=np.int64).astype(np.int32)
    px = r.integers(0, plan.nx, m).astype(np.float64)
    py = r.integers(0, plan.ny, m).astype(np.float64)
    fresh = r.random(m) < 0.3
    alive = fresh | (r.random(m) < 0.8)
    depth = r.integers(0, 4, m).astype(np.int32)
    depth[r.random(m) < 0.05] = plan.max_depth
    lo, hi = (np.asarray(b, np.float64)[:, None] for b in box)
    o = lo + r.random((3, m)) * (hi - lo)
    lo, hi = (np.asarray(b, np.float64)[:, None] for b in aim)
    dvec = lo + r.random((3, m)) * (hi - lo) - o
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
    out = (fn or jb.step)(plan, f(pk), jnp.asarray(gitem), f(px), f(py),
                          jnp.asarray(fresh), jnp.asarray(alive),
                          jnp.asarray(depth), *_split([f(x) for x in lanes]))
    return _flat(out, np.asarray)


def _torch_args(ints, lanes, dt):
    gitem, px, py, fresh, alive, depth = ints
    g = lambda x: torch.tensor(np.asarray(x), dtype=dt)
    return (torch.as_tensor(gitem), g(px), g(py), torch.as_tensor(fresh),
            torch.as_tensor(alive), torch.as_tensor(depth),
            *_split([g(x) for x in lanes]))


def _ribbon_lanes(plan, pk, args):
    """The live lanes whose closest hit is a ribbon: its normal is -d."""
    gitem, px, py, fresh, alive, depth, o, d, time = args[:9]
    _, d, _, rec = tb.hit_record(plan, pk, gitem, px, py, fresh, depth, o, d,
                                 time)
    return (alive & rec["hit"] & (rec["wn"][0] == -d[0])
            & (rec["wn"][1] == -d[1]) & (rec["wn"][2] == -d[2])).numpy()


# --- the step ---------------------------------------------------------------


@pytest.mark.parametrize("dtype_name", ["f64", "f32"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_step_matches_jax(name, dtype_name):
    f64 = dtype_name == "f64"
    t_dt = torch.float64 if f64 else torch.float32
    with _X64(f64):
        plan, pk, aim = _plan_pk(name, dtype_name)
        assert plan.n_beziers == {"bezier": 3, "cornell_bezier": 1,
                                  "points_chain": 11, "small": 1}[name]
        assert plan.n_media == (name == "small")
        assert jb.pallas_ok(plan) == (name != "points_chain")
        ints, lanes, _ = _lanes(M, plan, SCENES[name][2], aim, seed=31)
        want, w_sc = _jax_step(plan, pk, ints, lanes,
                               jnp.float64 if f64 else jnp.float32)
    args = _torch_args(ints, lanes, t_dt)
    t_plan, t_pk = _t_plan(plan), torch.tensor(pk, dtype=t_dt)
    got, g_sc = _flat(tb.step(t_plan, t_pk, *args), lambda x: x.numpy())
    assert _ribbon_lanes(t_plan, t_pk, args).sum() >= 5
    assert g_sc.any() and not g_sc.all() and np.isfinite(got).all()
    if f64:
        np.testing.assert_array_equal(g_sc, w_sc)
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    else:
        bad = (g_sc != w_sc) | (np.abs(got - want)
                                > 1e-3 + 1e-4 * np.abs(want)).any(0)
        assert bad.sum() <= max(1, MAX_FLIP_FRAC * M), int(bad.sum())


def test_step_matches_pallas_interpret():
    plan, pk, aim = _plan_pk("small", "f32")
    m = 128
    ints, lanes, _ = _lanes(m, plan, SCENES["small"][2], aim, seed=32)
    want, w_sc = _jax_step(plan, pk, ints, lanes, jnp.float32,
                           fn=jb.as_pallas(plan, m, interpret=True))
    got, g_sc = _flat(tb.step(_t_plan(plan), torch.tensor(pk),
                              *_torch_args(ints, lanes, torch.float32)),
                      lambda x: x.numpy())
    bad = (g_sc != w_sc) | (np.abs(got - want)
                            > 1e-3 + 1e-4 * np.abs(want)).any(0)
    assert bad.sum() <= 1, int(bad.sum())            # one f32 flip of 128


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


def _bez_blocks(plan, dpk):
    return dpk[plan.bez_base:plan.bez_base + plan.n_beziers
               * tb.BEZ_SIZE].reshape(-1, tb.BEZ_SIZE)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_step_vjp_matches_jax_vjp(name):
    with _X64():
        plan, pk, aim = _plan_pk(name, "f64")
        ints, lanes, cts = _lanes(M, plan, SCENES[name][2], aim, seed=33)
        want, scattering = _jax_vjp(plan, pk, ints, lanes, cts)
    assert scattering.any() and not scattering.all()
    got = _torch_vjp(plan, pk, ints, lanes, cts)
    assert len(got) == len(want) == 14
    for k, (a, b) in enumerate(zip(got, want)):
        assert np.isfinite(a).all(), k
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-12 * float(np.abs(b).max()),
                                   err_msg=f"cotangent {k}")
    for dpk in (got[0], want[0]):
        blocks = _bez_blocks(plan, dpk)
        assert (blocks[:, tb.B_CP:tb.B_CP + 12] != 0).all()
        assert (blocks[:, tb.B_W] == 0).all()       # the width: compared only


# --- single lanes: the fold over seeds, the curvature floor, FD -------------


def _lane_setup(cp, width, o, d, dtype_name="f64", **plan_changes):
    """One bezier under the black sky and one live lane with a given ray:
    the JAX plan, pk, and the lane's inputs and cotangents (on the hit
    point o' only)."""
    spec = j_scenes.SceneSpec(
        [j_ob.Bezier(np.asarray(cp, float), width,
                     j_ob.Lambertian((0.5, 0.5, 0.5)))],
        j_scenes.default_camera(), "black")
    dt = jnp.float64 if dtype_name == "f64" else jnp.float32
    scene = j_build.compile_scene(spec.objects, sky=spec.sky, dtype=dt)
    cfg = JConfig(nx=4, ny=4, spp=1, max_depth=8, dtype=dtype_name)
    plan = dataclasses.replace(jb.make_plan(scene, cfg), **plan_changes)
    pk = np.asarray(jb.pack(scene, spec.camera(dtype=dt, aspect=1.0), plan,
                            dt))
    one = lambda v, t=np.float64: np.array([v], t)
    ints = (one(7, np.int32), one(0.0), one(0.0), one(False, bool),
            one(True, bool), one(0, np.int32))
    lanes = [one(v) for v in (*o, *d, 0.0, 0, 0, 0, 1, 1, 1)]
    cts = [one(v) for v in (0.3, -0.7, 1.1, *([0.0] * 10))]
    return plan, pk, ints, lanes, cts


# A planar loop at z = -2: its two branches cross at (0, y*), reached at the
# parameters s_a = 0.113 and 1 - s_a.  Seen along -z from above the crossing,
# both roots lie at the distance 2.5, bit for bit (every control point has
# that z), so the seeds that reach either root tie in the minimum.
LOOP_CP = [[-1, -0.2, -2], [3, 0.6, -2], [-3, 0.6, -2], [1, -0.2, -2]]
LOOP_O, LOOP_D = (0.0, 0.0405, 0.5), (0.0, 0.0, -1.0)


def test_fold_over_seeds_splits_between_two_roots():
    with _X64():
        plan, pk, ints, lanes, cts = _lane_setup(LOOP_CP, 0.4, LOOP_O, LOOP_D)
        want, _ = _jax_vjp(plan, pk, ints, lanes, cts)
    t_plan = _t_plan(plan)
    args = _torch_args(ints, lanes, torch.float64)
    s, cand = tb._bezier_candidates(
        t_plan, torch.tensor(pk).unbind(0), plan.bez_base, args[6], args[7],
        1e-3, 1e9)
    s, cand = s[:, 0].numpy(), cand[:, 0].numpy()
    tied = cand == cand.min()
    assert cand.min() == 2.5 and tied.sum() >= 4
    roots = np.unique(np.round(s[tied], 6))
    assert len(roots) == 2 and abs(roots[0] + roots[1] - 1.0) < 1e-5
    got = _torch_vjp(plan, pk, ints, lanes, cts)
    cp_got = _bez_blocks(plan, got[0])[0, :12].reshape(4, 3)
    cp_want = _bez_blocks(plan, want[0])[0, :12].reshape(4, 3)
    np.testing.assert_allclose(cp_got, cp_want, rtol=0, atol=1e-14)
    # the fold's weights in seed order: 2^-(n-1), 2^-(n-1), ..., 1/4, 1/2;
    # t = zc(s) is linear in the control points' z with the Bernstein weights
    # at s, and o' = o + t d moves along d = -z, whose cotangent is 1.1
    n = int(tied.sum())
    w = np.array([2.0 ** -(n - max(j, 1)) for j in range(n)])
    assert w.sum() == 1.0
    st = s[tied]
    bern = np.stack([(1 - st) ** 3, 3 * (1 - st) ** 2 * st,
                     3 * (1 - st) * st ** 2, st ** 3], 1)
    np.testing.assert_allclose(cp_got[:, 2], 1.1 * (w @ bern), rtol=1e-12)
    # the first seed alone would weigh the first root only
    assert np.abs(cp_got[:, 2] - 1.1 * bern[0]).max() > 0.1


# A lane at the curvature floor's tie: with one seed and no Newton step the
# probe evaluates the curve at s = 0.5, where g' is not zero, and for this
# ray g''(0.5) equals 0.05 |c'|^2 + 1e-12 bit for bit (found by a search over
# the ray's origin, ulp by ulp; the tie holds over seven neighbouring values
# of o.y).  A little to either side one branch of the maximum wins.
TIE_CP = [[-0.25, -0.75, -2.0], [0.75, 0.0, -2.5], [1.0, 1.0, -3.0],
          [1.0, -0.25, -3.5]]
TIE_O = (0.390625, float.fromhex("0x1.d99999999f774p-6"), 0.5)
TIE_D = (0.0, 0.0, -1.0)


def _tie_grads(oy):
    o = (TIE_O[0], oy, TIE_O[2])
    with _X64():
        plan, pk, ints, lanes, cts = _lane_setup(
            TIE_CP, 1.0, o, TIE_D, bez_seeds=1, bez_newton=0)
        want, _ = _jax_vjp(plan, pk, ints, lanes, cts)
    got = _torch_vjp(plan, pk, ints, lanes, cts)
    return (_bez_blocks(plan, got[0])[0, :12],
            _bez_blocks(plan, want[0])[0, :12])


def test_curvature_floor_tie_splits_the_cotangent():
    tie, j_tie = _tie_grads(TIE_O[1])
    below, j_below = _tie_grads(TIE_O[1] * (1 - 1e-9))
    above, j_above = _tie_grads(TIE_O[1] * (1 + 1e-9))
    # each side against JAX, the tie included
    for got, want in ((tie, j_tie), (below, j_below), (above, j_above)):
        assert np.abs(want).max() > 0.1
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())
    # the two branches differ, and the tie takes half of each
    assert np.abs(below - above).max() > 1e-3 * np.abs(tie).max()
    np.testing.assert_allclose(tie, 0.5 * (below + above), rtol=0,
                               atol=1e-7 * np.abs(tie).max())


def test_hit_t_gradient_matches_fd():
    # d t / d cp through the implicit-differentiated root against central
    # finite differences (tests/test_grads.py holds the JAX probe this way);
    # the cotangent picks t out of o' = o + t d with d = +z
    cp0 = np.array([[-1, 0, -1], [-0.8, 1, 1], [0.8, -1, 1], [1, 0, -1]],
                   float)
    o, d = (0.1, 0.05, -5.0), (0.0, 0.0, 1.0)

    def t_and_grad(cp):
        with _X64():
            plan, pk, ints, lanes, _ = _lane_setup(cp, 0.7, o, d)
        cts = [np.array([v]) for v in (0, 0, 1.0, *([0.0] * 10))]
        args = _torch_args(ints, lanes, torch.float64)
        out = tb.step(_t_plan(plan), torch.tensor(pk), *args)
        assert bool(out[5][0])                      # the ray hits and scatters
        got = _torch_vjp(plan, pk, ints, lanes, cts)
        return (float(out[0][2][0]) - o[2],
                _bez_blocks(plan, got[0])[0, :12].reshape(4, 3))

    t0, ad = t_and_grad(cp0)
    assert 3.0 < t0 < 7.0
    eps = 1e-5
    for i, j in [(0, 2), (1, 1), (2, 0), (3, 2)]:
        cp_p, cp_m = cp0.copy(), cp0.copy()
        cp_p[i, j] += eps
        cp_m[i, j] -= eps
        fd = (t_and_grad(cp_p)[0] - t_and_grad(cp_m)[0]) / (2 * eps)
        np.testing.assert_allclose(ad[i, j], fd, rtol=1e-6, atol=1e-8)


# --- renders ----------------------------------------------------------------


@pytest.mark.parametrize("name", ["bezier", "cornell_bezier"])
def test_render_f64_matches_jax_pool(name):
    kw = dict(nx=16, ny=16, spp=2, max_depth=100, seed=0, dtype="f64",
              light_sampling=SCENES[name][1])
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


def test_strided_pools_match_fifo():
    spec = t_scenes.cornell_bezier()
    scene = t_build.compile_scene(spec.objects, sky=spec.sky, device="cpu")
    cam = spec.camera(aspect=1.0, device="cpu")
    cfg = TConfig(nx=16, ny=16, spp=2, max_depth=6, pool_rays=128,
                  light_sampling=True)
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


# the smallest frames on which a path meets a curve and goes on: 8^2 spp1 on
# `bezier`; 16^2 spp2 with seed 1 on `cornell_bezier`, whose one curve lies
# on the floor
DIFF_CFGS = {
    "bezier": dict(nx=8, ny=8, spp=1, max_depth=6, pool_rays=64,
                   dtype="f64"),
    "cornell_bezier": dict(nx=16, ny=16, spp=2, max_depth=6, pool_rays=64,
                           dtype="f64", seed=1, light_sampling=True),
}


@pytest.fixture(scope="module", params=["bezier", "cornell_bezier"])
def jax_diff_reference(request):
    """The f64 JAX render_diff_fused of one scene on DIFF_CFGS, its jax.grad,
    and the scene and camera as numpy arrays."""
    name = request.param
    with _X64():
        scene, cam = _jax_scene(name, "f64")
        cfg = JConfig(**DIFF_CFGS[name])
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
    return TConfig(**DIFF_CFGS[name])


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
    # bezier's radius-100 ground sphere feeds 1 / sqrt(disc) in the adjoint
    tol = 1e-10 if ref["name"] == "bezier" else 1e-12
    got = {}
    for name, leaf, g in zip([*params, "lookfrom"], leaves, grads):
        g = np.zeros(leaf.shape) if g is None else g.numpy()
        w = want[name]
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=tol * np.abs(w).max(initial=0.0),
                                   err_msg=name)
        got[name] = g
    for name in ("bez_cp", "tex_color", "lookfrom"):
        assert np.abs(want[name]).max() > 0, name
    # the width enters the accept test alone: no gradient on either side
    assert not got["bez_w"].any() and not want["bez_w"].any()


@pytest.mark.parametrize("name,golden,light", [
    ("bezier", "config5_bezier", False),
    ("cornell_bezier", "config6_cornell_bezier", False)])
def test_render_f32_matches_golden(name, golden, light):
    spec = t_scenes.SCENES[name]()
    scene = t_build.compile_scene(spec.objects, sky=spec.sky, device="cpu")
    cam = spec.camera(aspect=1.0, device="cpu")
    cfg = TConfig(nx=64, ny=64, spp=4, max_depth=100, seed=0,
                  light_sampling=light)
    mean, state = t_render.render_image(scene, cam, cfg)
    assert mean.dtype == torch.float32 and int(state.sample_count) == 4
    ref = np.load(os.path.join(GOLDENS, golden + ".npz"))["image"]
    img = mean.numpy().astype(np.float64)
    assert img.shape == ref.shape and np.isfinite(img).all()
    diff = np.abs(img - ref)
    assert diff.mean() < 5e-3, diff.mean()
    assert (diff.max(axis=-1) > 0.05).mean() < 0.01
