"""PyTorch port on the card: the CUDA kernels against their plain versions
(K1 against the plain step, K2 against the plain VJP, also at a tie, K3
against `step_packed`, K4 bitwise against T launches of K3, the K5 and K6
probes against theirs), a build or launch failure of each new kernel
raising, the CUDA render against the config-4 golden, and the
differentiable renders on the card (the FIFO and the strided pool's)
against their forward renders; then the same kernels on the sphere scenes
(static, moving, the 227-sphere RTOW final scene with P = 4,794), the sphere
goldens, and the card as the entry points' default device; then on the
textured and smoke scenes (hash-Perlin noise and marble, image texels with
the texels' cotangent, constant media) and the config-3 golden; then on the
bezier scenes (the ribbon probe in K1-K4 and its implicit-root adjoint in
K2, the fold over tied seeds and the curvature floor's tie among its lanes),
the config-5 and config-6 goldens, the kernels' per-feature-set builds, and
the klein scenes (the sphere trace in K1-K4 and its implicit-function
adjoint in K2, and a variant without the klein flag refusing a klein plan),
and K1, K2, K3 and K4 at every tile width of threads a lane bit for bit
against the one-thread search (w = 1), on the tie plans of chip_smoke.py
among others, K4 at every width also against 32 K3 launches; and the
general pool on the card (no kernel): its flush bitwise the lane-order sum,
its float64 renders equal to the CPU's (BVH, russian roulette, material
sort), the sorted shading bitwise the masked one, a 4,901-sphere scene;
and the differentiable wavefront on the card (no kernel): threefry bitwise
the CPU's, and float64 render_pass and gradients equal to the CPU's; and the
port's telemetry on the card: K2's span traced on autograd's thread, and
the kernels' loads counted.

Every test here needs an NVIDIA card (marker `cuda`) and skips without one.
The file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -o addopts=""
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import ctypes
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from scheme_raytrace_torch import render, scenes
from scheme_raytrace_torch.config import RenderConfig
from scheme_raytrace_torch.core import rng
from scheme_raytrace_torch.integrator import (bounce, diff_fused, persist,
                                              pool_strided)
from scheme_raytrace_torch.scene import build, compile_scene
from scheme_raytrace_torch.scene import objects as ob
from scheme_raytrace_torch.tools import probe_loops, probe_ops
from scheme_raytrace_torch.utils import cuda_build, telemetry


def launches(kernel):
    """The process's launches of one kernel so far (utils/telemetry)."""
    return telemetry.counter(f"launches.{kernel}")


GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "config4_cornell_light.npz")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cornell(dtype, device, spec_fn=scenes.cornell_box):
    spec = spec_fn()
    scene = compile_scene(spec.objects, sky=spec.sky, dtype=dtype,
                          lights=spec.lights, device=device)
    return scene, spec.camera(dtype=dtype, aspect=1.0, device=device)


def _lane_inputs(m, nx, ny, max_depth, dtype, device, seed=2, box=None,
                 aim=None):
    """Numpy draws: random gitems (negatives included), fresh/alive masks,
    depths with some lanes at the cap, origins inside the box, unit
    directions, nonzero radiance and throughput.  `box` (lo, hi) scales
    the origins to a sphere scene and draws the times in [0, 1); `aim`
    (lo, hi) points every direction at a random point of that box."""
    r = np.random.default_rng(seed)
    gitem = r.integers(-2 ** 31, 2 ** 31, m, dtype=np.int64).astype(np.int32)
    px = r.integers(0, nx, m)
    py = r.integers(0, ny, m)
    fresh = r.random(m) < 0.5
    alive = fresh | (r.random(m) < 0.7)
    depth = r.integers(0, 4, m).astype(np.int32)
    depth[r.random(m) < 0.05] = max_depth
    o = r.random((3, m)) * 500.0
    dvec = r.normal(size=(3, m))
    dvec /= np.linalg.norm(dvec, axis=0, keepdims=True)
    rad = r.random((3, m))
    tp = r.uniform(0.1, 1.0, (3, m))
    times = np.zeros(m)
    if box is not None:
        lo, hi = (np.asarray(b, np.float64)[:, None] for b in box)
        o = lo + o / 500.0 * (hi - lo)
        times = r.random(m)
    if aim is not None:
        lo, hi = (np.asarray(b, np.float64)[:, None] for b in aim)
        dvec = lo + r.random((3, m)) * (hi - lo) - o
        dvec /= np.linalg.norm(dvec, axis=0, keepdims=True)
    f = lambda x: torch.tensor(x, dtype=dtype, device=device)
    return (torch.tensor(gitem, device=device), f(px), f(py),
            torch.tensor(fresh, device=device),
            torch.tensor(alive, device=device),
            torch.tensor(depth, device=device), tuple(f(x) for x in o),
            tuple(f(x) for x in dvec), f(times),
            tuple(f(x) for x in rad), tuple(f(x) for x in tp))


def _flat(out):
    o, d, time, rad, tp, sc = out
    return [x.cpu().numpy() for x in (*o, *d, time, *rad, *tp)], \
        sc.cpu().numpy()


@pytest.mark.parametrize("light_sampling", [True, False],
                         ids=["light", "cosine"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_step_cuda_matches_plain_step(cuda, dtype, light_sampling):
    # The kernel contracts mul+add into FMA and takes cbrt for the fuzz
    # radius.  f64: every lane within 1e-9.  f32: the tests/test_bounce.py
    # bounds (rtol 1e-4, atol 1e-3 at Cornell's 0..555 scale) on all but at
    # most 0.1% of the pool's 65,536 lanes, where an f32 rounding takes a
    # branch the other way (grazing rect hits, rect edges).
    m = 64 * 1024
    scene, cam = _cornell(dtype, cuda)
    cfg = RenderConfig(nx=512, ny=512, spp=1, max_depth=100,
                       light_sampling=light_sampling)
    plan = bounce.make_plan(scene, cfg)
    pk = bounce.pack(scene, cam, plan, dtype)
    ins = _lane_inputs(m, cfg.nx, cfg.ny, cfg.max_depth, dtype, cuda)
    want = _flat(bounce.step(plan, pk, *ins))
    before = launches("K1")
    got = bounce.step_cuda(plan, pk, *ins)
    torch.cuda.synchronize()
    assert launches("K1") == before + 1
    got = _flat(got)
    if dtype == torch.float64:
        rtol, atol, max_off = 1e-9, 1e-9, 0
    else:
        rtol, atol, max_off = 1e-4, 1e-3, m // 1000
    g, w = np.stack(got[0]), np.stack(want[0])
    off = (got[1] != want[1]) | (np.abs(g - w) > atol + rtol * np.abs(w)).any(0)
    assert np.isfinite(g).all()
    assert off.sum() <= max_off, off.sum()


def test_step_cuda_rejects_bad_inputs(cuda):
    scene, cam = _cornell(torch.float32, cuda)
    cfg = RenderConfig(nx=8, ny=8, spp=1, max_depth=8, light_sampling=True)
    plan = bounce.make_plan(scene, cfg)
    pk = bounce.pack(scene, cam, plan, torch.float32)
    ins = list(_lane_inputs(256, 8, 8, 8, torch.float32, cuda))
    bad = list(ins)
    bad[3] = ins[3].to(torch.int32)                    # fresh must be bool
    with pytest.raises(ValueError, match="fresh"):
        bounce.step_cuda(plan, pk, *bad)
    bad = list(ins)
    bad[2] = ins[2].to(torch.float64)                  # mixed precision
    with pytest.raises(ValueError, match="py"):
        bounce.step_cuda(plan, pk, *bad)


def test_cuda_render_matches_config4_golden(cuda):
    scene, cam = _cornell(torch.float32, cuda)
    cfg = RenderConfig(nx=64, ny=64, spp=8, max_depth=100, seed=0,
                       light_sampling=True)
    before = launches("K1")
    state, segs, iters = render.render_with_stats(
        scene, cam, cfg, render.init_state(cfg, device=cuda))
    assert launches("K1") - before == iters
    ref = np.load(GOLDEN)["image"]
    img = (state.raw_sum / cfg.spp).cpu().numpy().astype(np.float64)
    assert np.isfinite(img).all()
    diff = np.abs(img - ref)
    assert diff.mean() < 5e-3, diff.mean()
    assert (diff.max(axis=-1) > 0.05).mean() < 0.01


def _vjp_lanes(grads):
    return grads[0], torch.stack(bounce.flat_lanes(*grads[1:]))


@pytest.mark.parametrize("case", ["cornell-light", "cornell-cosine",
                                  "materials-light"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_step_cuda_bwd_matches_step_vjp(cuda, dtype, case):
    # chip_smoke.py's bounds.  f64: lane cotangents within rtol / atol 1e-9
    # and dpk within 1e-8 of max|dpk| (its sums run in another order).  f32:
    # tests/test_bounce_vjp.py's rtol 1e-3 and atol 1e-5 * max(1, max|ref|),
    # on the lanes whose forward the kernel and the plain step agree on (at
    # most 0.1% may not; they get zero cotangent).
    m = 24 * 1024
    spec_fn = (scenes.cornell_materials if case.startswith("materials")
               else scenes.cornell_box)
    scene, cam = _cornell(dtype, cuda, spec_fn)
    cfg = RenderConfig(nx=512, ny=512, spp=1, max_depth=100,
                       light_sampling=case.endswith("light"))
    plan = bounce.make_plan(scene, cfg)
    pk = bounce.pack(scene, cam, plan, dtype)
    ins = _lane_inputs(m, cfg.nx, cfg.ny, cfg.max_depth, dtype, cuda)
    keep = torch.ones(m, dtype=torch.bool, device=cuda)
    if dtype == torch.float32:
        (g, g_sc), (w, w_sc) = [
            (torch.stack([*o, *d, t, *r, *tp]), sc)
            for o, d, t, r, tp, sc in (bounce.step_cuda(plan, pk, *ins),
                                       bounce.step(plan, pk, *ins))]
        keep = (g_sc == w_sc) & ((g - w).abs()
                                 <= 1e-3 + 1e-4 * w.abs()).all(0)
    assert int((~keep).sum()) <= m // 1000
    r = np.random.default_rng(7)
    cts = [torch.where(keep, torch.tensor(x, dtype=dtype, device=cuda), 0.0)
           for x in r.normal(size=(13, m))]
    cts = bounce.split_lanes(cts)
    want_pk, want = _vjp_lanes(bounce.step_vjp(plan, pk, *ins, *cts))
    before = launches("K2")
    got_pk, got = _vjp_lanes(bounce.step_cuda_bwd(plan, pk, *ins, *cts))
    torch.cuda.synchronize()
    assert launches("K2") == before + 1
    assert torch.isfinite(got).all() and torch.isfinite(got_pk).all()
    err, pk_err = (got - want).abs(), (got_pk - want_pk).abs()
    if dtype == torch.float64:
        assert not (err > 1e-9 + 1e-9 * want.abs()).any()
        assert pk_err.max() <= 1e-8 * want_pk.abs().max()
    else:
        scale = torch.clamp(want[:, keep].abs().amax(1), min=1.0)
        assert not ((err > 1e-5 * scale[:, None] + 1e-3 * want.abs())
                    & keep).any()
        assert not (pk_err > 1e-5 * max(1.0, float(want_pk.abs().max()))
                    + 1e-3 * want_pk.abs()).any()


def test_step_cuda_bwd_rejects_bad_inputs(cuda):
    scene, cam = _cornell(torch.float32, cuda)
    cfg = RenderConfig(nx=8, ny=8, spp=1, max_depth=8, light_sampling=True)
    plan = bounce.make_plan(scene, cfg)
    pk = bounce.pack(scene, cam, plan, torch.float32)
    ins = _lane_inputs(256, 8, 8, 8, torch.float32, cuda)
    cts = [torch.ones(256, device=cuda) for _ in range(13)]
    before = launches("K2")
    bad = list(cts)
    bad[7] = cts[7].double()                           # mixed precision
    with pytest.raises(ValueError, match="ct_rx"):
        bounce.step_cuda_bwd(plan, pk, *ins, *bounce.split_lanes(bad))
    bad = list(cts)
    bad[0] = torch.ones(256, 3, device=cuda)[:, 0]     # a strided view
    with pytest.raises(ValueError, match="contiguous"):
        bounce.step_cuda_bwd(plan, pk, *ins, *bounce.split_lanes(bad))
    with pytest.raises(ValueError, match="pk"):
        bounce.step_cuda_bwd(plan, pk[:-1], *ins, *bounce.split_lanes(cts))
    assert launches("K2") == before


def test_diff_render_on_card_equals_forward(cuda):
    scene, cam = _cornell(torch.float32, cuda)
    cfg = RenderConfig(nx=32, ny=32, spp=2, max_depth=100, seed=0,
                       light_sampling=True)
    n_iters = diff_fused.calibrate_iters(scene, cam, cfg)
    params, rest = build.partition(scene)
    params = {k: v.clone().requires_grad_() for k, v in params.items()}
    fwd, bwd = launches("K1"), launches("K2")
    raw, segs, leftover = diff_fused.render_diff_fused(
        build.combine(params, rest), cam, cfg, n_iters)
    grads = torch.autograd.grad(raw.mean(), list(params.values()),
                                allow_unused=True)
    torch.cuda.synchronize()
    assert int(leftover) == 0
    assert launches("K1") - fwd == launches("K2") - bwd > 0
    state, f_segs, _ = render.render_with_stats(
        scene, cam, cfg, render.init_state(cfg, device=cuda))
    assert int(segs) == int(f_segs)
    assert torch.equal(raw.detach(), state.raw_sum.reshape(-1, 3))
    grads = [g for g in grads if g is not None]
    assert all(torch.isfinite(g).all() for g in grads)
    assert any(g.abs().max() > 0 for g in grads)


def test_diff_render_on_card_traces_k2_on_autograds_thread(cuda):
    # autograd runs BounceStep's backward on its device thread with the
    # profiler's state carried over: `k2.launch` is traced once a K2 launch
    # and the pool's `pool.iter` once a K1 launch
    from torch.profiler import ProfilerActivity, profile
    scene, cam = _cornell(torch.float32, cuda)
    cfg = RenderConfig(nx=16, ny=16, spp=1, max_depth=12, seed=0,
                       light_sampling=True)
    n_iters = diff_fused.calibrate_iters(scene, cam, cfg)
    params, rest = build.partition(scene)
    params = {k: v.clone().requires_grad_() for k, v in params.items()}
    telemetry.reset()
    fwd, bwd = launches("K1"), launches("K2")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        raw, segs, leftover = diff_fused.render_diff_fused(
            build.combine(params, rest), cam, cfg, n_iters)
        torch.autograd.grad(raw.mean(), list(params.values()),
                            allow_unused=True)
        torch.cuda.synchronize()
    snap = telemetry.snapshot()
    telemetry.reset()
    assert int(leftover) == 0
    assert snap["spans"]["k2.launch"]["n"] == launches("K2") - bwd > 0
    assert snap["spans"]["pool.iter"]["n"] == launches("K1") - fwd
    assert snap["counters"]["pool.segments"] == int(segs)


def test_kernel_loads_are_counted(cuda, monkeypatch, tmp_path):
    # a variant's first load in a process adds its seconds to the process
    # counter kernels.load_s; a library already on disk is not built again,
    # and a build adds nvcc's seconds (LOADED's) to kernels.build_s too
    name = cuda_build.variant_name("probe_ops")
    cuda_build.load("probe_ops")

    def load():
        monkeypatch.delitem(cuda_build.LOADED, name)
        before = {k: telemetry.counter(f"kernels.{k}")
                  for k in ("load_s", "build_s")}
        cuda_build.load("probe_ops")
        return {k: telemetry.counter(f"kernels.{k}") - v
                for k, v in before.items()}

    warm = load()
    assert not cuda_build.LOADED[name]["built"]
    assert warm["load_s"] > 0 and warm["build_s"] == 0
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    cold = load()
    assert cuda_build.LOADED[name]["built"]
    assert cold["build_s"] == cuda_build.LOADED[name]["seconds"] > 0
    assert cold["load_s"] > cold["build_s"]


def test_strided_static_form_on_card_equals_drain(cuda):
    # the strided pool's reverse form (K1 forward, K2 backward through
    # BounceStep) drains, equals its drain form (K1) bitwise, launches K2
    # once per iteration, and gives finite gradients
    scene, cam = _cornell(torch.float32, cuda)
    cfg = RenderConfig(nx=16, ny=16, spp=2, max_depth=12, seed=0,
                       light_sampling=True, pool_rays=128)
    raw0 = torch.zeros(cfg.n_pixels, 3, device=cuda)
    want, w_segs, iters = pool_strided.render_pool_strided(scene, cam, cfg,
                                                           raw0, 0)
    params, rest = build.partition(scene)
    params = {k: v.clone().requires_grad_() for k, v in params.items()}
    fwd, bwd = launches("K1"), launches("K2")
    raw, segs, leftover = pool_strided.render_pool_strided(
        build.combine(params, rest), cam, cfg, raw0, 0, static_iters=iters)
    grads = torch.autograd.grad(raw.mean(), list(params.values()),
                                allow_unused=True)
    torch.cuda.synchronize()
    assert int(leftover) == 0 and int(segs) == int(w_segs)
    assert launches("K1") - fwd == launches("K2") - bwd == iters
    assert torch.equal(raw.detach(), want)
    grads = [g for g in grads if g is not None]
    assert all(torch.isfinite(g).all() for g in grads)
    assert any(g.abs().max() > 0 for g in grads)


def tie_lane(plan, pk, dtype_np):
    """The step's inputs for one lane whose light sample is a tie of unit3's
    1e-12 guard, and the packed vector with the Cornell light shrunk to the
    point (50, 1e-6, 50): the lane goes straight down onto the floor at
    p = (50, 0, 50) (exact: o + t d with t = o.y), takes a light sample, and
    target - p = (0, 1e-6, 0) has the squared length 1e-12 in float32 and
    float64 alike.  Shared with tests/test_torch_ties.py.  Returns (pk,
    ints, lanes): ints = (gitem, px, py, fresh, alive, depth), lanes the 13
    float lanes, all numpy."""
    pk = np.array(pk, dtype=dtype_np)
    b = plan.lgt_base
    pk[b + bounce.L_X0] = pk[b + bounce.L_X1] = 50.0
    pk[b + bounce.L_Z0] = pk[b + bounce.L_Z1] = 50.0
    pk[b + bounce.L_KY] = 1e-6
    depth = 1
    # a gitem whose lambertian bounce at this depth takes the light sample
    gitem = next(g for g in range(1000) if float(rng.hash_uniforms_tuple(
        plan.seed, torch.tensor([g], dtype=torch.int32), depth, 3)[2]) < 0.5)
    ints = (np.array([gitem], np.int32), np.array([3.0], dtype_np),
            np.array([4.0], dtype_np), np.array([False]), np.array([True]),
            np.array([depth], np.int32))
    lanes = [np.array([v], dtype_np) for v in
             (50.0, 100.0, 50.0, 0.0, -1.0, 0.0, 0.0, 0.1, 0.2, 0.3, 0.9,
              0.8, 0.7)]
    return pk, ints, lanes


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_step_cuda_bwd_at_a_tie_matches_step_vjp(cuda, dtype):
    # K2 splits the cotangent 0.5 / 0.5 at unit3's guard, as the plain VJP
    # (and JAX) do; the bounds of test_step_cuda_bwd_matches_step_vjp
    scene, cam = _cornell(dtype, cuda)
    cfg = RenderConfig(nx=16, ny=16, spp=1, max_depth=8, light_sampling=True)
    plan = bounce.make_plan(scene, cfg)
    pk, ints, lanes = tie_lane(plan, bounce.pack(scene, cam, plan, dtype)
                               .cpu().numpy(), np.float64)
    f = lambda x: torch.tensor(x, dtype=dtype, device=cuda)
    pk = f(pk)
    ins = (torch.tensor(ints[0], device=cuda), f(ints[1]), f(ints[2]),
           torch.tensor(ints[3], device=cuda),
           torch.tensor(ints[4], device=cuda),
           torch.tensor(ints[5], device=cuda),
           *bounce.split_lanes([f(x) for x in lanes]))
    out = bounce.step_cuda(plan, pk, *ins)
    assert bool(out[5][0]) and float(out[1][1][0]) > 0.99   # scatters up
    cts = bounce.split_lanes([f(np.array([v])) for v in np.linspace(
        -1.0, 1.0, 13)])
    want_pk, want = _vjp_lanes(bounce.step_vjp(plan, pk, *ins, *cts))
    got_pk, got = _vjp_lanes(bounce.step_cuda_bwd(plan, pk, *ins, *cts))
    torch.cuda.synchronize()
    assert float(want_pk[plan.lgt_base + bounce.L_KY]) != 0.0
    err, pk_err = (got - want).abs(), (got_pk - want_pk).abs()
    if dtype == torch.float64:
        assert not (err > 1e-9 + 1e-9 * want.abs()).any()
        assert pk_err.max() <= 1e-8 * want_pk.abs().max()
    else:
        scale = torch.clamp(want.abs().amax(1), min=1.0)
        assert not (err > 1e-5 * scale[:, None] + 1e-3 * want.abs()).any()
        assert not (pk_err > 1e-5 * max(1.0, float(want_pk.abs().max()))
                    + 1e-3 * want_pk.abs()).any()


# --- the packed-state kernels (K3, K4) ----------------------------------

M_POOL = 64 * 1024            # the forward pool's width at 512^2


def packed_state(m, n_work, max_depth, device, seed=0, box=None):
    """A numpy-seeded packed pool state ([N_PACKED, m] float32): items in
    [0, 1.1 n_work) (some lanes drained), fresh lanes, depths with some at
    the cap, origins inside the box, unit directions, nonzero radiance and
    throughput.  Shared with chip_smoke.py's kind of inputs.  `box` scales
    the origins to a sphere scene and draws the times in [0, 1)."""
    r = np.random.default_rng(seed)
    st = np.zeros((bounce.N_PACKED, m), np.float32)
    ints = st.view(np.int32)
    ints[0] = r.integers(0, n_work + n_work // 10, m)
    st[1] = r.random(m) < 0.3
    ints[2] = r.integers(0, 4, m)
    ints[2][r.random(m) < 0.05] = max_depth
    st[3:6] = r.random((3, m)) * 500.0
    dvec = r.normal(size=(3, m))
    st[6:9] = dvec / np.linalg.norm(dvec, axis=0, keepdims=True)
    st[10:13] = r.random((3, m))
    st[13:16] = r.uniform(0.1, 1.0, (3, m))
    if box is not None:
        lo, hi = (np.asarray(b, np.float32)[:, None] for b in box)
        st[3:6] = lo + st[3:6] / 500.0 * (hi - lo)
        st[9] = r.random(m)
    return torch.tensor(st, device=device)


def _packed_plan(cuda):
    scene, cam = _cornell(torch.float32, cuda)
    cfg = RenderConfig(nx=512, ny=512, spp=16, max_depth=100,
                       light_sampling=True)
    plan = bounce.make_plan(scene, cfg)
    q = dict(m=M_POOL, n_work=cfg.n_pixels * cfg.spp, n_pix=cfg.n_pixels,
             pix0=0, total_pix=cfg.n_pixels)
    return plan, bounce.pack(scene, cam, plan, torch.float32), q


def test_step_packed_cuda_matches_step_packed(cuda):
    # chip_smoke's K1 bounds: float rows within rtol 1e-4 / atol 1e-3 and
    # the int rows equal, on all but 0.1% of the lanes (f32 flips)
    plan, pk, q = _packed_plan(cuda)
    state = packed_state(q["m"], q["n_work"], plan.max_depth, cuda)
    sb = torch.tensor([5], dtype=torch.int32, device=cuda)
    want = bounce.step_packed(plan, pk, sb, state, **q)
    before = launches("K3")
    w = bounce.tile_width(plan)             # the plan's width: 2 on Cornell
    got = bounce.step_packed_cuda(plan, pk, sb, state, **q, tile=w)
    again = bounce.step_packed_cuda(plan, pk, sb, state, **q)
    torch.cuda.synchronize()
    assert launches("K3") == before + 2
    assert torch.equal(got, again)
    g_i, w_i = got.view(torch.int32), want.view(torch.int32)
    off = ((g_i[0] != w_i[0]) | (got[1] != want[1]) | (g_i[2] != w_i[2])
           | ((got[3:] - want[3:]).abs()
              > 1e-3 + 1e-4 * want[3:].abs()).any(0))
    assert torch.isfinite(got[3:]).all()
    assert int(off.sum()) <= q["m"] // 1000, int(off.sum())


def test_chunk_cuda_equals_packed_launches(cuda):
    # one K4 launch of T iterations is bitwise equal to T K3 launches: the
    # state, every flush row, and the segment counts; each at its plan's
    # width (K4 2, K3 2 on Cornell)
    plan, pk, q = _packed_plan(cuda)
    state = packed_state(q["m"], q["n_work"], plan.max_depth, cuda, seed=1)
    sb = torch.tensor([3], dtype=torch.int32, device=cuda)
    T = persist.CHUNK_T
    before = launches("K4")
    got_state, got_flush, got_segs = persist.chunk_cuda(
        plan, pk, sb, state, T=T, **q, tile=persist.tile_width(plan))
    assert launches("K4") == before + 1
    st = state
    flush = torch.empty_like(got_flush)
    segs = torch.empty_like(got_segs)
    for t in range(T):
        item = st.view(torch.int32)[0]
        segs[t] = (item < q["n_work"]).sum()
        st = bounce.step_packed_cuda(plan, pk, sb, st, **q,
                                     tile=bounce.tile_width(plan))
        done = st[1] != 0.0
        flush.view(torch.int32)[t, 0] = torch.where(done, item % q["n_pix"],
                                                    -1)
        flush[t, 1:] = torch.where(done, st[10:13], 0.0)
    torch.cuda.synchronize()
    assert torch.equal(got_state.view(torch.int32), st.view(torch.int32))
    assert torch.equal(got_flush.view(torch.int32), flush.view(torch.int32))
    assert torch.equal(got_segs, segs)
    assert int(segs.sum()) > 0


def test_probe_ops_cuda_matches_plain(cuda):
    pack, item = probe_ops.inputs(cuda)
    r = np.random.default_rng(0)
    items = (item, torch.tensor(r.integers(-2 ** 31, 2 ** 31, (8, 128),
                                           dtype=np.int64).astype(np.int32),
                                device=cuda))
    for it in items:
        want, w_ext = probe_ops.probe_plain(pack, it)
        got, g_ext = probe_ops.probe_cuda(pack, it)
        ints = want == torch.round(want)
        assert torch.equal(got[ints], want[ints])
        rel = (got - want).abs()[~ints] / want.abs()[~ints]
        assert float(rel.max()) <= 2e-6
        # the extension: floor and the hash of a negative int32 exactly,
        # log, atan2 and rsqrt to a few ulp
        assert torch.equal(g_ext[:2], w_ext[:2])
        assert float(w_ext[0].min()) < 0
        rel = (g_ext[2:] - w_ext[2:]).abs() / w_ext[2:].abs().clamp(min=1e-3)
        assert float(rel.max()) <= 2e-6


@pytest.mark.parametrize("name", list(probe_loops.ALL_CASES))
def test_probe_loops_cuda_matches_plain(cuda, name):
    # the nine cases and the extension (the bezier probe's loop form)
    x = probe_loops.inputs(seed=2, device=cuda)
    assert torch.equal(probe_loops.loops_cuda(name, x),
                       probe_loops.ALL_CASES[name](x))


def test_probe_loops_one_launch_matches_plain(cuda):
    # every case in one launch: a row a case, bitwise its plain version and
    # its single-case launch
    x = probe_loops.inputs(seed=2, device=cuda)
    before = launches("K6")
    rows = probe_loops.loops_cuda_all(x)
    assert launches("K6") == before + 1
    assert rows.shape == (len(probe_loops.ALL_CASES), *x.shape)
    for row, (name, plain) in zip(rows, probe_loops.ALL_CASES.items()):
        assert torch.equal(row, plain(x)), name
        assert torch.equal(row, probe_loops.loops_cuda(name, x)), name


def test_probe_floors_launch_uncounted(cuda):
    # the two floors' kernels run through K5's path and are not K5; the copy
    # writes every output from the items
    pack, item = probe_ops.inputs(cuda)
    before = launches("K5")
    out, ext = probe_ops.empty_cuda(pack, item)
    torch.cuda.synchronize()
    assert out.shape == item.shape
    assert ext.shape == (len(probe_ops.EXT_ROWS), *item.shape)
    out, ext = probe_ops.copy_cuda(pack, item)
    bits = item.view(torch.float32)
    assert torch.equal(out, bits * pack[0, 3])
    assert all(torch.equal(row, bits) for row in ext)
    assert launches("K5") == before


def _packed_call(cuda, which):
    """A call of one of the new kernels' wrappers on valid inputs."""
    if which in ("bounce_packed", "bounce_persist"):
        plan, pk, q = _packed_plan(cuda)
        q = dict(q, m=256)
        state = packed_state(256, q["n_work"], plan.max_depth, cuda)
        if which == "bounce_packed":
            return lambda: bounce.step_packed_cuda(plan, pk, 0, state, **q)
        return lambda: persist.chunk_cuda(plan, pk, 0, state, T=2, **q)
    if which == "probe_ops":
        return lambda: probe_ops.probe_cuda(*probe_ops.inputs(cuda))
    return lambda: probe_loops.loops_cuda("fori",
                                          probe_loops.inputs(device=cuda))


NEW_KERNELS = {  # library -> (wrapper module, its loader, its launch count)
    "bounce_packed": (bounce, "_kernel_packed", "K3"),
    "bounce_persist": (persist, "_kernel", "K4"),
    "probe_ops": (probe_ops, "_kernel", "K5"),
    "probe_loops": (probe_loops, "_kernel", "K6"),
}


@pytest.mark.parametrize("which", sorted(NEW_KERNELS))
def test_new_kernel_build_failure_raises(cuda, which, tmp_path,
                                         monkeypatch):
    # a source that does not compile raises, and nothing is launched
    src = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, src)
    with open(src / f"{which}.cu", "a") as f:
        f.write("\n#error deliberately broken\n")
    monkeypatch.setattr(cuda_build, "CSRC", src)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.delitem(cuda_build.LOADED, cuda_build.variant_name(which),
                        raising=False)
    mod, _, count = NEW_KERNELS[which]
    call = _packed_call(cuda, which)
    before = launches(count)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        call()
    assert launches(count) == before


@pytest.mark.parametrize("which", sorted(NEW_KERNELS))
def test_new_kernel_launch_failure_raises(cuda, which, monkeypatch):
    # a refused launch (the C side returns a CUDA error) raises and is not
    # counted
    mod, loader, count = NEW_KERNELS[which]
    monkeypatch.setattr(mod, loader, lambda *plan: (lambda *args: 98))
    call = _packed_call(cuda, which)
    before = launches(count)
    with pytest.raises(RuntimeError, match="launch failed"):
        call()
    assert launches(count) == before


# --- the sphere scenes (K1-K4; chip_smoke.py's phases 13-14) -------------


def _moving_spec():
    """The moving-sphere scene of tests/test_bounce.py."""
    from scheme_raytrace_torch.scene import objects as ob
    objs = [ob.Sphere((0, -100.5, -1), 100, ob.Lambertian((0.6, 0.6, 0.2))),
            ob.MovingSphere((0, 0, -1), (0, 0.4, -1), 0.0, 1.0, 0.5,
                            ob.Lambertian((0.2, 0.3, 0.7)))]
    return scenes.SceneSpec(objs, scenes.default_camera(), "gradient")


# name -> (spec, the box the lane origins are drawn from)
SPHERE_SCENES = {
    "test": (scenes.test_scene, ((-2, -0.4, -3), (2, 1.5, 1))),
    "moving": (_moving_spec, ((-2, -0.4, -3), (2, 1.5, 1))),
    "rtow": (lambda: scenes.random_scene(seed=0),
             ((-6, 0.0, -6), (10, 2.5, 10))),
}
SPHERE_CFG = RenderConfig(nx=512, ny=512, spp=8, max_depth=100)


def _sphere_setup(name, dtype, device):
    """(plan, pk, lane box, f32 atol): the atol is Cornell's 1e-3 at its
    0..555 scale, scaled to the scene's largest centre coordinate or radius
    (the ground sphere's)."""
    spec_fn, box = SPHERE_SCENES[name]
    spec = spec_fn()
    scene = compile_scene(spec.objects, sky="gradient", dtype=dtype,
                          device=device)
    cam = spec.camera(dtype=dtype, aspect=1.0, device=device)
    plan = bounce.pool_plan(scene, SPHERE_CFG)
    scale = max(float(scene.sph_c0.abs().max()),
                float(scene.sph_c1.abs().max()),
                float(scene.sph_r.abs().max()))
    return plan, bounce.pack(scene, cam, plan, dtype), box, 1e-3 * scale / 555


def _stacked(out):
    o, d, t, r, tp, sc = out
    return torch.stack([*o, *d, t, *r, *tp]), sc


@pytest.mark.parametrize("name", sorted(SPHERE_SCENES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_step_cuda_matches_plain_step_on_spheres(cuda, dtype, name):
    # f64: every lane within 1e-9.  f32: rtol 1e-4 and the scaled atol on
    # all but at most 0.1% of the 65,536 lanes; the sphere probe rounds as
    # the plain step does, so the flips come from the camera rays and the
    # shading
    m = 64 * 1024
    plan, pk, box, atol = _sphere_setup(name, dtype, cuda)
    assert plan.n_spheres == {"test": 5, "moving": 2, "rtow": 227}[name]
    assert plan.has_moving == (name != "test") and not plan.has_atlas
    ins = _lane_inputs(m, 512, 512, 100, dtype, cuda, box=box)
    w, w_sc = _stacked(bounce.step(plan, pk, *ins))
    g, g_sc = _stacked(bounce.step_cuda(plan, pk, *ins))
    torch.cuda.synchronize()
    if dtype == torch.float64:
        rtol, atol, max_off = 1e-9, 1e-9, 0
    else:
        rtol, max_off = 1e-4, m // 1000
    off = (g_sc != w_sc) | ((g - w).abs() > atol + rtol * w.abs()).any(0)
    assert torch.isfinite(g).all()
    assert w_sc.any() and int(off.sum()) <= max_off, int(off.sum())


@pytest.mark.parametrize("name", sorted(SPHERE_SCENES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_step_cuda_bwd_matches_step_vjp_on_spheres(cuda, dtype, name):
    # The bounds of test_step_cuda_bwd_matches_step_vjp, and two launches
    # bitwise equal.  f64 on "rtow" is the P = 4,794 case: its partials go
    # through per-warp winner lists, not a [warps, P] array in shared
    # memory.  f32: the dpk sums are held over every lane the forward does
    # not flip, fresh ones included: camera_ray rounds op by op, so a fresh
    # lane's ray is the plain step's bit for bit, and a ground sphere of
    # radius 100 or 1000, which would amplify an ulp of it into percent
    # differences of the camera and sphere slots, sees the plain step's ray.
    m = 24 * 1024
    f64 = dtype == torch.float64
    plan, pk, box, atol = _sphere_setup(name, dtype, cuda)
    ins = _lane_inputs(m, 512, 512, 100, dtype, cuda, box=box)
    keep = torch.ones(m, dtype=torch.bool, device=cuda)
    if not f64:
        (g, g_sc), (w, w_sc) = (_stacked(bounce.step_cuda(plan, pk, *ins)),
                                _stacked(bounce.step(plan, pk, *ins)))
        keep = (g_sc == w_sc) & ((g - w).abs()
                                 <= atol + 1e-4 * w.abs()).all(0)
    assert int((~keep).sum()) <= m // 1000
    r = np.random.default_rng(7)
    cts = [torch.where(keep, torch.tensor(x, dtype=dtype, device=cuda), 0.0)
           for x in r.normal(size=(13, m))]
    cts = bounce.split_lanes(cts)
    want_pk, want = _vjp_lanes(bounce.step_vjp(plan, pk, *ins, *cts))
    got_pk, got = _vjp_lanes(bounce.step_cuda_bwd(plan, pk, *ins, *cts))
    again_pk, again = _vjp_lanes(bounce.step_cuda_bwd(plan, pk, *ins, *cts))
    torch.cuda.synchronize()
    assert torch.equal(got_pk, again_pk) and torch.equal(got, again)
    assert torch.isfinite(got).all() and torch.isfinite(got_pk).all()
    if plan.has_moving:
        assert float(want[6].abs().max()) > 0          # the time cotangent
    err, pk_err = (got - want).abs(), (got_pk - want_pk).abs()
    if f64:
        assert not (err > 1e-9 + 1e-9 * want.abs()).any()
        assert pk_err.max() <= 1e-8 * want_pk.abs().max()
        return
    scale = torch.clamp(want[:, keep].abs().amax(1), min=1.0)
    assert not ((err > 1e-5 * scale[:, None] + 1e-3 * want.abs())
                & keep).any()
    assert bool(ins[3].any())                        # fresh lanes included
    assert float(want_pk[plan.sph_base:].abs().max()) > 0
    assert not ((got_pk - want_pk).abs()
                > 1e-5 * max(1.0, float(want_pk.abs().max()))
                + 1e-3 * want_pk.abs()).any()


def test_packed_kernels_on_the_rtow_scene(cuda):
    # K3 against step_packed (K1's bounds), and one K4 chunk bitwise equal
    # to 32 K3 launches, on the 227-sphere scene's packed states
    plan, pk, box, atol = _sphere_setup("rtow", torch.float32, cuda)
    n_pix = SPHERE_CFG.n_pixels
    q = dict(m=M_POOL, n_work=n_pix * SPHERE_CFG.spp, n_pix=n_pix, pix0=0,
             total_pix=n_pix)
    sb = torch.tensor([5], dtype=torch.int32, device=cuda)
    state = packed_state(M_POOL, q["n_work"], plan.max_depth, cuda, box=box)
    want = bounce.step_packed(plan, pk, sb, state, **q)
    got = bounce.step_packed_cuda(plan, pk, sb, state, **q)
    g_i, w_i = got.view(torch.int32), want.view(torch.int32)
    off = ((g_i[0] != w_i[0]) | (got[1] != want[1]) | (g_i[2] != w_i[2])
           | ((got[3:] - want[3:]).abs()
              > atol + 1e-4 * want[3:].abs()).any(0))
    assert torch.isfinite(got[3:]).all()
    assert int(off.sum()) <= M_POOL // 1000, int(off.sum())
    T = persist.CHUNK_T
    got_state, got_flush, got_segs = persist.chunk_cuda(plan, pk, sb, state,
                                                        T=T, **q)
    st = state
    flush = torch.empty_like(got_flush)
    segs = torch.empty_like(got_segs)
    for t in range(T):
        item = st.view(torch.int32)[0]
        segs[t] = (item < q["n_work"]).sum()
        st = bounce.step_packed_cuda(plan, pk, sb, st, **q)
        done = st[1] != 0.0
        flush.view(torch.int32)[t, 0] = torch.where(done, item % n_pix, -1)
        flush[t, 1:] = torch.where(done, st[10:13], 0.0)
    torch.cuda.synchronize()
    assert torch.equal(got_state.view(torch.int32), st.view(torch.int32))
    assert torch.equal(got_flush.view(torch.int32), flush.view(torch.int32))
    assert torch.equal(got_segs, segs) and int(segs.sum()) > 0


@pytest.mark.parametrize("golden,scene_fn,spp", [
    ("config1_three_spheres", scenes.three_spheres, 10),
    ("config2_rtow_final", lambda: scenes.random_scene(seed=0), 4)])
def test_cuda_render_matches_sphere_goldens(cuda, golden, scene_fn, spp):
    # no `device` anywhere: the entry points land on the card
    spec = scene_fn()
    scene = compile_scene(spec.objects, sky=spec.sky)
    cam = spec.camera(aspect=1.0)
    cfg = RenderConfig(nx=64, ny=64, spp=spp, max_depth=100, seed=0)
    before = launches("K1")
    mean, state = render.render_image(scene, cam, cfg)
    assert mean.device.type == "cuda" and launches("K1") > before
    ref = np.load(os.path.join(os.path.dirname(GOLDEN),
                               golden + ".npz"))["image"]
    img = mean.cpu().numpy().astype(np.float64)
    assert np.isfinite(img).all()
    diff = np.abs(img - ref)
    assert diff.mean() < 5e-3, diff.mean()
    assert (diff.max(axis=-1) > 0.05).mean() < 0.01


def test_entry_points_land_on_the_card(cuda):
    from scheme_raytrace_torch import camera
    spec = scenes.three_spheres()
    scene = compile_scene(spec.objects, sky=spec.sky)
    cfg = RenderConfig(nx=8, ny=8, spp=1)
    on_card = [scene.sph_r, scene.mat_type, spec.camera().lookfrom,
               camera.make_camera((0.0, 0.0, 1.0), (0.0, 0.0, 0.0)).vfov,
               render.init_state(cfg).raw_sum,
               probe_ops.inputs()[1], probe_loops.inputs()]
    assert all(x.device.type == "cuda" for x in on_card)
    cpu = compile_scene(spec.objects, sky=spec.sky, device="cpu")
    assert cpu.sph_r.device.type == "cpu"


# --- textures and smoke (K1-K4; chip_smoke.py's phases 16-17) ------------

# name -> (spec, light sampling, the box the lane origins are drawn from;
# None: Cornell's cube)
TEXTURE_SCENES = {
    "textured": (scenes.textured_scene, False, ((-2, -0.4, -3), (2, 1.5, 2))),
    "simple_light": (scenes.test_scene2, True, ((-6, 0.0, -6), (6, 9, 6))),
    "smoke": (scenes.cornell_smoke, True, None),
}


def _texture_setup(name, dtype, device):
    """(plan, pk or (pk, atlas), lane box, f32 atol) of a TEXTURE_SCENES
    entry at 512^2 spp8; the atol scaled as _sphere_setup scales it."""
    spec_fn, ls, box = TEXTURE_SCENES[name]
    spec = spec_fn()
    scene = compile_scene(spec.objects, sky=spec.sky, dtype=dtype,
                          lights=spec.lights, device=device)
    cam = spec.camera(dtype=dtype, aspect=1.0, device=device)
    plan = bounce.pool_plan(scene, SPHERE_CFG.replace(light_sampling=ls))
    scale = 555.0
    if scene.has_spheres:
        scale = max(float(scene.sph_c0.abs().max()),
                    float(scene.sph_r.abs().max()))
    return plan, bounce.pack(scene, cam, plan, dtype), box, 1e-3 * scale / 555


def _dpk_vec(grads):
    """dpk and, for an image plan, the texels' cotangent, as one vector."""
    dpk = grads[0]
    return (torch.cat([dpk[0], dpk[1].reshape(-1)])
            if isinstance(dpk, tuple) else dpk)


@pytest.mark.parametrize("name", sorted(TEXTURE_SCENES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_step_cuda_matches_plain_step_on_textures(cuda, dtype, name):
    # the bounds of test_step_cuda_matches_plain_step_on_spheres
    m = 64 * 1024
    plan, pk, box, atol = _texture_setup(name, dtype, cuda)
    assert (plan.n_media, plan.has_perlin, plan.has_image) == {
        "smoke": (2, False, False), "simple_light": (0, True, False),
        "textured": (0, True, True)}[name]
    ins = _lane_inputs(m, 512, 512, 100, dtype, cuda, box=box)
    w, w_sc = _stacked(bounce.step(plan, pk, *ins))
    g, g_sc = _stacked(bounce.step_cuda(plan, pk, *ins))
    torch.cuda.synchronize()
    if dtype == torch.float64:
        rtol, atol, max_off = 1e-9, 1e-9, 0
    else:
        rtol, max_off = 1e-4, m // 1000
    off = (g_sc != w_sc) | ((g - w).abs() > atol + rtol * w.abs()).any(0)
    assert torch.isfinite(g).all()
    assert w_sc.any() and int(off.sum()) <= max_off, int(off.sum())


@pytest.mark.parametrize("name", sorted(TEXTURE_SCENES))
def test_step_cuda_bwd_matches_step_vjp_on_textures(cuda, name):
    # f64: every lane cotangent within 1e-9 and every pk slot and texel
    # within 1e-8 of the largest; two launches bitwise equal, the texels'
    # cotangent included (no float atomics anywhere in the reduction)
    m = 24 * 1024
    dtype = torch.float64
    plan, pk, box, _ = _texture_setup(name, dtype, cuda)
    ins = _lane_inputs(m, 512, 512, 100, dtype, cuda, box=box)
    r = np.random.default_rng(7)
    cts = bounce.split_lanes([torch.tensor(x, dtype=dtype, device=cuda)
                              for x in r.normal(size=(13, m))])
    want = bounce.step_vjp(plan, pk, *ins, *cts)
    got = bounce.step_cuda_bwd(plan, pk, *ins, *cts)
    again = bounce.step_cuda_bwd(plan, pk, *ins, *cts)
    torch.cuda.synchronize()
    want_pk, got_pk, again_pk = _dpk_vec(want), _dpk_vec(got), _dpk_vec(again)
    want, got, again = (_vjp_lanes(x)[1] for x in (want, got, again))
    assert torch.equal(got_pk, again_pk) and torch.equal(got, again)
    assert torch.isfinite(got).all() and torch.isfinite(got_pk).all()
    assert not ((got - want).abs() > 1e-9 + 1e-9 * want.abs()).any()
    assert (got_pk - want_pk).abs().max() <= 1e-8 * want_pk.abs().max()
    if plan.has_image:
        assert got_pk.numel() == plan.size + plan.img_rows * 128
        assert float(got_pk[plan.size:].abs().max()) > 0
    if plan.n_media:
        med = got_pk[plan.med_base:plan.med_base + bounce.MED_SIZE]
        assert float(med[bounce.M_NID].abs()) > 0
        assert float(med[bounce.M_AX:bounce.M_AX + 15].abs().max()) > 0


@pytest.mark.parametrize("name", ["textured", "smoke"])
def test_packed_kernels_on_the_texture_scenes(cuda, name):
    # K3 against step_packed (K1's bounds), and one K4 chunk bitwise equal
    # to 32 K3 launches
    plan, pk, box, atol = _texture_setup(name, torch.float32, cuda)
    n_pix = SPHERE_CFG.n_pixels
    q = dict(m=M_POOL, n_work=n_pix * SPHERE_CFG.spp, n_pix=n_pix, pix0=0,
             total_pix=n_pix)
    sb = torch.tensor([5], dtype=torch.int32, device=cuda)
    state = packed_state(M_POOL, q["n_work"], plan.max_depth, cuda, box=box)
    want = bounce.step_packed(plan, pk, sb, state, **q)
    got = bounce.step_packed_cuda(plan, pk, sb, state, **q)
    g_i, w_i = got.view(torch.int32), want.view(torch.int32)
    off = ((g_i[0] != w_i[0]) | (got[1] != want[1]) | (g_i[2] != w_i[2])
           | ((got[3:] - want[3:]).abs()
              > atol + 1e-4 * want[3:].abs()).any(0))
    assert torch.isfinite(got[3:]).all()
    assert int(off.sum()) <= M_POOL // 1000, int(off.sum())
    T = persist.CHUNK_T
    got_state, got_flush, got_segs = persist.chunk_cuda(plan, pk, sb, state,
                                                        T=T, **q)
    st = state
    flush = torch.empty_like(got_flush)
    segs = torch.empty_like(got_segs)
    for t in range(T):
        item = st.view(torch.int32)[0]
        segs[t] = (item < q["n_work"]).sum()
        st = bounce.step_packed_cuda(plan, pk, sb, st, **q)
        done = st[1] != 0.0
        flush.view(torch.int32)[t, 0] = torch.where(done, item % n_pix, -1)
        flush[t, 1:] = torch.where(done, st[10:13], 0.0)
    torch.cuda.synchronize()
    assert torch.equal(got_state.view(torch.int32), st.view(torch.int32))
    assert torch.equal(got_flush.view(torch.int32), flush.view(torch.int32))
    assert torch.equal(got_segs, segs) and int(segs.sum()) > 0


def test_cuda_render_matches_config3_golden(cuda):
    spec = scenes.textured_scene()
    scene = compile_scene(spec.objects, sky=spec.sky)
    cam = spec.camera(aspect=1.0)
    cfg = RenderConfig(nx=64, ny=64, spp=4, max_depth=100, seed=0)
    before = launches("K1")
    mean, state = render.render_image(scene, cam, cfg)
    assert mean.device.type == "cuda" and launches("K1") > before
    ref = np.load(os.path.join(os.path.dirname(GOLDEN),
                               "config3_textured.npz"))["image"]
    img = mean.cpu().numpy().astype(np.float64)
    assert np.isfinite(img).all()
    diff = np.abs(img - ref)
    assert diff.mean() < 5e-3, diff.mean()
    assert (diff.max(axis=-1) > 0.05).mean() < 0.01


@pytest.mark.parametrize("name", ["textured", "smoke"])
def test_cuda_diff_render_on_the_texture_scenes(cuda, name):
    # drained, the forward render's image bitwise, K2 launched once per K1
    # launch, and two steps' gradients bitwise equal (the image texels' and
    # the media's among them)
    spec_fn, ls, _ = TEXTURE_SCENES[name]
    spec = spec_fn()
    scene = compile_scene(spec.objects, sky=spec.sky, lights=spec.lights)
    cam = spec.camera(aspect=1.0)
    cfg = RenderConfig(nx=32, ny=32, spp=2, max_depth=12, light_sampling=ls)
    n_iters = diff_fused.calibrate_iters(scene, cam, cfg)
    params, rest = build.partition(scene)

    def step():
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        raw, _, leftover = diff_fused.render_diff_fused(
            build.combine(leaves, rest), cam, cfg, n_iters)
        grads = torch.autograd.grad(raw.mean(), list(leaves.values()),
                                    allow_unused=True)
        return raw.detach(), int(leftover), dict(zip(leaves, grads))

    fwd, bwd = launches("K1"), launches("K2")
    raw, leftover, grads = step()
    assert leftover == 0
    assert launches("K1") - fwd == launches("K2") - bwd > 0
    st, _, _ = render.render_with_stats(scene, cam, cfg,
                                        render.init_state(cfg))
    assert torch.equal(raw, st.raw_sum.reshape(-1, 3))
    _, _, grads2 = step()
    moved = (("images", "tex_scale") if name == "textured"
             else ("med_neg_inv_d", "med_pmin", "med_pmax"))
    for k in moved:
        assert float(grads[k].abs().max()) > 0, k
    for k, g in grads.items():
        if g is not None:
            assert torch.isfinite(g).all() and torch.equal(g, grads2[k]), k


# --- the bezier scenes (K1-K4; chip_smoke.py's phases 19-22) -------------

# name -> (spec, light sampling, the box the lane origins are drawn from;
# None: Cornell's cube); the directions are aimed into the control points'
# bounding box
BEZIER_SCENES = {
    "bezier": (scenes.test_bezier, False, ((-3, -0.4, -4), (3, 2, 4))),
    "cornell_bezier": (scenes.cornell_bezier, True, None),
    "points_chain": (scenes.points_chain_scene, False,
                     ((-2.5, -0.4, -2.5), (2.5, 2.5, 2.5))),
}


def _bezier_setup(name, dtype, device):
    """(plan, pk, lane box, aim box, f32 atol) of a BEZIER_SCENES entry at
    512^2 spp8; the atol scaled as _sphere_setup scales it."""
    spec_fn, ls, box = BEZIER_SCENES[name]
    spec = spec_fn()
    scene = compile_scene(spec.objects, sky=spec.sky, dtype=dtype,
                          device=device)
    cam = spec.camera(dtype=dtype, aspect=1.0, device=device)
    plan = bounce.pool_plan(scene, SPHERE_CFG.replace(light_sampling=ls))
    cp = scene.bez_cp.reshape(-1, 3)
    aim = (cp.amin(0).tolist(), cp.amax(0).tolist())
    scale = 555.0
    if scene.has_spheres:
        scale = max(float(scene.sph_c0.abs().max()),
                    float(scene.sph_r.abs().max()))
    return (plan, bounce.pack(scene, cam, plan, dtype), box, aim,
            1e-3 * scale / 555)


def _ribbon_lanes(plan, pk, ins):
    """The live lanes whose closest hit is a ribbon: its normal is -d."""
    gitem, px, py, fresh, alive, depth, o, d, time = ins[:9]
    _, d, _, rec = bounce.hit_record(plan, pk, gitem, px, py, fresh, depth,
                                     o, d, time)
    return (alive & rec["hit"] & (rec["wn"][0] == -d[0])
            & (rec["wn"][1] == -d[1]) & (rec["wn"][2] == -d[2]))


@pytest.mark.parametrize("name", sorted(BEZIER_SCENES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_step_cuda_matches_plain_step_on_beziers(cuda, dtype, name):
    # the bounds of test_step_cuda_matches_plain_step_on_spheres, on lanes
    # aimed at the curves
    m = 64 * 1024
    plan, pk, box, aim, atol = _bezier_setup(name, dtype, cuda)
    assert plan.n_beziers == {"bezier": 3, "cornell_bezier": 1,
                              "points_chain": 11}[name]
    ins = _lane_inputs(m, 512, 512, 100, dtype, cuda, box=box, aim=aim)
    assert int(_ribbon_lanes(plan, pk, ins).sum()) > m // 100
    w, w_sc = _stacked(bounce.step(plan, pk, *ins))
    g, g_sc = _stacked(bounce.step_cuda(plan, pk, *ins))
    torch.cuda.synchronize()
    if dtype == torch.float64:
        rtol, atol, max_off = 1e-9, 1e-9, 0
    else:
        rtol, max_off = 1e-4, m // 1000
    off = (g_sc != w_sc) | ((g - w).abs() > atol + rtol * w.abs()).any(0)
    assert torch.isfinite(g).all()
    assert w_sc.any() and int(off.sum()) <= max_off, int(off.sum())


@pytest.mark.parametrize("name", sorted(BEZIER_SCENES))
def test_step_cuda_bwd_matches_step_vjp_on_beziers(cuda, name):
    # f64: every lane cotangent within 1e-9 and every pk slot within 1e-8 of
    # the largest; the control points' slots nonzero, the width's zero; two
    # launches bitwise equal
    m = 24 * 1024
    dtype = torch.float64
    plan, pk, box, aim, _ = _bezier_setup(name, dtype, cuda)
    ins = _lane_inputs(m, 512, 512, 100, dtype, cuda, box=box, aim=aim)
    r = np.random.default_rng(7)
    cts = bounce.split_lanes([torch.tensor(x, dtype=dtype, device=cuda)
                              for x in r.normal(size=(13, m))])
    want = bounce.step_vjp(plan, pk, *ins, *cts)
    got = bounce.step_cuda_bwd(plan, pk, *ins, *cts)
    again = bounce.step_cuda_bwd(plan, pk, *ins, *cts)
    torch.cuda.synchronize()
    (want_pk, want), (got_pk, got), (again_pk, again) = (
        _vjp_lanes(x) for x in (want, got, again))
    assert torch.equal(got_pk, again_pk) and torch.equal(got, again)
    assert torch.isfinite(got).all() and torch.isfinite(got_pk).all()
    assert not ((got - want).abs() > 1e-9 + 1e-9 * want.abs()).any()
    assert (got_pk - want_pk).abs().max() <= 1e-8 * want_pk.abs().max()
    blocks = got_pk[plan.bez_base:plan.bez_base + plan.n_beziers
                    * bounce.BEZ_SIZE].reshape(-1, bounce.BEZ_SIZE)
    assert bool((blocks[:, bounce.B_CP:bounce.B_CP + 12] != 0).all())
    assert not bool(blocks[:, bounce.B_W].any())


def _one_lane(cp, width, o, d, dtype, device, **plan_changes):
    """One bezier under the black sky and one live lane with a given ray
    (the setup of tests/test_torch_bezier.py's single lanes): plan, pk, the
    step's inputs and cotangents on the hit point alone."""
    objs = [ob.Bezier(np.asarray(cp, float), width,
                      ob.Lambertian((0.5, 0.5, 0.5)))]
    scene = compile_scene(objs, sky="black", dtype=dtype, device=device)
    cam = scenes.SceneSpec(objs, scenes.default_camera(), "black").camera(
        dtype=dtype, aspect=1.0, device=device)
    plan = dataclasses.replace(
        bounce.pool_plan(scene, RenderConfig(nx=4, ny=4, spp=1, max_depth=8)),
        **plan_changes)
    f = lambda v: torch.tensor([v], dtype=dtype, device=device)
    ins = (torch.tensor([7], dtype=torch.int32, device=device), f(0.0),
           f(0.0), torch.tensor([False], device=device),
           torch.tensor([True], device=device),
           torch.tensor([0], dtype=torch.int32, device=device),
           *bounce.split_lanes([f(v) for v in (*o, *d, 0.0, 0, 0, 0, 1, 1,
                                               1)]))
    cts = bounce.split_lanes([f(v) for v in (0.3, -0.7, 1.1,
                                             *([0.0] * 10))])
    return plan, bounce.pack(scene, cam, plan, dtype), ins, cts


# The lanes of tests/test_torch_bezier.py: a planar loop seen along its
# normal above its crossing (two roots at one distance, bit for bit: the
# fold over seeds splits the cotangent between them), and a ray for which,
# with one seed and no Newton step, g'' equals the curvature floor bit for
# bit.
LOOP_CP = [[-1, -0.2, -2], [3, 0.6, -2], [-3, 0.6, -2], [1, -0.2, -2]]
LOOP_O, LOOP_D = (0.0, 0.0405, 0.5), (0.0, 0.0, -1.0)
TIE_CP = [[-0.25, -0.75, -2.0], [0.75, 0.0, -2.5], [1.0, 1.0, -3.0],
          [1.0, -0.25, -3.5]]
TIE_O = (0.390625, float.fromhex("0x1.d99999999f774p-6"), 0.5)


@pytest.mark.parametrize("lane", ["fold", "floor-tie", "floor-below",
                                  "floor-above"])
def test_step_cuda_bwd_on_the_bezier_tie_lanes(cuda, lane):
    # K2 weighs tied seeds at different roots as the fold over seeds does,
    # and splits the cotangent at the curvature floor's tie (max_adj), as the
    # plain VJP does; f64, the control points' slots within 1e-12 of the
    # largest
    dtype = torch.float64
    if lane == "fold":
        plan, pk, ins, cts = _one_lane(LOOP_CP, 0.4, LOOP_O, LOOP_D, dtype,
                                       cuda)
        s, cand = bounce._bezier_candidates(
            plan, pk.unbind(0), plan.bez_base, ins[6], ins[7], 1e-3, 1e9)
        tied = cand[:, 0] == cand[:, 0].min()
        assert int(tied.sum()) >= 4
        assert float(s[tied, 0].max() - s[tied, 0].min()) > 0.5
    else:
        oy = TIE_O[1] * {"floor-tie": 1.0, "floor-below": 1 - 1e-9,
                         "floor-above": 1 + 1e-9}[lane]
        plan, pk, ins, cts = _one_lane(TIE_CP, 1.0, (TIE_O[0], oy, TIE_O[2]),
                                       (0.0, 0.0, -1.0), dtype, cuda,
                                       bez_seeds=1, bez_newton=0)
    want_pk, want = _vjp_lanes(bounce.step_vjp(plan, pk, *ins, *cts))
    got_pk, got = _vjp_lanes(bounce.step_cuda_bwd(plan, pk, *ins, *cts))
    torch.cuda.synchronize()
    cp = slice(plan.bez_base + bounce.B_CP, plan.bez_base + bounce.B_CP + 12)
    assert float(want_pk[cp].abs().max()) > 0.1
    assert ((got_pk - want_pk).abs().max()
            <= 1e-12 * want_pk.abs().max())
    assert not ((got - want).abs() > 1e-12 + 1e-12 * want.abs()).any()


@pytest.mark.parametrize("name", ["bezier", "cornell_bezier"])
def test_packed_kernels_on_the_bezier_scenes(cuda, name):
    # K3 against step_packed (K1's bounds), and one K4 chunk bitwise equal
    # to 32 K3 launches
    plan, pk, box, aim, atol = _bezier_setup(name, torch.float32, cuda)
    n_pix = SPHERE_CFG.n_pixels
    q = dict(m=M_POOL, n_work=n_pix * SPHERE_CFG.spp, n_pix=n_pix, pix0=0,
             total_pix=n_pix)
    sb = torch.tensor([5], dtype=torch.int32, device=cuda)
    state = packed_state(M_POOL, q["n_work"], plan.max_depth, cuda, box=box)
    want = bounce.step_packed(plan, pk, sb, state, **q)
    got = bounce.step_packed_cuda(plan, pk, sb, state, **q)
    g_i, w_i = got.view(torch.int32), want.view(torch.int32)
    off = ((g_i[0] != w_i[0]) | (got[1] != want[1]) | (g_i[2] != w_i[2])
           | ((got[3:] - want[3:]).abs()
              > atol + 1e-4 * want[3:].abs()).any(0))
    assert torch.isfinite(got[3:]).all()
    assert int(off.sum()) <= M_POOL // 1000, int(off.sum())
    T = persist.CHUNK_T
    got_state, got_flush, got_segs = persist.chunk_cuda(plan, pk, sb, state,
                                                        T=T, **q)
    st = state
    flush = torch.empty_like(got_flush)
    segs = torch.empty_like(got_segs)
    for t in range(T):
        item = st.view(torch.int32)[0]
        segs[t] = (item < q["n_work"]).sum()
        st = bounce.step_packed_cuda(plan, pk, sb, st, **q)
        done = st[1] != 0.0
        flush.view(torch.int32)[t, 0] = torch.where(done, item % n_pix, -1)
        flush[t, 1:] = torch.where(done, st[10:13], 0.0)
    torch.cuda.synchronize()
    assert torch.equal(got_state.view(torch.int32), st.view(torch.int32))
    assert torch.equal(got_flush.view(torch.int32), flush.view(torch.int32))
    assert torch.equal(got_segs, segs) and int(segs.sum()) > 0


@pytest.mark.parametrize("golden,scene_fn", [
    ("config5_bezier", scenes.test_bezier),
    ("config6_cornell_bezier", scenes.cornell_bezier)])
def test_cuda_render_matches_bezier_goldens(cuda, golden, scene_fn):
    spec = scene_fn()
    scene = compile_scene(spec.objects, sky=spec.sky)
    cam = spec.camera(aspect=1.0)
    cfg = RenderConfig(nx=64, ny=64, spp=4, max_depth=100, seed=0)
    before = launches("K1")
    mean, state = render.render_image(scene, cam, cfg)
    assert mean.device.type == "cuda" and launches("K1") > before
    ref = np.load(os.path.join(os.path.dirname(GOLDEN),
                               golden + ".npz"))["image"]
    img = mean.cpu().numpy().astype(np.float64)
    assert np.isfinite(img).all()
    diff = np.abs(img - ref)
    assert diff.mean() < 5e-3, diff.mean()
    assert (diff.max(axis=-1) > 0.05).mean() < 0.01


def test_cuda_diff_render_on_the_bezier_scene(cuda):
    # drained, the forward render's image bitwise, K2 launched once per K1
    # launch, and two steps' gradients bitwise equal (the control points'
    # among them; the width's zero)
    spec = scenes.test_bezier()
    scene = compile_scene(spec.objects, sky=spec.sky)
    cam = spec.camera(aspect=1.0)
    cfg = RenderConfig(nx=32, ny=32, spp=2, max_depth=12)
    n_iters = diff_fused.calibrate_iters(scene, cam, cfg)
    params, rest = build.partition(scene)

    def step():
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        raw, _, leftover = diff_fused.render_diff_fused(
            build.combine(leaves, rest), cam, cfg, n_iters)
        grads = torch.autograd.grad(raw.mean(), list(leaves.values()),
                                    allow_unused=True)
        return raw.detach(), int(leftover), dict(zip(leaves, grads))

    fwd, bwd = launches("K1"), launches("K2")
    raw, leftover, grads = step()
    assert leftover == 0
    assert launches("K1") - fwd == launches("K2") - bwd > 0
    st, _, _ = render.render_with_stats(scene, cam, cfg,
                                        render.init_state(cfg))
    assert torch.equal(raw, st.raw_sum.reshape(-1, 3))
    _, _, grads2 = step()
    assert float(grads["bez_cp"].abs().max()) > 0
    assert grads["bez_w"] is None or not bool(grads["bez_w"].any())
    for k, g in grads.items():
        if g is not None:
            assert torch.isfinite(g).all() and torch.equal(g, grads2[k]), k


# --- the kernels' builds per feature set ----------------------------------


def test_a_plan_loads_its_own_variant(cuda):
    # Cornell and the bezier scene go through different libraries of one
    # kernel, each named by its plan's feature set
    scene, cam = _cornell(torch.float32, cuda)
    cfg = RenderConfig(nx=16, ny=16, spp=1, max_depth=8, light_sampling=True)
    plan = bounce.pool_plan(scene, cfg)
    ins = _lane_inputs(256, 16, 16, 8, torch.float32, cuda)
    bounce.step_cuda(plan, bounce.pack(scene, cam, plan, torch.float32), *ins)
    b_plan, b_pk, box, aim, _ = _bezier_setup("bezier", torch.float32, cuda)
    bounce.step_cuda(b_plan, b_pk, *_lane_inputs(
        256, 512, 512, 100, torch.float32, cuda, box=box, aim=aim))
    torch.cuda.synchronize()
    base = cuda_build.LOADED[cuda_build.variant_name("bounce_step")]
    bez = cuda_build.LOADED[cuda_build.variant_name(
        "bounce_step", ("spheres", "bezier"))]
    assert base["path"] != bez["path"]
    assert "-DSRT" not in base["log"].splitlines()[0]
    assert "-DSRT_BEZIER=1" in bez["log"].splitlines()[0]
    # the Cornell variant spends fewer registers than the bezier one
    regs = lambda info: max(r["registers"]
                            for r in cuda_build.resources(info["log"]))
    assert regs(base) < regs(bez)


def test_a_variant_refuses_a_plan_it_does_not_cover(cuda):
    # the C entry point of the base variant returns cudaErrorInvalidValue
    # for a plan with ribbons: no launch, and nothing to fall back on.  The
    # wrapper's own loader declares the entry point's arguments (the tile
    # width among them, after m).
    b_plan, b_pk, box, aim, _ = _bezier_setup("cornell_bezier", torch.float32,
                                              cuda)
    fn = bounce._kernel(dataclasses.replace(b_plan, n_beziers=0))
    ptrs = (ctypes.c_void_p * 35)()
    err = fn(0, ptrs, 256, 1, *bounce.scene_args(b_plan),
             torch.cuda.current_stream().cuda_stream)
    assert err == 1                                # cudaErrorInvalidValue


# --- the klein scenes (K1-K4; chip_smoke.py's phases 24-27) ---------------

KLEIN_SCENES = {"klein": (scenes.klein_scene, False),
                "cornell_klein": (scenes.cornell_klein, True)}


def _klein_setup(name, dtype, device, m, seed=2):
    """(plan, pk, the step's inputs, f32 atol) of a KLEIN_SCENES entry at
    512^2 spp8: chip_smoke.py's lanes, aimed at the fractal from outside
    its precull ball on the cameras' side, one in ten born near its centre;
    the atol scaled as _sphere_setup scales it."""
    spec_fn, ls = KLEIN_SCENES[name]
    spec = spec_fn()
    scene = compile_scene(spec.objects, sky=spec.sky, dtype=dtype,
                          device=device)
    cam = spec.camera(dtype=dtype, aspect=1.0, device=device)
    plan = bounce.pool_plan(scene, SPHERE_CFG.replace(light_sampling=ls))
    c = scene.kl_center[0].double().cpu().numpy()
    r = np.random.default_rng(seed + 1000)
    u = r.normal(size=(3, m))
    u[2] = -np.abs(u[2]) - 1.0
    u /= np.linalg.norm(u, axis=0)
    o = c[:, None] + u * r.uniform(730.0, 1000.0, m)
    inside = r.random(m) < 0.1
    o[:, inside] = c[:, None] + r.uniform(-100.0, 100.0,
                                          (3, int(inside.sum())))
    dv = c[:, None] + r.uniform(-300.0, 300.0, (3, m)) - o
    dv /= np.linalg.norm(dv, axis=0)
    ins = _lane_inputs(m, 512, 512, 100, dtype, device, seed=seed)
    f = lambda x: torch.tensor(x, dtype=dtype, device=device)
    ins = (*ins[:6], tuple(f(x) for x in o), tuple(f(x) for x in dv),
           *ins[8:])
    scale = 555.0
    if scene.has_spheres:
        scale = max(float(scene.sph_c0.abs().max()),
                    float(scene.sph_r.abs().max()))
    return plan, bounce.pack(scene, cam, plan, dtype), ins, 1e-3 * scale / 555


def _klein_winners(plan, pk, ins):
    """The live lanes whose closest hit is the klein: the record's t beats
    that of the plan without it."""
    gitem, px, py, fresh, alive, depth, o, d, time = ins[:9]
    recs = [bounce.hit_record(p, pk, gitem, px, py, fresh, depth, o, d,
                              time)[3]
            for p in (plan, dataclasses.replace(plan, n_kleins=0))]
    return alive & recs[0]["hit"] & (~recs[1]["hit"]
                                     | (recs[0]["t"] < recs[1]["t"]))


@pytest.mark.parametrize("name", sorted(KLEIN_SCENES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_step_cuda_matches_plain_step_on_kleins(cuda, dtype, name):
    # the bounds of test_step_cuda_matches_plain_step_on_spheres, on lanes
    # aimed at the fractal: f64 every lane, f32 all but 0.1%
    m = 64 * 1024
    plan, pk, ins, atol = _klein_setup(name, dtype, cuda, m)
    assert plan.n_kleins == 1 and bounce.kernel_features(plan)[-1] == "klein"
    assert int(_klein_winners(plan, pk, ins).sum()) > m // 100
    w, w_sc = _stacked(bounce.step(plan, pk, *ins))
    g, g_sc = _stacked(bounce.step_cuda(plan, pk, *ins))
    torch.cuda.synchronize()
    if dtype == torch.float64:
        rtol, atol, max_off = 1e-9, 1e-9, 0
    else:
        rtol, max_off = 1e-4, m // 1000
    off = (g_sc != w_sc) | ((g - w).abs() > atol + rtol * w.abs()).any(0)
    assert torch.isfinite(g).all()
    assert w_sc.any() and int(off.sum()) <= max_off, int(off.sum())


@pytest.mark.parametrize("name", sorted(KLEIN_SCENES))
def test_step_cuda_bwd_matches_step_vjp_on_kleins(cuda, name):
    # f64: every lane cotangent within 1e-9 and every pk slot within 1e-10 of
    # the largest; the klein's centre slots nonzero; two launches bitwise
    # equal
    m = 24 * 1024
    dtype = torch.float64
    plan, pk, ins, _ = _klein_setup(name, dtype, cuda, m, seed=3)
    r = np.random.default_rng(7)
    cts = bounce.split_lanes([torch.tensor(x, dtype=dtype, device=cuda)
                              for x in r.normal(size=(13, m))])
    want = bounce.step_vjp(plan, pk, *ins, *cts)
    got = bounce.step_cuda_bwd(plan, pk, *ins, *cts)
    again = bounce.step_cuda_bwd(plan, pk, *ins, *cts)
    torch.cuda.synchronize()
    (want_pk, want), (got_pk, got), (again_pk, again) = (
        _vjp_lanes(x) for x in (want, got, again))
    assert torch.equal(got_pk, again_pk) and torch.equal(got, again)
    assert torch.isfinite(got).all() and torch.isfinite(got_pk).all()
    assert not ((got - want).abs() > 1e-9 + 1e-9 * want.abs()).any()
    assert (got_pk - want_pk).abs().max() <= 1e-10 * want_pk.abs().max()
    kc = got_pk[plan.kl_base + bounce.K_C:plan.kl_base + bounce.K_C + 3]
    assert bool((kc != 0).all())


@pytest.mark.parametrize("name", sorted(KLEIN_SCENES))
def test_packed_kernels_on_the_klein_scenes(cuda, name):
    # K3 against step_packed (K1's bounds), and one K4 chunk bitwise equal
    # to 32 K3 launches
    plan, pk, ins, atol = _klein_setup(name, torch.float32, cuda, M_POOL)
    n_pix = SPHERE_CFG.n_pixels
    q = dict(m=M_POOL, n_work=n_pix * SPHERE_CFG.spp, n_pix=n_pix, pix0=0,
             total_pix=n_pix)
    sb = torch.tensor([5], dtype=torch.int32, device=cuda)
    state = packed_state(M_POOL, q["n_work"], plan.max_depth, cuda)
    state[3:9] = torch.stack([*ins[6], *ins[7]])
    want = bounce.step_packed(plan, pk, sb, state, **q)
    got = bounce.step_packed_cuda(plan, pk, sb, state, **q)
    g_i, w_i = got.view(torch.int32), want.view(torch.int32)
    off = ((g_i[0] != w_i[0]) | (got[1] != want[1]) | (g_i[2] != w_i[2])
           | ((got[3:] - want[3:]).abs()
              > atol + 1e-4 * want[3:].abs()).any(0))
    assert torch.isfinite(got[3:]).all()
    assert int(off.sum()) <= M_POOL // 1000, int(off.sum())
    T = persist.CHUNK_T
    got_state, got_flush, got_segs = persist.chunk_cuda(plan, pk, sb, state,
                                                        T=T, **q)
    st = state
    flush = torch.empty_like(got_flush)
    segs = torch.empty_like(got_segs)
    for t in range(T):
        item = st.view(torch.int32)[0]
        segs[t] = (item < q["n_work"]).sum()
        st = bounce.step_packed_cuda(plan, pk, sb, st, **q)
        done = st[1] != 0.0
        flush.view(torch.int32)[t, 0] = torch.where(done, item % n_pix, -1)
        flush[t, 1:] = torch.where(done, st[10:13], 0.0)
    torch.cuda.synchronize()
    assert torch.equal(got_state.view(torch.int32), st.view(torch.int32))
    assert torch.equal(got_flush.view(torch.int32), flush.view(torch.int32))
    assert torch.equal(got_segs, segs) and int(segs.sum()) > 0


def test_a_variant_without_klein_refuses_a_klein_plan(cuda):
    # the spheres-only variant's C entry points return
    # cudaErrorInvalidValue for klein_scene's plan (a ground sphere and a
    # klein): no launch, and nothing to fall back on.  The wrappers' own
    # loaders declare the entry points' arguments (the tile width among
    # them, after m and, in K2, P).
    plan, _, _, _ = _klein_setup("klein", torch.float32, cuda, 256)
    spheres = dataclasses.replace(plan, n_kleins=0)
    for fn, n_ptrs, size in ((bounce._kernel(spheres), 35, []),
                             (bounce._kernel_bwd(spheres), 48, [plan.size])):
        ptrs = (ctypes.c_void_p * n_ptrs)()
        err = fn(0, ptrs, 256, *size, 1, *bounce.scene_args(plan),
                 torch.cuda.current_stream().cuda_stream)
        assert err == 1, n_ptrs                    # cudaErrorInvalidValue


# --- the tile of threads a lane (K1, K2; chip_smoke.py's kernel-tile) -----

TILE_CASES = ["cornell_tie", "spheres_tie", "rtow", "bezier", "cornell_klein"]


@pytest.mark.parametrize("name", TILE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_tile_widths_equal_the_one_thread_search(cuda, dtype, name):
    # K1 at every tile width gives w = 1's 14 outputs bit for bit, and K2
    # its 13 lane cotangents, with dpk (summed in another order) within its
    # stated bound; the tie plans meet the duplicated primitive on most lanes
    import chip_smoke
    m = 4096
    plan, pk, inputs = chip_smoke.tile_case(name, dtype, cuda)
    ins = inputs(m, 0)
    ref = _stacked(bounce.step_cuda(plan, pk, *ins, tile=1))
    r = np.random.default_rng(103)
    bins = inputs(m, 3)
    cts = bounce.split_lanes([torch.tensor(x, dtype=dtype, device=cuda)
                              for x in r.normal(size=(13, m))])
    ref_pk, *ref_g = bounce.step_cuda_bwd(plan, pk, *bins, *cts, tile=1)
    ref_pk, ref_g = _dpk_vec((ref_pk,)), torch.stack(
        bounce.flat_lanes(*ref_g))
    lim = chip_smoke.k2_dpk_bound(
        dtype, ref_pk, 1e-10 if plan.n_kleins else chip_smoke.BWD_F64["dpk"])
    bits = chip_smoke.bits
    for w in bounce.TILE_WIDTHS[1:]:
        got = _stacked(bounce.step_cuda(plan, pk, *ins, tile=w))
        g_pk, *g = bounce.step_cuda_bwd(plan, pk, *bins, *cts, tile=w)
        torch.cuda.synchronize()
        assert torch.equal(bits(got[0]), bits(ref[0])), w
        assert torch.equal(got[1], ref[1]), w
        assert torch.equal(bits(torch.stack(bounce.flat_lanes(*g))),
                           bits(ref_g)), w
        assert bool(((_dpk_vec((g_pk,)) - ref_pk).abs() <= lim).all()), w


def test_tile_width_outside_the_kernels_raises(cuda):
    import chip_smoke
    plan, pk, inputs = chip_smoke.tile_case("cornell", torch.float32, cuda)
    ins = inputs(256, 0)
    before = launches("K1")
    with pytest.raises(ValueError, match="tile width"):
        bounce.step_cuda(plan, pk, *ins, tile=3)
    with pytest.raises(ValueError, match="tile width"):
        bounce.step_cuda(plan, pk, *ins, tile=16)
    assert launches("K1") == before


# --- the tile in the packed kernels (K3, K4; chip_smoke.py's kernel-tile) --

PACKED_TILE_CASES = ["cornell", "rtow", "textured", "cornell_smoke", "bezier",
                     "cornell_bezier", "klein", "cornell_klein",
                     "cornell_tie", "spheres_tie"]


def _same_chunk(got, want):
    import chip_smoke
    return all(chip_smoke.same_chunk(got, want))


@pytest.mark.parametrize("name", PACKED_TILE_CASES)
def test_packed_tile_widths_equal_one_thread(cuda, name):
    # K3 at every tile width gives w = 1's 16 state rows bit for bit; one K4
    # chunk at every width gives w = 1's and CHUNK_T K3 launches' state,
    # flush rows and segments bit for bit; two chunks from one state give
    # equal segments
    import chip_smoke
    assert PACKED_TILE_CASES == list(chip_smoke.TILE_SCENES)
    (plan, pk, q, sb), state_of = chip_smoke.packed_tile_case(name, cuda,
                                                              m=4096)
    T = persist.CHUNK_T
    st3, st4 = state_of(0), state_of(1)
    k3 = bounce.step_packed_cuda(plan, pk, sb, st3, **q, tile=1)
    chain, _ = chip_smoke.k3_chunk(plan, pk, sb, st4, q, T, tile=1,
                                   ops=False)
    assert int(chain[2].sum()) > 0
    for w in bounce.TILE_WIDTHS:
        got3 = bounce.step_packed_cuda(plan, pk, sb, st3, **q, tile=w)
        got4 = persist.chunk_cuda(plan, pk, sb, st4, T=T, **q, tile=w)
        again = persist.chunk_cuda(plan, pk, sb, st4, T=T, **q, tile=w)
        torch.cuda.synchronize()
        assert torch.equal(got3.view(torch.int32), k3.view(torch.int32)), w
        assert _same_chunk(got4, chain), w
        assert torch.equal(again[2], got4[2]), w


def test_packed_tile_width_outside_the_kernels_raises(cuda):
    import chip_smoke
    (plan, pk, q, sb), state_of = chip_smoke.packed_tile_case(
        "cornell", cuda, m=256)
    st = state_of(0)
    before = (launches("K3"), launches("K4"))
    for tile in (3, 16):
        with pytest.raises(ValueError, match="tile width"):
            bounce.step_packed_cuda(plan, pk, sb, st, **q, tile=tile)
        with pytest.raises(ValueError, match="tile width"):
            persist.chunk_cuda(plan, pk, sb, st, T=2, **q, tile=tile)
    assert (launches("K3"), launches("K4")) == before


def test_packed_kernels_refuse_a_tile_width(cuda):
    # past the wrappers, the C side refuses a width too
    plan, pk, q = _packed_plan(cuda)
    for fn, n_ptrs, head in ((bounce._kernel_packed(plan), 5, (3,)),
                             (persist._kernel(plan), 7, (2, 3))):
        ptrs = (ctypes.c_void_p * n_ptrs)()
        err = fn(ptrs, *head, *bounce.queue_args(plan, 256, 256, 256, 0, 256),
                 torch.cuda.current_stream().cuda_stream)
        assert err == 1, n_ptrs                    # cudaErrorInvalidValue


# ---------------------------------------------------------------------------
# The general pool (integrator/pool.render_pool) on the card: plain PyTorch,
# no kernel of K1-K6.
# ---------------------------------------------------------------------------

def test_general_flush_is_the_lane_order_sum_on_the_card(cuda):
    """pool.flush_add_ on CUDA tensors (rounds of index_add_ into unique
    rows) equals the CPU's serial index_add_ bit for bit, where lane order
    shows in float32."""
    from scheme_raytrace_torch.integrator import pool
    g = torch.Generator().manual_seed(0)
    m, n_pix = 65536, 40000
    pix = torch.arange(m) % n_pix
    done = torch.rand(m, generator=g) < 0.7
    val = torch.where(done[:, None], (torch.rand(m, 3, generator=g) - 0.5)
                      * torch.exp(8 * torch.randn(m, 3, generator=g)), 0.0)
    raw0 = torch.randn(n_pix, 3, generator=g)
    want = raw0.clone().index_add_(0, pix, val)
    assert not torch.equal(raw0.clone().index_add_(0, pix.flip(0),
                                                   val.flip(0)), want)
    buf = torch.cat([raw0, torch.zeros(m, 3)]).to(cuda)
    got = pool.flush_add_(buf, pix.to(cuda), val.to(cuda), done.to(cuda))
    assert torch.equal(got[:n_pix].cpu(), want)


@pytest.mark.parametrize("case", ["random-sah", "random-median",
                                  "cornell-rr", "random-sort"])
def test_general_pool_on_the_card_equals_the_cpu_f64(cuda, case):
    """The general pool in float64 on the card and on the CPU (both plain
    PyTorch): segments and iterations exact, the image within 1e-9; no
    kernel launches."""
    from scheme_raytrace_torch.integrator import pool
    name, opt = case.split("-")
    spec = (scenes.random_scene(seed=0) if name == "random"
            else scenes.cornell_box())
    bvh = opt if opt in ("sah", "median") else None
    kw = dict(sah=dict(traversal="bvh"), median=dict(traversal="bvh"),
              rr=dict(russian_roulette=True, light_sampling=True),
              sort=dict(material_sort=True))[opt]
    cfg = RenderConfig(nx=16, ny=16, spp=2, max_depth=100, dtype="f64", **kw)
    out = []
    before = (launches("K1"), launches("K3"),
              launches("K4"))
    for dev in (cuda, "cpu"):
        scene = compile_scene(spec.objects, sky=spec.sky, bvh=bvh,
                              dtype=torch.float64, device=dev)
        cam = spec.camera(aspect=1.0, dtype=torch.float64, device=dev)
        raw, segs, iters = pool.render_pool_auto(
            scene, cam, cfg, torch.zeros(256, 3, dtype=torch.float64,
                                         device=dev), 0)
        out.append((raw.cpu(), int(segs), iters))
    assert (launches("K1"), launches("K3"),
            launches("K4")) == before
    assert out[0][1:] == out[1][1:]
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-9, atol=1e-9)


def test_general_shade_sorted_is_bitwise_on_the_card(cuda):
    """material_sort on the card: the sorted render equals the masked one
    bit for bit in float32 (shade is elementwise on the card's lanes)."""
    from scheme_raytrace_torch.integrator import pool
    spec = scenes.random_scene(seed=0)
    scene = compile_scene(spec.objects, sky=spec.sky, device=cuda)
    cam = spec.camera(aspect=1.0, device=cuda)
    cfg = RenderConfig(nx=32, ny=32, spp=2, max_depth=100)
    z = torch.zeros(cfg.n_pixels, 3, device=cuda)
    a = pool.render_pool(scene, cam, cfg, z, 0)
    b = pool.render_pool(scene, cam, cfg.replace(material_sort=True), z, 0)
    assert torch.equal(a[0], b[0]) and int(a[1]) == int(b[1]) and a[2] == b[2]


def test_general_pool_over_4096_prims_on_the_card(cuda):
    """A scene over MAX_FUSED_PRIMS renders through render_image on the
    card (the general pool's [N, S] sweep, and its SAH BVH) with no kernel
    launch, and both images agree."""
    import chip_smoke
    spec = chip_smoke.grid_spec(chip_smoke.GRID_N)
    cfg = RenderConfig(nx=32, ny=32, spp=1, max_depth=100)
    imgs = []
    before = launches("K1")
    for bvh in (None, "sah"):
        scene = compile_scene(spec.objects, sky=spec.sky, bvh=bvh,
                              device=cuda)
        assert not bounce.supported(scene, cfg)
        mean, _ = render.render_image(
            scene, spec.camera(aspect=1.0, device=cuda),
            cfg.replace(traversal="bvh" if bvh else "brute"))
        imgs.append(mean)
    assert launches("K1") == before
    assert torch.isfinite(imgs[0]).all() and imgs[0].max() > 0
    assert (imgs[0] - imgs[1]).abs().mean() < 2e-3


# --- the differentiable wavefront on the card (plain PyTorch, no kernel) ----

def test_threefry_on_the_card_equals_the_cpu(cuda):
    """threefry keys, splits and draws on the card bit for bit the CPU's
    (which tests/test_torch_wavefront.py holds to jax.random)."""
    for seed in (0, 7):
        k_c, k_g = rng.root_key(seed, "cpu"), rng.root_key(seed, cuda)
        for dtype in (torch.float32, torch.float64):
            a = rng.uniform(rng.split(rng.fold_in(k_c, 3), 3), (257, 12),
                            dtype)
            b = rng.uniform(rng.split(rng.fold_in(k_g, 3), 3), (257, 12),
                            dtype)
            assert torch.equal(a, b.cpu())


@pytest.mark.parametrize("name", ["cornell_box", "cornell_smoke"])
def test_wavefront_on_the_card_equals_the_cpu_f64(cuda, name):
    """render_pass (while mode) and the scan's gradients in float64: the
    card against the CPU, the image within 1e-9 with the same segments, the
    gradients of every leaf and camera field within 1e-9 of the floor."""
    import chip_smoke
    spec = getattr(scenes, name)()
    cfg = RenderConfig(nx=8, ny=8, spp=1, max_depth=6, light_sampling=True,
                       dtype="f64")
    out = {}
    for where in (cuda, "cpu"):
        scene, cam = chip_smoke.spec_scene(spec, torch.float64, where)
        st = chip_smoke.wave_pass(scene, cam, cfg)
        _, grads, _ = chip_smoke.wave_grads(
            scene, cam, cfg.replace(max_depth=2, differentiable=True))
        out[str(where)] = st.radiance.cpu(), int(st.segments), grads
    (g, gs, gg), (c, cs, cg) = out[str(cuda)], out["cpu"]
    assert gs == cs and torch.allclose(g, c, rtol=1e-9, atol=1e-9)
    rel, top = chip_smoke.rel_to_floor(gg, cg)
    assert top > 0.0 and max(rel.values()) < 1e-9, rel
