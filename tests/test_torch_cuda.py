"""PyTorch port on the card: the CUDA bounce kernels against their plain
versions (the forward kernel against the plain step, the backward kernel
against the plain VJP), the CUDA render against the config-4 golden, and
the differentiable render on the card against the forward render.

Every test here needs an NVIDIA card (marker `cuda`) and skips without one.
The file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -o addopts=""
"""

import os

import numpy as np
import pytest
import torch

from scheme_raytrace_torch import render, scenes
from scheme_raytrace_torch.config import RenderConfig
from scheme_raytrace_torch.integrator import bounce, diff_fused
from scheme_raytrace_torch.scene import build, compile_scene

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


def _lane_inputs(m, nx, ny, max_depth, dtype, device, seed=2):
    """Numpy draws: random gitems (negatives included), fresh/alive masks,
    depths with some lanes at the cap, origins inside the box, unit
    directions, nonzero radiance and throughput."""
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
    f = lambda x: torch.tensor(x, dtype=dtype, device=device)
    return (torch.tensor(gitem, device=device), f(px), f(py),
            torch.tensor(fresh, device=device),
            torch.tensor(alive, device=device),
            torch.tensor(depth, device=device), tuple(f(x) for x in o),
            tuple(f(x) for x in dvec), f(np.zeros(m)),
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
    before = bounce.LAUNCHES
    got = bounce.step_cuda(plan, pk, *ins)
    torch.cuda.synchronize()
    assert bounce.LAUNCHES == before + 1
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
    before = bounce.LAUNCHES
    state, segs, iters = render.render_with_stats(
        scene, cam, cfg, render.init_state(cfg, device=cuda))
    assert bounce.LAUNCHES - before == iters
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
    before = bounce.BWD_LAUNCHES
    got_pk, got = _vjp_lanes(bounce.step_cuda_bwd(plan, pk, *ins, *cts))
    torch.cuda.synchronize()
    assert bounce.BWD_LAUNCHES == before + 1
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
    before = bounce.BWD_LAUNCHES
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
    assert bounce.BWD_LAUNCHES == before


def test_diff_render_on_card_equals_forward(cuda):
    scene, cam = _cornell(torch.float32, cuda)
    cfg = RenderConfig(nx=32, ny=32, spp=2, max_depth=100, seed=0,
                       light_sampling=True)
    n_iters = diff_fused.calibrate_iters(scene, cam, cfg)
    params, rest = build.partition(scene)
    params = {k: v.clone().requires_grad_() for k, v in params.items()}
    fwd, bwd = bounce.LAUNCHES, bounce.BWD_LAUNCHES
    raw, segs, leftover = diff_fused.render_diff_fused(
        build.combine(params, rest), cam, cfg, n_iters)
    grads = torch.autograd.grad(raw.mean(), list(params.values()),
                                allow_unused=True)
    torch.cuda.synchronize()
    assert int(leftover) == 0
    assert bounce.LAUNCHES - fwd == bounce.BWD_LAUNCHES - bwd > 0
    state, f_segs, _ = render.render_with_stats(
        scene, cam, cfg, render.init_state(cfg, device=cuda))
    assert int(segs) == int(f_segs)
    assert torch.equal(raw.detach(), state.raw_sum.reshape(-1, 3))
    grads = [g for g in grads if g is not None]
    assert all(torch.isfinite(g).all() for g in grads)
    assert any(g.abs().max() > 0 for g in grads)
