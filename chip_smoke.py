"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Drives scheme_raytrace_torch's two main paths on the card, the forward
render and the fwd+bwd training step of the Cornell box with mixture-PDF
light sampling (BASELINE config 4), in phases; any failure raises and the
exit code is non-zero:

  1. device: a CUDA card is required; prints nvidia-smi's name and power
     limit and the CUDA version PyTorch was built with;
  2. build: compiles csrc/bounce_step.cu and csrc/bounce_step_bwd.cu with
     nvcc (sm_90a), both at once, and loads them;
  3. forward kernel against plain: the CUDA bounce kernel against the plain
     PyTorch step on the same inputs, at the forward pool's width (65,536
     lanes), light sampling on and off, in float32 and float64, with times;
  4. backward kernel against plain: the CUDA backward kernel against the
     plain VJP (torch autograd of the plain step) at the reverse pool's
     width (24,576 lanes), on Cornell with light sampling on and off and on
     the kernels' coverage scene, in float32 and float64, with times;
  5. forward render against the reference: render_image at 64x64 spp8
     depth 100 against tests/goldens/config4_cornell_light.npz (the f64
     oracle), and one kernel launch per pool iteration;
  6. differentiable render against its references at the same size: a
     drained queue, the image equal to the forward render's bitwise,
     deterministic gradients, one backward launch per forward launch, and
     in float64 the AD gradient against central finite differences;
  7. full-size forward: 512x512 spp16 depth 100, one warm-up then five
     chained timed renders (rays/s counted as exact path segments), and one
     render under torch.profiler for the device-time breakdown;
  8. full-size fwd+bwd: 512x512 spp8 depth 100, one warm-up then five
     chained training steps (params -= 1e-6 grad), peak memory, and one
     step under torch.profiler.

The last two lines are the kernel table and the device line, as JSON.
Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from scheme_raytrace_torch import render, scenes
from scheme_raytrace_torch.config import RenderConfig
from scheme_raytrace_torch.integrator import bounce, diff_fused, pool_fused
from scheme_raytrace_torch.scene import build, compile_scene
from scheme_raytrace_torch.utils import cuda_build

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "config4_cornell_light.npz")
M = 64 * 1024                 # lanes: the pool width of the 512^2 render
FULL = RenderConfig(nx=512, ny=512, spp=16, max_depth=100, seed=0,
                    light_sampling=True)
CONFIG4 = RenderConfig(nx=64, ny=64, spp=8, max_depth=100, seed=0,
                       light_sampling=True)
# f32 kernel vs plain bounds (tests/test_bounce.py:180-187): rtol 1e-4,
# atol 1e-3 at Cornell's 0..555 coordinate scale; lanes outside them (f32
# branch flips: a rect-edge or threshold decision taken the other way) may
# be at most 0.1%.  f64: every lane within rtol 1e-9 / atol 1e-9.
F32_TOL = dict(rtol=1e-4, atol=1e-3)
F64_TOL = dict(rtol=1e-9, atol=1e-9)
MAX_FLIP_FRAC = 1e-3
M_BWD = 24 * 1024             # lanes: the reverse pool's width at 512^2
FULL_BWD = RenderConfig(nx=512, ny=512, spp=8, max_depth=100, seed=0,
                        light_sampling=True)
# backward kernel vs plain VJP bounds.  f64: lane cotangents within rtol /
# atol 1e-9, dpk within 1e-8 of max|dpk| (its sums run in another order).
# f32: tests/test_bounce_vjp.py:69-73, rtol 1e-3 and atol 1e-5 * max(1,
# max|ref|) per output, on the lanes whose forward agrees (F32_TOL).
BWD_F64 = dict(rtol=1e-9, atol=1e-9, dpk=1e-8)
BWD_F32 = dict(rtol=1e-3, atol=1e-5)
KERNELS = ("bounce_step", "bounce_step_bwd")


def log(*a):
    print(*a, flush=True)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count "
        f"{torch.cuda.device_count()}")
    return torch.device("cuda", 0), smi


def phase_build():
    """Both kernels compile at once (one nvcc each)."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as ex:
        list(ex.map(cuda_build.load, KERNELS))
    log(f"[build] {len(KERNELS)} kernels in {time.perf_counter() - t0:.1f} s")
    for name in KERNELS:
        info = cuda_build.LOADED[name]
        log(f"[build] {name}: {'built' if info['built'] else 'cached'} -> "
            f"{info['path']}")
        for line in info["log"].splitlines():
            if ("registers" in line or "spill" in line
                    or "error" in line.lower()):
                log(f"[build]   {line.strip()}")


def cornell(dtype, device, spec_fn=scenes.cornell_box):
    spec = spec_fn()
    scene = compile_scene(spec.objects, sky=spec.sky, dtype=dtype,
                          lights=spec.lights, device=device)
    return scene, spec.camera(dtype=dtype, aspect=1.0, device=device)


def lane_inputs(m, config, dtype, device, seed=0):
    """Numpy-seeded lanes of the kinds tests/test_bounce.py draws: random
    gitems (negatives included), pixels, fresh/alive masks, depths (some
    at the cap), origins inside the box, unit directions, and nonzero
    radiance/throughput."""
    r = np.random.default_rng(seed)
    gitem = r.integers(-2 ** 31, 2 ** 31, m, dtype=np.int64).astype(np.int32)
    px = r.integers(0, config.nx, m)
    py = r.integers(0, config.ny, m)
    fresh = r.random(m) < 0.5
    alive = fresh | (r.random(m) < 0.7)
    depth = r.integers(0, 4, m).astype(np.int32)
    depth[r.random(m) < 0.05] = config.max_depth
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


def flat(out):
    o, d, time_, rad, tp, sc = out
    return torch.stack([*o, *d, time_, *rad, *tp]), sc


def median_ms(fn, n=20):
    """Median elapsed time of fn() on the card over n runs (CUDA events
    around each call: host work inside the call that keeps the card waiting
    counts)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_kernels(fn, n=1):
    """Run fn() n times under torch.profiler; return the wall ms per run and
    {kernel name: (device us per run, launches per run)} from the device
    events alone (op rows on the host side are not counted)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    table = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, k = table.get(e.name, (0.0, 0))
            table[e.name] = (us + e.time_range.elapsed_us() / n, k + 1 / n)
    return wall_ms, table


def disagreeing(got, want, tol):
    """Lanes where scattering differs, an output is outside the bounds, or
    the kernel's output is not finite."""
    (g, g_sc), (w, w_sc) = got, want
    off = ((g - w).abs() > tol["atol"] + tol["rtol"] * w.abs()).any(0)
    return (g_sc != w_sc) | off | ~torch.isfinite(g).all(0)


def errors(got, want, tol):
    """(lanes disagreeing, of which scattering differs, max abs err on the
    other lanes)."""
    bad = disagreeing(got, want, tol)
    return (int(bad.sum()), int((got[1] != want[1]).sum()),
            float((got[0] - want[0]).abs()[:, ~bad].max()))


def phase_kernel(dev):
    results = []
    for dtype in (torch.float32, torch.float64):
        for ls in (True, False):
            cfg = FULL.replace(light_sampling=ls)
            scene, cam = cornell(dtype, dev)
            plan = bounce.make_plan(scene, cfg)
            pk = bounce.pack(scene, cam, plan, dtype)
            ins = lane_inputs(M, cfg, dtype, dev)
            want = flat(bounce.step(plan, pk, *ins))
            got = flat(bounce.step_cuda(plan, pk, *ins))
            torch.cuda.synchronize()
            tol = F64_TOL if dtype == torch.float64 else F32_TOL
            n_bad, n_sc, max_err = errors(got, want, tol)
            name = f"{'f64' if dtype == torch.float64 else 'f32'}-" \
                   f"{'light' if ls else 'cosine'}"
            log(f"[kernel] {name}: m={M} scattering {int(want[1].sum())} "
                f"lanes; kernel vs plain: lanes disagreeing {n_bad} "
                f"(scattering differs on {n_sc}; bounds rtol {tol['rtol']:g} "
                f"atol {tol['atol']:g}); max abs err on the other lanes "
                f"{max_err:.3e}")
            if dtype == torch.float32 and n_bad:
                # which side took the rounding: on the disagreeing lanes,
                # both f32 versions against the plain step in f64 on the
                # same (exactly widened) inputs
                wide = lambda x: (tuple(t.double() for t in x)
                                  if isinstance(x, tuple) else
                                  x.double() if x.is_floating_point() else x)
                ref = flat(bounce.step(plan, pk.double(),
                                       *[wide(x) for x in ins]))[0]
                lanes = disagreeing(got, want, tol)
                k_err = (got[0].double() - ref).abs()[:, lanes].amax(0)
                p_err = (want[0].double() - ref).abs()[:, lanes].amax(0)
                log(f"[kernel] {name}: of the {n_bad} disagreeing lanes the "
                    f"kernel is nearer the f64 step on "
                    f"{int((k_err < p_err).sum())}, the plain f32 step on "
                    f"{int((p_err < k_err).sum())}")
            k_wall = median_ms(lambda: bounce.step_cuda(plan, pk, *ins))
            p_wall = median_ms(lambda: bounce.step(plan, pk, *ins))
            _, k_tab = device_kernels(
                lambda: bounce.step_cuda(plan, pk, *ins), n=20)
            _, p_tab = device_kernels(lambda: bounce.step(plan, pk, *ins),
                                      n=5)
            k_ms = sum(us for us, _ in k_tab.values()) / 1e3
            p_ms = sum(us for us, _ in p_tab.values()) / 1e3
            k_launches = sum(k for _, k in k_tab.values())
            p_launches = sum(k for _, k in p_tab.values())
            log(f"[kernel] {name}: device time per step: kernel {k_ms:.4f} ms "
                f"({k_launches:.0f} launch), plain {p_ms:.4f} ms ({p_launches:.0f} "
                f"launches); elapsed per call (median of 20, host included): "
                f"kernel {k_wall:.4f} ms, plain {p_wall:.3f} ms")
            limit = 0 if dtype == torch.float64 else MAX_FLIP_FRAC * M
            if n_bad > limit:
                raise AssertionError(f"[kernel] {name}: {n_bad} lanes disagree "
                                     f"(limit {limit:g})")
            results.append(dict(name=name, max_abs_err=max_err, ms=k_ms,
                                plain_ms=p_ms, wall_ms=k_wall,
                                plain_wall_ms=p_wall, bad=n_bad))
    return results


def lanes_of(grads):
    """(dpk, do, dd, dtime, drad, dtp) -> (dpk, [13, m] lane cotangents)."""
    return grads[0], torch.stack(bounce.flat_lanes(*grads[1:]))


def phase_kernel_bwd(dev):
    results = []
    cases = (("cornell-light", scenes.cornell_box, True),
             ("cornell-cosine", scenes.cornell_box, False),
             ("materials-light", scenes.cornell_materials, True))
    for dtype in (torch.float32, torch.float64):
        f64 = dtype == torch.float64
        for case, spec_fn, ls in cases:
            name = f"{'f64' if f64 else 'f32'}-{case}"
            cfg = FULL_BWD.replace(light_sampling=ls)
            scene, cam = cornell(dtype, dev, spec_fn)
            plan = bounce.make_plan(scene, cfg)
            pk = bounce.pack(scene, cam, plan, dtype)
            ins = lane_inputs(M_BWD, cfg, dtype, dev, seed=3)
            r = np.random.default_rng(103)
            cts = [torch.tensor(x, dtype=dtype, device=dev)
                   for x in r.normal(size=(13, M_BWD))]
            # f32: lanes whose forward the kernel and the plain step take
            # differently (phase 3's flips) are left out, and given zero
            # cotangent for the dpk comparison
            keep = torch.ones(M_BWD, dtype=torch.bool, device=dev)
            if not f64:
                keep = ~disagreeing(flat(bounce.step_cuda(plan, pk, *ins)),
                                    flat(bounce.step(plan, pk, *ins)),
                                    F32_TOL)
            n_out = int((~keep).sum())
            if n_out > MAX_FLIP_FRAC * M_BWD:
                raise AssertionError(f"[kernel-bwd] {name}: {n_out} lanes "
                                     f"flip in the forward")
            cts = bounce.split_lanes([torch.where(keep, c, 0.0)
                                      for c in cts])
            want_pk, want = lanes_of(bounce.step_vjp(plan, pk, *ins, *cts))
            got_pk, got = lanes_of(bounce.step_cuda_bwd(plan, pk, *ins, *cts))
            again_pk, again = lanes_of(bounce.step_cuda_bwd(plan, pk, *ins,
                                                            *cts))
            torch.cuda.synchronize()
            if not (torch.equal(got_pk, again_pk) and torch.equal(got, again)):
                raise AssertionError(f"[kernel-bwd] {name}: two identical "
                                     f"launches differ")
            err = (got - want).abs()
            if f64:
                lane_bad = (err > BWD_F64["atol"]
                            + BWD_F64["rtol"] * want.abs()).any(0)
                pk_lim = BWD_F64["dpk"] * float(want_pk.abs().max())
                pk_bad = int(((got_pk - want_pk).abs() > pk_lim).sum())
            else:
                scale = torch.clamp(want[:, keep].abs().amax(1), min=1.0)
                lane_bad = (err > BWD_F32["atol"] * scale[:, None]
                            + BWD_F32["rtol"] * want.abs()).any(0) & keep
                pk_lim = (BWD_F32["atol"] * max(1.0, float(want_pk.abs().max()))
                          + BWD_F32["rtol"] * want_pk.abs())
                pk_bad = int(((got_pk - want_pk).abs() > pk_lim).sum())
            n_bad = int(lane_bad.sum())
            max_err = float(err[:, keep].max())
            pk_err = float((got_pk - want_pk).abs().max()
                           / want_pk.abs().max())
            args = (plan, pk, *ins, *cts)
            k_wall = median_ms(lambda: bounce.step_cuda_bwd(*args))
            p_wall = median_ms(lambda: bounce.step_vjp(*args), n=5)
            _, k_tab = device_kernels(lambda: bounce.step_cuda_bwd(*args),
                                      n=20)
            _, p_tab = device_kernels(lambda: bounce.step_vjp(*args), n=3)
            k_ms = sum(us for n_, (us, _) in k_tab.items()
                       if "bounce_step_bwd_kernel" in n_) / 1e3
            k_all = sum(us for us, _ in k_tab.values()) / 1e3
            p_ms = sum(us for us, _ in p_tab.values()) / 1e3
            p_launches = sum(k for _, k in p_tab.values())
            log(f"[kernel-bwd] {name}: m={M_BWD} P={plan.size}; lanes left "
                f"out (forward flips) {n_out}; lanes outside the bounds "
                f"{n_bad}, max abs err {max_err:.3e}; dpk slots outside "
                f"{pk_bad}, max err / max|dpk| {pk_err:.3e}; two launches "
                f"bitwise equal")
            log(f"[kernel-bwd] {name}: device time per call: kernel "
                f"{k_ms:.4f} ms (with the partials' sum {k_all:.4f} ms), plain "
                f"VJP {p_ms:.4f} ms ({p_launches:.0f} launches); elapsed per "
                f"call (median): kernel {k_wall:.4f} ms, plain {p_wall:.3f} ms")
            if n_bad or pk_bad:
                raise AssertionError(f"[kernel-bwd] {name}: {n_bad} lanes and "
                                     f"{pk_bad} dpk slots outside the bounds")
            results.append(dict(name=name, max_abs_err=max_err, ms=k_ms,
                                plain_ms=p_ms, wall_ms=k_wall,
                                plain_wall_ms=p_wall))
    return results


def phase_golden(dev):
    scene, cam = cornell(torch.float32, dev)
    start = bounce.LAUNCHES
    mean, state = render.render_image(scene, cam, CONFIG4)
    launches = bounce.LAUNCHES - start
    start = bounce.LAUNCHES
    state2, segs, iters = render.render_with_stats(
        scene, cam, CONFIG4, render.init_state(CONFIG4, device=dev))
    launches2 = bounce.LAUNCHES - start
    if not (launches == launches2 == iters):
        raise AssertionError(f"[golden] launches {launches}/{launches2} != "
                             f"pool iterations {iters}")
    if not torch.equal(state.raw_sum, state2.raw_sum):
        raise AssertionError("[golden] two identical renders differ")
    ref = np.load(GOLDEN)["image"]
    img = mean.cpu().numpy().astype(np.float64)
    if img.shape != ref.shape or not np.isfinite(img).all():
        raise AssertionError("[golden] image shape or finiteness")
    diff = np.abs(img - ref)
    mae, outliers = diff.mean(), (diff.max(axis=-1) > 0.05).mean()
    log(f"[golden] 64x64 spp8 depth100: segments {int(segs)} iters {iters} "
        f"launches {launches}; MAE {mae:.3e} (< 5e-3), pixels off by > 0.05: "
        f"{outliers:.4%} (< 1%)")
    if not (mae < 5e-3 and outliers < 0.01):
        raise AssertionError("[golden] image outside the config-4 bounds")


def fwd_bwd(scene, cam, cfg, n_iters, params, rest, loss_fn):
    """One training step: render_diff_fused of `params`, the loss, and its
    gradient for every leaf (zeros where a leaf is unused)."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    raw, segs, leftover = diff_fused.render_diff_fused(
        build.combine(leaves, rest), cam, cfg, n_iters)
    loss = loss_fn(raw)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(leaves.items(), grads)}
    return raw.detach(), loss.detach(), segs, leftover, grads


def phase_diff(dev):
    """The differentiable render at config 4's size: drained, equal to the
    forward image, deterministic, one backward launch per forward launch;
    in float64 the AD gradient against central finite differences."""
    scene, cam = cornell(torch.float32, dev)
    cfg = CONFIG4
    n_iters = diff_fused.calibrate_iters(scene, cam, cfg)
    params, rest = build.partition(scene)
    mean = lambda raw: raw.mean()
    bounce.LAUNCHES = bounce.BWD_LAUNCHES = 0
    raw, _, segs, leftover, grads = fwd_bwd(scene, cam, cfg, n_iters, params,
                                            rest, mean)
    torch.cuda.synchronize()
    launches, bwd_launches = bounce.LAUNCHES, bounce.BWD_LAUNCHES
    blocks = -(-n_iters // pool_fused.FLUSH_EVERY) * pool_fused.FLUSH_EVERY
    st, f_segs, _ = render.render_with_stats(
        scene, cam, cfg, render.init_state(cfg, device=dev))
    same_image = torch.equal(raw, st.raw_sum.reshape(-1, 3))
    _, _, _, _, grads2 = fwd_bwd(scene, cam, cfg, n_iters, params, rest, mean)
    same_grads = all(torch.equal(grads[k], grads2[k]) for k in grads)
    finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
    log(f"[diff] {cfg.nx}x{cfg.ny} spp{cfg.spp} depth{cfg.max_depth} f32: "
        f"n_iters {n_iters} -> {blocks} pool "
        f"iterations; leftover {int(leftover)}; segments {int(segs)} "
        f"(forward {int(f_segs)}); launches forward {launches} backward "
        f"{bwd_launches}; image equal to the forward render bitwise: "
        f"{same_image}; two steps' gradients bitwise equal: {same_grads}; "
        f"finite: {finite}")
    if int(leftover) != 0 or int(segs) != int(f_segs):
        raise AssertionError("[diff] the queue did not drain")
    if not (launches == bwd_launches == blocks):
        raise AssertionError(f"[diff] launches {launches}/{bwd_launches} != "
                             f"{blocks} pool iterations")
    if not (same_image and same_grads and finite):
        raise AssertionError("[diff] image, determinism or finiteness")

    scene, cam = cornell(torch.float64, dev)
    cfg = CONFIG4.replace(dtype="f64")
    n_iters = diff_fused.calibrate_iters(scene, cam, cfg)
    params, rest = build.partition(scene)
    _, _, _, leftover, grads = fwd_bwd(scene, cam, cfg, n_iters, params, rest,
                                       mean)
    eps = 1e-2
    out = {}
    for leaf, idx in (("tex_color", (0, 0)), ("rect_k", (0,))):
        def loss_at(x):
            p = dict(params)
            p[leaf] = params[leaf].clone()
            p[leaf][idx] += x
            with torch.no_grad():
                raw, _, lo = diff_fused.render_diff_fused(
                    build.combine(p, rest), cam, cfg, n_iters)
            if int(lo) != 0:
                raise AssertionError("[diff] an FD render did not drain")
            return float(raw.mean())
        ad = float(grads[leaf][idx])
        fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
        out[leaf] = (ad, fd)
        log(f"[diff] f64 d mean(image) / d {leaf}{list(idx)}: AD {ad:.8e}, "
            f"central FD (eps {eps:g}) {fd:.8e}, rel diff "
            f"{abs(ad - fd) / max(abs(fd), 1e-30):.3e}")
    ad, fd = out["tex_color"]
    if int(leftover) != 0 or not abs(ad - fd) < 0.01 * abs(fd):
        raise AssertionError("[diff] f64 tex_color AD not within 1% of FD")
    return dict(n_iters=n_iters)


def phase_full(dev):
    scene, cam = cornell(torch.float32, dev)
    bounce.LAUNCHES = 0                       # the main path's count starts
    total_iters = 0
    t0 = time.perf_counter()
    st, segs, iters = render.render_with_stats(
        scene, cam, FULL, render.init_state(FULL, device=dev))
    float(st.raw_sum[0, 0, 0])
    warm = time.perf_counter() - t0
    total_iters += iters
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        st, segs, iters = render.render_with_stats(scene, cam, FULL, st)
        float(st.raw_sum[0, 0, 0])
        times.append(time.perf_counter() - t0)
        total_iters += iters
    launches = bounce.LAUNCHES
    segs = int(segs)
    med = statistics.median(times)
    mean = (st.raw_sum / st.sample_count.to(torch.float32)).cpu().numpy()
    log(f"[full] {FULL.nx}x{FULL.ny} spp{FULL.spp} depth{FULL.max_depth} "
        f"light-sampled: m={M} segments {segs} "
        f"iters {iters}; warm-up {warm * 1e3:.1f} ms; times_ms "
        f"{[round(t * 1e3, 2) for t in times]}; median {med * 1e3:.2f} ms -> "
        f"{segs / med:.4e} rays/s; launches {launches} over 6 renders")
    if launches != total_iters or launches == 0:
        raise AssertionError(f"[full] launches {launches} != pool iterations "
                             f"{total_iters}")
    if not np.isfinite(mean).all() or mean.max() <= 0.0:
        raise AssertionError("[full] frame is not finite or is black")
    log(f"[full] frame mean {mean.mean():.4f} max {mean.max():.3f}")
    return dict(segments=segs, iters=iters, median_s=med, launches=launches)


def phase_profile(dev):
    """One 512^2 render under torch.profiler: device time by kernel and the
    card's busy share of the render's wall time."""
    scene, cam = cornell(torch.float32, dev)
    st = render.init_state(FULL, device=dev)
    wall_ms, table = device_kernels(
        lambda: render.render_with_stats(scene, cam, FULL, st))
    if not table:
        log("[profile] the profiler recorded no device time: not measured")
        return
    busy_ms = sum(us for us, _ in table.values()) / 1e3
    rows = sorted(((us, k, name) for name, (us, k) in table.items()),
                  reverse=True)
    log(f"[profile] one render: {wall_ms:.1f} ms wall under the profiler, "
        f"device busy {busy_ms:.2f} ms ({busy_ms / wall_ms:.1%}), "
        f"{sum(k for _, k, _ in rows):.0f} kernel launches")
    for us, k, name in rows[:12]:
        log(f"[profile]   {us / 1e3:8.3f} ms {k:6.0f} x  {name[:90]}")


def phase_full_bwd(dev):
    """512^2 spp8 fwd+bwd steps, as bench.py:_measure_fwd_bwd times them."""
    scene, cam = cornell(torch.float32, dev)
    cfg = FULL_BWD
    t0 = time.perf_counter()
    n_iters = diff_fused.calibrate_iters(scene, cam, cfg, slack=1.1)
    calib = time.perf_counter() - t0
    params, rest = build.partition(scene)
    loss_fn = lambda raw: (raw ** 2).sum() / raw.numel()
    bounce.LAUNCHES = bounce.BWD_LAUNCHES = 0  # the main path's count starts
    t0 = time.perf_counter()
    _, loss, segs, leftover, grads = fwd_bwd(scene, cam, cfg, n_iters,
                                             params, rest, loss_fn)
    float(loss)
    warm = time.perf_counter() - t0
    if int(leftover) != 0:
        raise AssertionError("[full-bwd] warm-up did not drain")
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        params = {k: v - 1e-6 * grads[k] for k, v in params.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, loss, segs, leftover, grads = fwd_bwd(scene, cam, cfg, n_iters,
                                                 params, rest, loss_fn)
        torch.cuda.synchronize()
        float(loss)
        times.append(time.perf_counter() - t0)
        if int(leftover) != 0:
            raise AssertionError("[full-bwd] a timed step did not drain")
    launches, bwd_launches = bounce.LAUNCHES, bounce.BWD_LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    segs = int(segs)
    med = statistics.median(times)
    blocks = -(-n_iters // pool_fused.FLUSH_EVERY) * pool_fused.FLUSH_EVERY
    log(f"[full-bwd] {cfg.nx}x{cfg.ny} spp{cfg.spp} depth{cfg.max_depth} "
        f"light-sampled f32: m={cfg.resolve_pool_rays(reverse=True)} "
        f"n_iters {n_iters} (calibration {calib * 1e3:.1f} ms) -> {blocks} "
        f"pool iterations; segments {segs}; warm-up {warm * 1e3:.1f} ms; "
        f"times_ms {[round(t * 1e3, 2) for t in times]}; median "
        f"{med * 1e3:.2f} ms -> {segs / med:.4e} fwd+bwd rays/s; peak memory "
        f"{peak / 2 ** 30:.3f} GiB; launches forward {launches} backward "
        f"{bwd_launches} over 6 steps")
    if not (launches == bwd_launches == 6 * blocks):
        raise AssertionError(f"[full-bwd] launches {launches}/{bwd_launches}"
                             f" != 6 x {blocks}")
    if not all(bool(torch.isfinite(g).all()) for g in grads.values()):
        raise AssertionError("[full-bwd] gradients are not finite")
    wall_ms, table = device_kernels(lambda: fwd_bwd(
        scene, cam, cfg, n_iters, params, rest, loss_fn))
    if not table:
        log("[full-bwd] the profiler recorded no device time: not measured")
    else:
        busy_ms = sum(us for us, _ in table.values()) / 1e3
        rows = sorted(((us, k, name) for name, (us, k) in table.items()),
                      reverse=True)
        log(f"[full-bwd] one step: {wall_ms:.1f} ms wall under the profiler, "
            f"device busy {busy_ms:.2f} ms ({busy_ms / wall_ms:.1%}), "
            f"{sum(k for _, k, _ in rows):.0f} kernel launches")
        for us, k, name in rows[:12]:
            log(f"[full-bwd]   {us / 1e3:8.3f} ms {k:6.0f} x  {name[:90]}")
        for us, k, name in rows:
            if "bounce_step" in name:
                log(f"[full-bwd]   ours: {us / 1e3:8.3f} ms {k:6.0f} x "
                    f"{us / k:8.2f} us each  {name[:70]}")
    return dict(segments=segs, median_s=med, launches=launches,
                bwd_launches=bwd_launches, peak=peak)


def main():
    dev, smi = phase_device()
    phase_build()
    kern = phase_kernel(dev)
    kern_bwd = phase_kernel_bwd(dev)
    phase_golden(dev)
    phase_diff(dev)
    full = phase_full(dev)
    phase_profile(dev)
    full_bwd = phase_full_bwd(dev)
    log(f"[paths] bounce_step launches: forward render {full['launches']}, "
        f"fwd+bwd step {full_bwd['launches']}; bounce_step_bwd launches: "
        f"fwd+bwd step {full_bwd['bwd_launches']}")
    f32 = [k for k in kern if k["name"].startswith("f32")]
    main_case = next(k for k in kern if k["name"] == "f32-light")
    f32_bwd = [k for k in kern_bwd if k["name"].startswith("f32")]
    main_bwd = next(k for k in kern_bwd if k["name"] == "f32-cornell-light")
    log(smi)
    print(json.dumps({"kernels": [{
        "name": "bounce_step",
        "route": "cuda",
        "source": "scheme_raytrace_torch/csrc/bounce_step.cu",
        "replaces": "scheme_raytrace_tpu/integrator/bounce.py:1576",
        "launches": full["launches"] + full_bwd["launches"],
        "max_abs_err": max(k["max_abs_err"] for k in f32),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
    }, {
        "name": "bounce_step_bwd",
        "route": "cuda",
        "source": "scheme_raytrace_torch/csrc/bounce_step_bwd.cu",
        "replaces": "scheme_raytrace_tpu/integrator/bounce.py:1687",
        "launches": full_bwd["bwd_launches"],
        "max_abs_err": max(k["max_abs_err"] for k in f32_bwd),
        "ms": main_bwd["ms"],
        "plain_ms": main_bwd["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
