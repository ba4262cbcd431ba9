"""PyTorch port: its telemetry (scheme_raytrace_torch/utils/telemetry.py) on
the CPU.

  * With no profiler running nothing is traced: a render leaves no span and
    no traced counter, and `span` is one shared no-op.
  * Under torch.profiler a frame's spans lie among the profiler's own
    events, `pool.iter` counts the pool's iterations, `pool.segments` and
    `pool.lane_slots` its exact segments and iterations times lanes, every
    span's self time is at most its total, and `units` counts the frames.
  * A training step on a mesh of one rank (gloo) records its autograd and
    all-reduce spans, and its `pool.segments` is the count the benchmark
    reads by wrapping the pool.
  * The benchmark's traced run of each cell, at a tiny size, reads the new
    per-layer metrics as numbers, and the kernel-loading metric leaves
    nvcc's builds out.
  * Process counters add up from many threads without losing a count, and
    `reset` clears the traced records only.

`k2.launch` lies on the card's backward only (tests/test_torch_cuda.py).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import math
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rtbench import program, run
from scheme_raytrace_torch import render as R
from scheme_raytrace_torch import scenes
from scheme_raytrace_torch.config import RenderConfig
from scheme_raytrace_torch.parallel import distributed as pdist
from scheme_raytrace_torch.parallel.render import (calibrate_iters_sharded,
                                                    train_step_fused)
from scheme_raytrace_torch.scene import build as sb
from scheme_raytrace_torch.scene import compile_scene
from scheme_raytrace_torch.utils import telemetry

CPU = torch.device("cpu")
POOL_SPANS = {"pool", "pool.iter", "pool.launch", "pool.fold", "pool.reissue",
              "pool.reissue.lanes", "pool.reissue.state"}
FRAME_SPANS = POOL_SPANS | {"frame", "pool.drain_check"}
STEP_SPANS = POOL_SPANS | {"train.step", "train.autograd", "train.allreduce"}
NEW_METRICS = {
    "frames": {"fwd.dispatch_us_per_iter", "fwd.drain_wait_ms_per_frame",
               "fwd.pool_occupancy_pct", "setup.kernels_s"},
    "steps": {"train.dispatch_us_per_iter", "train.autograd_ms_per_step",
              "train.pool_occupancy_pct", "setup.kernels_s"},
}


@pytest.fixture
def cornell():
    telemetry.reset()
    spec = scenes.cornell_box()
    scene = compile_scene(spec.objects, sky=spec.sky, device="cpu")
    cam = spec.camera(aspect=1.0, device="cpu")
    cfg = RenderConfig(nx=16, ny=16, spp=2, max_depth=12,
                       light_sampling=True)
    yield scene, cam, cfg
    telemetry.reset()


def _frames(scene, cam, cfg, n):
    """n progressive frames: (iters, segments) of each."""
    st, out = R.init_state(cfg, device="cpu"), []
    for _ in range(n):
        st, seg, iters = R.render_with_stats(scene, cam, cfg, st)
        out.append((iters, int(seg)))
    return out


def _host_names(prof):
    return {e.name() for e in prof.profiler.kineto_results.events()}


def _check_spans(snap):
    for name, s in snap["spans"].items():
        assert s["n"] > 0 and 0.0 <= s["self_s"] <= s["total_s"] + 1e-9, name


def test_untraced_render_records_nothing(cornell):
    assert telemetry.span("frame") is telemetry.span("pool.iter")
    _frames(*cornell, 1)
    assert telemetry.snapshot() == dict(spans={}, counters={}, units=0)


def test_traced_frames_spans_and_counters(cornell):
    scene, cam, cfg = cornell
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        runs = _frames(scene, cam, cfg, 2)
    snap = telemetry.snapshot()
    assert set(snap["spans"]) == FRAME_SPANS
    assert FRAME_SPANS <= _host_names(prof)        # on the profiler's timeline
    iters = sum(i for i, _ in runs)
    m = 256                                        # 16 x 16 pixels, one lane each
    assert snap["spans"]["pool.iter"]["n"] == iters
    assert snap["spans"]["pool.launch"]["n"] == iters
    assert snap["spans"]["pool.drain_check"]["n"] == iters // 8
    assert snap["counters"] == {"pool.segments": sum(s for _, s in runs),
                                "pool.lane_slots": iters * m}
    assert snap["units"] == 2 == snap["spans"]["frame"]["n"]
    _check_spans(snap)
    # a child's time is not its parent's own
    it = snap["spans"]["pool.iter"]
    assert it["self_s"] < it["total_s"]
    # after the profiler, nothing more is recorded
    _frames(scene, cam, cfg, 1)
    assert telemetry.snapshot() == snap


def test_train_step_records_autograd_and_segments(cornell):
    scene, cam, cfg = cornell
    cfg = cfg.replace(nx=8, ny=8, spp=1, max_depth=6)
    target = torch.zeros(cfg.ny, cfg.nx, 3)
    params, rest = sb.partition(scene)
    with pdist.single_process("cpu") as mesh, \
            program.SegmentCounter() as counter:
        n_iters = calibrate_iters_sharded(scene, cam, cfg, mesh)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _, loss, leftover = train_step_fused(params, rest, cam, cfg,
                                                 target, mesh, n_iters)
    assert int(leftover) == 0 and math.isfinite(float(loss))
    snap = telemetry.snapshot()
    assert set(snap["spans"]) == STEP_SPANS
    assert STEP_SPANS <= _host_names(prof)
    assert snap["units"] == 1 == snap["spans"]["train.autograd"]["n"]
    assert snap["spans"]["train.allreduce"]["n"] == 2   # grads, leftover
    assert snap["counters"]["pool.segments"] == int(counter.last)
    iters = snap["spans"]["pool.iter"]["n"]
    assert iters >= n_iters and iters % 8 == 0
    assert snap["counters"]["pool.lane_slots"] == iters * 128
    _check_spans(snap)


@pytest.mark.parametrize("cell, over", [
    ("cornell-fwd-512", {}), ("bezier-train-512", {"checked_steps": 1})])
def test_traced_cell_reads_the_new_metrics(cell, over):
    bench = run.benchmark()
    w = run.cell_of(bench, cell)
    tr = dict(run.load("traffic", w["traffic"]), nx=8, ny=8, spp=1, **over)
    telemetry.reset()
    try:
        line = run.run_cell(bench, w, 2 ** 31 + 20, 0.05, 1, CPU,
                            t0=time.perf_counter(), traffic=tr)
    finally:
        snap = telemetry.snapshot()
        telemetry.reset()
    assert snap["units"] == tr["trace_units"]
    got = line["metrics"]
    assert NEW_METRICS[tr["loop"]] <= set(got)
    for name in NEW_METRICS[tr["loop"]]:
        assert math.isfinite(got[name]["value"]), name
    assert got["setup.kernels_s"]["value"] == 0.0        # no kernel on the CPU
    occ = got[("fwd" if tr["loop"] == "frames" else "train")
              + ".pool_occupancy_pct"]["value"]
    assert 0.0 < occ <= 100.0


@pytest.mark.parametrize("load_s, build_s", [(0.6, 0.0), (16.1, 15.5)])
def test_kernel_loading_metric_leaves_the_build_out(monkeypatch, load_s,
                                                    build_s):
    # setup.kernels_s reads the same on a checkout's first run, which builds
    # the kernels, as on any later one
    monkeypatch.setattr(telemetry, "_COUNTERS", {})
    telemetry.count("kernels.load_s", load_s)
    if build_s:
        telemetry.count("kernels.build_s", build_s)
    got = run.reader("setup.kernels_s")({})
    assert got == pytest.approx(load_s - build_s)


def test_counts_from_threads_are_not_lost():
    name, n_threads, n = "test.threads", 16, 2000
    before = telemetry.counter(name)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [telemetry.count(name) for _ in range(n)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
    assert telemetry.counter(name) - before == n_threads * n


def test_spans_of_another_thread_are_not_children(cornell, monkeypatch):
    # autograd runs the card's backward, `k2.launch` among it, on a thread of
    # its own that carries the profiler's state over: a span there is no
    # child of the one open on the caller's thread.  (A thread that does not
    # carry it over sees no profiler: the gate is forced open here.)
    monkeypatch.setattr(telemetry, "_tracing", lambda: True)
    done = threading.Event()

    def other():
        with telemetry.span("other"):
            time.sleep(0.02)
        done.set()

    with telemetry.span("outer", unit=True):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=60)
        assert done.is_set()
        with telemetry.span("inner", unit=True):
            time.sleep(0.01)
    snap = telemetry.snapshot()
    outer, inner = snap["spans"]["outer"], snap["spans"]["inner"]
    assert snap["units"] == 1
    assert snap["spans"]["other"]["n"] == 1
    assert outer["total_s"] - outer["self_s"] == pytest.approx(
        inner["total_s"])
    assert outer["self_s"] >= 0.015          # the other thread's span is its own


def test_reset_keeps_process_counters_and_sums_tensors(cornell):
    telemetry.count("test.kept", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        telemetry.add("test.sum", torch.tensor(5))
        telemetry.add("test.sum", torch.tensor(7))
        telemetry.add("test.sum", 2)
        telemetry.add("test.float", torch.tensor(0.5))
    telemetry.add("test.sum", 100)                        # not traced
    snap = telemetry.snapshot()
    assert snap["counters"] == {"test.sum": 14, "test.float": 0.5}
    assert isinstance(snap["counters"]["test.sum"], int)
    telemetry.reset()
    assert telemetry.snapshot() == dict(spans={}, counters={}, units=0)
    assert telemetry.counter("test.kept") >= 3
