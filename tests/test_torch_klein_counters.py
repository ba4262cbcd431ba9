"""PyTorch port: the klein march's traced counters on the CPU
(bounce.KLEIN_COUNTERS: `klein.marches`, `klein.steps`, `klein.capped`).

The benchmark's `cornell_klein` configuration (rtbench/configs/), at 16x16
and one pass a pixel, in float64, where the port's paths are the plain
reference's (rtbench/reference/) exactly:

  * while the profiler's gate is open, the forward pool's counters are
    what the plain march (`bounce._klein_march`) counts when it is run
    again on the live lanes alone, as the kernels march them (dead lanes
    march in the plain step, and do not count);
  * they are the plain march's count on the reference's own rays: every
    march the reference makes, the port makes, and as many reach the cap.
    The steps agree to rounding: a ray scattered off the fractal leaves
    along a normal that the reference takes from autograd and the port
    from its own tangents, apart in the last bits, and a march from inside
    the DE < 0.001 band counts its steps from there (four seeds read
    4.3e-4 to 1.3e-3).  The reference's own step count is another number,
    by design: it retires a lane on an accept, or receding outside the
    ball of radius 726, and marches on past the closest hit so far and
    from inside the solid, where the port also retires a lane past t_max
    or backward-stuck, and stops a receding one only outside radius 900
    (23,296 steps against the port's 16,651 on 1,001 segments, one seed).
    Both cull by the same ball test, so the marches agree;
  * with the gate shut, nothing is counted and the frame is bitwise the
    counted one;
  * the persistent pool's plain chunks (float32) count what the FIFO pool
    counts on the same frame.

K4's own counting, and `klein.warp_steps`, are held on the card
(tests/test_torch_cuda.py); a traced run of the benchmark's cell reads the
counters under a real profiler (tests/test_torch_telemetry.py).  Here the
gate is forced open, as tests/test_torch_telemetry.py does for another
thread: the profiler's own cost on the plain march's many small
operations would be most of the time.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import copy

import pytest
import torch

from rtbench import check, program, reference, run
from rtbench.reference import tracer
from scheme_raytrace_torch.integrator import bounce, persist
from scheme_raytrace_torch.utils import telemetry

CPU = torch.device("cpu")
NX = NY = 16
SPP = 1
SEED = 2 ** 31 + 101
KEYS = ("marching", "steps", "capped")


def _config(dtype):
    c = copy.deepcopy(run.load("configs", "cornell_klein"))
    c["render"] = dict(c["render"], dtype=dtype)
    return c


def _stats():
    return dict(marching=0, steps=0, inversions=0, stuck=0, capped=0)


def _counters(snap):
    return {k: snap["counters"].get(n, 0)
            for k, n in zip(KEYS, bounce.KLEIN_COUNTERS)}


@pytest.fixture(scope="module")
def f64_frames():
    """The first frame of the configuration in float64: untraced, then
    counted (the gate open) with the plain march run again on the live
    lanes alone, then the reference's, with the port's march counted on
    its rays."""
    c = _config("f64")
    seed = SEED & 0xFFFFFFFF
    scene, cam, config = program.build(c, NX, NY, SPP, seed, CPU)
    st0 = program.zero_state(config, CPU)
    telemetry.reset()
    mp = pytest.MonkeyPatch()
    try:
        untraced, _ = program.frame(scene, cam, config, st0)
        untraced_snap = telemetry.snapshot()

        alive = []
        live_count = _stats()
        step, march = bounce.step, bounce._klein_march

        def step_seen(plan, pk, gitem, px, py, fresh, alive_, *a):
            alive[:] = [alive_]
            return step(plan, pk, gitem, px, py, fresh, alive_, *a)

        def march_seen(c_, o, d, t_min, t_max, stats=None):
            live = alive[0].nonzero()[:, 0]
            march(c_, tuple(x[live] for x in o), tuple(x[live] for x in d),
                  t_min, t_max[live], live_count)
            return march(c_, o, d, t_min, t_max, stats)

        mp.setattr(bounce, "step", step_seen)
        mp.setattr(bounce, "_klein_march", march_seen)
        mp.setattr(telemetry, "_tracing", lambda: True)
        traced, seg = program.frame(scene, cam, config, st0)
        snap = telemetry.snapshot()
        mp.undo()

        ref_count, on_ref_rays = _stats(), _stats()
        ref_march = tracer.klein_march

        def ref_seen(c_, o, d, t_max, work):
            march(tuple(c_), tuple(o), tuple(d), tracer.T_MIN, t_max,
                  on_ref_rays)
            return ref_march(c_, o, d, t_max, _Steps(work, ref_count))

        mp.setattr(tracer, "klein_march", ref_seen)
        work = dict(steps=0, inversions=0, hits=0)
        ref, ref_seg = reference.render_frame(c, NX, NY, SPP, seed,
                                              dtype=torch.float64, work=work)
    finally:
        mp.undo()
        telemetry.reset()
    return dict(untraced=untraced, untraced_snap=untraced_snap,
                traced=traced, seg=int(seg), snap=snap, live=live_count,
                ref=ref, ref_seg=ref_seg, work=work, ref_count=ref_count,
                on_ref_rays=on_ref_rays, before=st0)


class _Steps(dict):
    """The reference's work dict, passed through, that also counts the
    lanes that enter the march: its first step's lanes, in `seen`."""

    def __init__(self, work, seen):
        super().__init__(work)
        self.work, self.seen, self.first = work, seen, True

    def __setitem__(self, key, value):
        if key == "steps" and self.first:
            self.seen["marching"] += value - self[key]
            self.first = False
        self.work[key] = value
        super().__setitem__(key, value)


def test_traced_counters_are_the_live_lanes_march(f64_frames):
    got = _counters(f64_frames["snap"])
    want = {k: f64_frames["live"][k] for k in KEYS}
    assert got == want
    # every live segment in the box lies inside the march's precull ball
    assert got["marching"] == f64_frames["seg"] > 0
    assert got["marching"] < got["steps"]


def test_counters_match_the_reference_frame(f64_frames):
    nums = check.frame_numbers(f64_frames["before"].raw_sum,
                               f64_frames["traced"].raw_sum,
                               f64_frames["seg"], f64_frames["ref"],
                               f64_frames["ref_seg"])
    assert nums["seg_gap"] == 0.0 and nums["img_gap"] < 1e-12, nums
    got = _counters(f64_frames["snap"])
    on_ref = f64_frames["on_ref_rays"]
    assert got["marching"] == on_ref["marching"] \
        == f64_frames["ref_count"]["marching"]
    assert got["capped"] == on_ref["capped"]
    assert abs(got["steps"] - on_ref["steps"]) <= 5e-3 * on_ref["steps"]
    # the reference's own count: its retirements, not the port's
    assert f64_frames["work"]["steps"] > 0
    assert f64_frames["work"]["steps"] != got["steps"]


def test_untraced_frame_counts_nothing_and_is_unchanged(f64_frames):
    assert f64_frames["untraced_snap"] == dict(spans={}, counters={},
                                               units=0)
    assert torch.equal(f64_frames["untraced"].raw_sum,
                       f64_frames["traced"].raw_sum)
    assert torch.equal(f64_frames["untraced"].sample_count,
                       f64_frames["traced"].sample_count)


def test_persistent_plain_chunks_count_as_the_fifo_pool(monkeypatch):
    c = _config("f32")
    scene, cam, config = program.build(c, 8, 8, SPP, SEED & 0xFFFFFFFF, CPU)
    telemetry.reset()
    monkeypatch.setattr(telemetry, "_tracing", lambda: True)
    try:
        _, seg_fifo = program.frame(scene, cam, config,
                                    program.zero_state(config, CPU))
        fifo = telemetry.snapshot()
        telemetry.reset()
        _, seg_k4, _ = persist.render_pool_persistent(
            scene, cam, config, torch.zeros(config.n_pixels, 3), 0)
        chunks = telemetry.snapshot()
    finally:
        telemetry.reset()
    assert int(seg_fifo) == int(seg_k4)
    assert _counters(fifo) == _counters(chunks)
    assert _counters(fifo)["steps"] > 0
    # the plain step counts no warp slots: they are K4's alone
    assert persist.KLEIN_WARP_STEPS not in chunks["counters"]
