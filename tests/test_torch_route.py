"""PyTorch port: the forward frame's route to the persistent pool, on the
CPU.

  * `pool.routes_to_persistent` sends a frame to the persistent pool (K4)
    for CUDA tensors in float32 whose (scene, config) `bounce.supported`
    covers, and keeps the FIFO pool (or the general pool) for the CPU,
    float64, russian roulette, BVH traversal, material sort and a queue
    whose work items overflow int32.  The device is a `torch.device`: no
    card is needed to ask.
  * `render_pool_auto` with the route forced runs the persistent pool
    (its plain chunk on the CPU), whole and in row bands, with the FIFO
    pool's exact segments; the traced counters `pool.calls` and
    `pool.calls.persistent` count its calls and the routed ones.
  * `calibrate_iters_sharded` keeps measuring the FIFO pool whatever the
    route: on a one-rank gloo mesh with every frame routed, its count is
    ceil(FIFO drain x slack), the count `render_pool_sharded` gave it
    before the route existed.
  * `render_pool_persistent` under torch.profiler records the spans
    `pool`, `pool.chunk`, `pool.launch`, `pool.flush` and
    `pool.drain_check` (on the profiler's timeline too), `pool.flush` once
    a FLUSH_SPAN_ROWS rows where each row is one add and once a chunk
    where the flush ranks its adds, and the counters `pool.segments` (the
    returned segments) and `pool.lane_slots` (iterations x lanes).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from scheme_raytrace_torch import scenes
from scheme_raytrace_torch.config import RenderConfig
from scheme_raytrace_torch.integrator import persist, pool, pool_fused
from scheme_raytrace_torch.integrator.pool_strided import pool_size
from scheme_raytrace_torch.parallel import distributed as pdist
from scheme_raytrace_torch.parallel.pool import render_pool_sharded
from scheme_raytrace_torch.parallel.render import calibrate_iters_sharded
from scheme_raytrace_torch.scene import compile_scene
from scheme_raytrace_torch.utils import telemetry

CUDA = torch.device("cuda")
CPU = torch.device("cpu")
CFG = RenderConfig(nx=16, ny=16, spp=2, max_depth=8, light_sampling=True)


def _scene(name="cornell", **kw):
    spec = scenes.SCENES[name]()
    scene = compile_scene(spec.objects, sky=spec.sky, device="cpu", **kw)
    return scene, spec.camera(aspect=1.0, device="cpu")


@pytest.fixture
def cornell():
    telemetry.reset()
    yield _scene()
    telemetry.reset()


@pytest.fixture
def routed(monkeypatch):
    """Every frame routed to the persistent pool, on the CPU too."""
    monkeypatch.setattr(pool, "routes_to_persistent", lambda *a: True)


@pytest.mark.parametrize("name", ["cornell", "random", "textured",
                                  "cornell_smoke", "bezier", "klein"])
def test_card_f32_supported_frames_route_to_the_persistent_pool(name):
    scene, _ = _scene(name)
    assert pool.routes_to_persistent(CUDA, torch.float32, scene, CFG)
    assert pool.routes_to_persistent(torch.device("cuda", 1), torch.float32,
                                     scene, CFG)


@pytest.mark.parametrize("case", ["cpu", "f64", "russian_roulette", "bvh",
                                  "material_sort", "int32_items"])
def test_other_frames_keep_the_fifo_or_general_pool(case):
    scene, _ = _scene()
    device, dtype, cfg = CUDA, torch.float32, CFG
    if case == "cpu":
        device = CPU
    elif case == "f64":
        dtype = torch.float64
    elif case == "bvh":
        cfg = cfg.replace(traversal="bvh")
    elif case == "int32_items":
        # 1024^2 pixels x 2,048 passes: items past 2**31 - 1
        cfg = cfg.replace(nx=1024, ny=1024, spp=2048)
    else:
        cfg = cfg.replace(**{case: True})
    assert not pool.routes_to_persistent(device, dtype, scene, cfg)


def test_the_largest_frame_int32_holds_routes():
    scene, _ = _scene()
    m = CFG.resolve_pool_rays()
    spp = (persist.ITEM_LIMIT - m) // (1024 * 1024)
    cfg = CFG.replace(nx=1024, ny=1024, spp=spp)
    assert pool.routes_to_persistent(CUDA, torch.float32, scene, cfg)
    assert not pool.routes_to_persistent(CUDA, torch.float32, scene,
                                         cfg.replace(spp=spp + 1))


@pytest.mark.parametrize("forced", [False, True], ids=["fifo", "persistent"])
def test_router_counts_its_calls_and_the_routed_ones(cornell, monkeypatch,
                                                     forced):
    scene, cam = cornell
    if forced:
        monkeypatch.setattr(pool, "routes_to_persistent", lambda *a: True)
    raw0 = torch.zeros(CFG.n_pixels, 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            raw, segs, iters = pool.render_pool_auto(scene, cam, CFG, raw0, 0)
    counters = telemetry.snapshot()["counters"]
    assert counters["pool.calls"] == 2
    assert counters.get("pool.calls.persistent", 0) == (2 if forced else 0)
    fn = (persist.render_pool_persistent if forced
          else pool_fused.render_pool_fused)
    want = fn(scene, cam, CFG, raw0, 0)
    assert torch.equal(raw, want[0]) and iters == want[2]
    assert pool_fused.LAST_STEP_IMPL["forward"] == "plain"


def test_routed_frame_is_the_persistent_pool(cornell, routed):
    scene, cam = cornell
    raw0 = torch.rand(CFG.n_pixels, 3)
    got = pool.render_pool_auto(scene, cam, CFG, raw0, 3)
    want = persist.render_pool_persistent(scene, cam, CFG, raw0, 3)
    fifo = pool_fused.render_pool_fused(scene, cam, CFG, raw0, 3)
    assert torch.equal(got[0], want[0]) and got[2] == want[2]
    assert int(got[1]) == int(want[1]) == int(fifo[1])
    torch.testing.assert_close(got[0], fifo[0], rtol=1e-5, atol=1e-5)


def test_routed_row_bands_render_the_fifo_pools_paths(cornell, routed,
                                                      monkeypatch):
    # four bands of 4 rows, each drained by the persistent pool with its
    # pix0 and the whole frame's total_pix
    scene, cam = cornell
    monkeypatch.setattr(pool, "BAND_PIX", 4 * CFG.nx)
    raw0 = torch.zeros(CFG.n_pixels, 3)
    with profile(activities=[ProfilerActivity.CPU]):
        raw, segs, iters = pool.render_pool_auto(scene, cam, CFG, raw0, 0)
    snap = telemetry.snapshot()
    assert snap["counters"]["pool.calls"] == 1
    assert snap["counters"]["pool.calls.persistent"] == 1
    assert snap["spans"]["pool"]["n"] == 4
    fifo = pool_fused.render_pool_fused(scene, cam, CFG, raw0, 0)
    assert int(segs) == int(fifo[1]) and iters % persist.CHUNK_T == 0
    torch.testing.assert_close(raw, fifo[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("slack", [1.25, 1.1])
def test_calibration_keeps_the_fifo_pools_count(cornell, monkeypatch, slack):
    scene, cam = cornell
    rev = CFG.replace(pool_rays=CFG.resolve_pool_rays(reverse=True))
    _, _, fifo_iters = pool_fused.render_pool_fused(
        scene, cam, rev, torch.zeros(CFG.n_pixels, 3), 0, pix0=0,
        total_pix=CFG.n_pixels)
    with pdist.single_process("cpu") as mesh:
        # what the calibration measured before the route: the sharded
        # frame's drain, through the FIFO pool
        monkeypatch.setattr(pool, "routes_to_persistent", lambda *a: False)
        before = render_pool_sharded(scene, cam, rev, mesh)[2]
        monkeypatch.setattr(pool, "routes_to_persistent", lambda *a: True)
        routed_iters = render_pool_sharded(scene, cam, rev, mesh)[2]
        got = calibrate_iters_sharded(scene, cam, CFG, mesh, slack=slack)
    assert before == fifo_iters
    assert routed_iters % persist.CHUNK_T == 0     # the sharded frame routes
    assert got == math.ceil(fifo_iters * slack) == int(-(-before * slack
                                                         // 1))


@pytest.mark.parametrize("spp", [1, 2], ids=["one-add-rows", "ranked"])
def test_persistent_pool_spans_and_counters(cornell, spp):
    scene, cam = cornell
    cfg = CFG.replace(spp=spp)
    raw0 = torch.zeros(cfg.n_pixels, 3)
    want = persist.render_pool_persistent(scene, cam, cfg, raw0, 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        raw, segs, iters = persist.render_pool_persistent(scene, cam, cfg,
                                                          raw0, 0)
    snap = telemetry.snapshot()
    assert torch.equal(raw, want[0]) and iters == want[2]
    chunks = iters // persist.CHUNK_T
    m = pool_size(cfg, cfg.n_pixels * spp)
    one_add_rows = math.gcd(m, cfg.n_pixels) == m      # g = m: no ranking
    assert one_add_rows == (spp == 1)
    flushes = chunks * (persist.CHUNK_T // persist.FLUSH_SPAN_ROWS
                        if one_add_rows else 1)
    spans = {k: v["n"] for k, v in snap["spans"].items()}
    assert spans == {"pool": 1, "pool.chunk": chunks, "pool.launch": chunks,
                     "pool.flush": flushes, "pool.drain_check": chunks}
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert set(spans) <= names
    assert snap["counters"] == {"pool.segments": int(segs),
                                "pool.lane_slots": iters * m}
    assert int(segs) == int(want[1]) > 0
    assert 0 < int(segs) <= iters * m
    for s in snap["spans"].values():
        assert 0.0 <= s["self_s"] <= s["total_s"] + 1e-9
