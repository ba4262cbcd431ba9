"""PyTorch port: the tile of threads a lane in K3 and K4, on the CPU.

The packed-state kernel (K3, csrc/bounce_packed.cu) and the persistent
chunk (K4, csrc/bounce_persist.cu) carry each lane on a tile of w threads
(w = 1, 2, 4 or 8), as K1 does: the closest-hit sweeps split over the tile
and every w gives w = 1's state bit for bit (the card holds that:
chip_smoke.py's kernel-tile phase, tests/test_torch_cuda.py).  K4 counts
each iteration's live lanes with a ballot a warp into a block's row of
counters in shared memory, with no block barrier inside its loop.  Here,
without a card, nothing compiled and no kernel run:

  * `bounce.tile_width` (K3's width) and `persist.tile_width` (K4's) for
    every scene of `scenes.SCENES`;
  * K3's and K4's launch (lane_blocks) at every w, on ragged m;
  * K4's shared memory for the chunk lengths chip_smoke.py times;
  * the wave arithmetic behind K4's width rule, from registers figures;
  * the wrappers refusing a width the kernels do not take before any other
    check or launch;
  * a numpy model of K4's per-warp segment count, held against the count
    of live lanes of each iteration: the written spec of the count.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import pathlib
import re

import numpy as np
import pytest
import torch

import chip_smoke
from scheme_raytrace_torch import scenes
from scheme_raytrace_torch.config import RenderConfig
from scheme_raytrace_torch.integrator import bounce, persist
from scheme_raytrace_torch.scene import compile_scene

CSRC = pathlib.Path(bounce.__file__).resolve().parent.parent / "csrc"


def _plan(name):
    spec = scenes.SCENES[name]()
    scene = compile_scene(spec.objects, sky=spec.sky, lights=spec.lights,
                          device="cpu")
    return scene, spec, bounce.pool_plan(scene, RenderConfig(nx=8, ny=8,
                                                             spp=1))


# --- the widths ---------------------------------------------------------------

# scene -> (K3's, K4's) width on its plan: the H100's sweep (PERF.md)
PACKED_WIDTH = {"three_spheres": (1, 1), "textured": (1, 1), "test": (1, 1),
                "grid": (2, 2), "bezier": (4, 4), "simple_light": (1, 1),
                "cornell": (2, 2), "cornell_bezier": (4, 4),
                "cornell_smoke": (1, 1), "klein": (1, 1),
                "cornell_klein": (1, 1), "random": (2, 2),
                "points_chain": (4, 4)}


@pytest.mark.parametrize("name", sorted(scenes.SCENES))
def test_packed_tile_width_of_every_scene(name):
    _, _, plan = _plan(name)
    got = (bounce.tile_width(plan), persist.tile_width(plan))
    assert all(w in bounce.TILE_WIDTHS for w in got)
    assert got == PACKED_WIDTH[name]


# --- the launch ---------------------------------------------------------------

@pytest.mark.parametrize("w", [1, 2, 4, 8])
def test_packed_block_count(w):
    # K3 and K4 launch lane_blocks(m, w) blocks of kThreads, a lane on the
    # tile of w threads i * w, ..., i * w + w - 1; the whole tile past m
    # takes no lane
    for src in ("bounce_packed.cu", "bounce_persist.cu"):
        text = (CSRC / src).read_text()
        assert re.search(r"<<<lane_blocks\(m, w\), kThreads", text), src
        assert ("(blockIdx.x * blockDim.x + threadIdx.x) / prm.w" in text), src
    for m in (1, 31, 255, 256, 257, 24 * 1024, 64 * 1024, 64 * 1024 + 31):
        blocks = bounce.kernel_blocks(m, w)
        # every lane has its tile, and no block is spare
        assert (blocks - 1) * bounce.THREADS < m * w <= blocks * bounce.THREADS
        lanes = np.arange(blocks * bounce.THREADS) // w
        assert np.array_equal(np.bincount(lanes[lanes < m]), np.full(m, w))


@pytest.mark.parametrize("T", chip_smoke.CHUNK_TS)
def test_persist_shared_bytes(T):
    # a block's row of T int32 counters, passed as the launch's dynamic
    # shared memory (T * 4 bytes), which every thread of the block zeroes
    # and reads T at a time; far under the 48 KB a block takes without
    # opting in
    text = (CSRC / "bounce_persist.cu").read_text()
    assert "kThreads, T * sizeof(int32_t)," in text
    assert "extern __shared__ int32_t live[];" in text
    assert text.count("for (int t = threadIdx.x; t < prm.T; t += blockDim.x)"
                      ) == 2
    assert 4 * T <= 48 * 1024


# registers a thread -> blocks of 256 an H100 SM keeps resident: 65,536
# registers, allocated to a warp in units of 256, at most 2,048 threads
RESIDENT = {32: 8, 40: 6, 48: 5, 56: 4, 64: 4, 72: 3, 80: 3, 96: 2, 128: 2,
            168: 1, 255: 1}


@pytest.mark.parametrize("registers", sorted(RESIDENT))
def test_resident_blocks(registers):
    assert bounce.resident_blocks(registers) == RESIDENT[registers]


@pytest.mark.parametrize("registers,w,waves", [
    (48, 1, 1), (48, 2, 1), (48, 4, 2), (48, 8, 4),
    (64, 2, 1), (64, 4, 2), (80, 1, 1), (80, 2, 2)])
def test_launch_waves(registers, w, waves):
    # the forward pool's 65,536 lanes: 256 w blocks over 132 SMs
    m = chip_smoke.M
    assert bounce.launch_waves(m, w, registers) == waves
    resident = bounce.resident_blocks(registers) * bounce.SMS
    assert (waves - 1) * resident < bounce.kernel_blocks(m, w) <= (
        waves * resident)


# scene -> (K4's registers as ptxas counted them on the H100, its waves at
# the chosen width): the width rule keeps one wave but for the ribbons,
# whose three waves won the sweep (PERF.md)
K4_WAVES = {"cornell": (48, 1), "random": (60, 1), "textured": (64, 1),
            "cornell_smoke": (58, 1), "bezier": (80, 3),
            "cornell_bezier": (80, 3), "klein": (80, 1),
            "cornell_klein": (80, 1)}


@pytest.mark.parametrize("name", sorted(K4_WAVES))
def test_k4_width_waves(name):
    registers, waves = K4_WAVES[name]
    _, _, plan = _plan(name)
    w = persist.tile_width(plan)
    assert bounce.launch_waves(chip_smoke.M, w, registers) == waves
    if waves > 1:
        assert plan.n_beziers and w == 4


# --- refusing a width ---------------------------------------------------------

def _packed_args():
    scene, spec, _ = _plan("cornell")
    cfg = RenderConfig(nx=8, ny=8, spp=1, light_sampling=True)
    plan = bounce.pool_plan(scene, cfg)
    pk = bounce.pack(scene, spec.camera(aspect=1.0, device="cpu"), plan,
                     torch.float32)
    m = 64
    q = dict(m=m, n_work=cfg.n_pixels, n_pix=cfg.n_pixels, pix0=0,
             total_pix=cfg.n_pixels)
    return plan, pk, bounce.initial_packed_state(m, "cpu"), q


CALLS = {"step_packed_cuda": lambda plan, pk, st, q, tile: (
             bounce.step_packed_cuda(plan, pk, 0, st, **q, tile=tile)),
         "chunk_cuda": lambda plan, pk, st, q, tile: (
             persist.chunk_cuda(plan, pk, 0, st, **q, T=2, tile=tile))}


@pytest.mark.parametrize("tile", [0, 3, 16])
@pytest.mark.parametrize("fn", sorted(CALLS))
def test_packed_wrappers_refuse_a_tile_width_first(fn, tile):
    # the width is checked before the device (these tensors lie on the CPU)
    # and before anything is allocated or launched
    plan, pk, st, q = _packed_args()
    before = (bounce.PACKED_LAUNCHES, persist.PERSIST_LAUNCHES)
    with pytest.raises(ValueError, match="tile width"):
        CALLS[fn](plan, pk, st, q, tile)
    assert (bounce.PACKED_LAUNCHES, persist.PERSIST_LAUNCHES) == before


@pytest.mark.parametrize("fn", sorted(CALLS))
def test_packed_wrappers_take_a_valid_width_to_the_device_check(fn):
    plan, pk, st, q = _packed_args()
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        CALLS[fn](plan, pk, st, q, 2)


# --- the numpy model of K4's segment count ------------------------------------
# A thread t of a block of THREADS carries lane t // w (global thread index)
# and is its tile's first thread where t % w == 0.  Each iteration every
# warp takes a ballot of (first thread and alive), threads past m voting
# false, and its lane 0 adds the ballot's popcount into the block's counter
# of that iteration; after the loop the blocks add their counters into seg,
# in any order.

def _ballot(votes):
    """__ballot_sync over a warp: 32 votes -> a 32-bit mask."""
    return int(sum(int(v) << k for k, v in enumerate(votes)))


def warp_counts(items, n_work, m, w, threads=bounce.THREADS):
    """One iteration's live lanes as K4 counts them: {block: count}."""
    blocks = bounce.kernel_blocks(m, w)
    tid = np.arange(blocks * threads)
    lane = tid // w
    first = (lane < m) & (tid % w == 0)
    alive = np.zeros(tid.shape, bool)
    alive[lane < m] = items[lane[lane < m]] < n_work
    votes = (first & alive).reshape(blocks, threads // 32, 32)
    return {b: sum(bin(_ballot(warp)).count("1") for warp in votes[b])
            for b in range(blocks)}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("w", [1, 2, 4, 8])
def test_segment_count_model(w, seed):
    r = np.random.default_rng(seed)
    m = 1000 + int(r.integers(0, 100))        # ragged: the last block is part
    n_work = 3 * m + int(r.integers(0, m))
    T = 12
    items = r.integers(0, n_work + n_work // 10, m)
    seg = np.zeros(T, np.int64)
    for t in range(T):
        counts = warp_counts(items, n_work, m, w)
        order = r.permutation(len(counts))     # the blocks' atomics, any order
        for b in order:
            seg[t] += counts[b]
        assert seg[t] == int((items < n_work).sum())
        # the strided re-issue: a lane whose path ends takes the item m on
        done = (items < n_work) & (r.random(m) < 0.4)
        items = np.where(done, items + m, items)
    assert seg[-1] < seg[0]
