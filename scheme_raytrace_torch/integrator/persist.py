"""Persistent-state pool: CHUNK_T bounce iterations per launch
(scheme_raytrace_tpu/integrator/persist.py).

The strided pool (integrator/pool_strided.py) with its loop, queue and
state moved into the kernel: one launch of the persistent kernel (K4,
`chunk_cuda`, csrc/bounce_persist.cu, on the card; the plain `chunk_plain`
on the CPU) runs T iterations over the packed state (bounce.py N_PACKED
layout), each lane on a tile of `tile_width(plan)` threads with its state
in registers, and
returns the new state, one flush row per iteration ([T, 4, m] float32: the
finished path's pixel as int32 bits, -1 for none, then its radiance, 0
there) and the live lanes of each iteration (the segments).  The host adds
the flush rows into the framebuffer (pool_strided.Framebuffer: ordered,
race-free, bitwise reproducible) and checks the drain once per chunk.

float32 only, as the reference.  Returns (raw, segments, iters), where
iters counts T per chunk, as the reference does.  `pool.render_pool_auto`
routes the card's float32 forward frames here.

While a torch profiler records, the pool is traced (utils/telemetry) as
the FIFO pool is: the span `pool` around a call, `pool.chunk` around a
chunk, inside it `pool.launch` around the chunk's launch, `pool.flush`
around the framebuffer adds (one span a FLUSH_SPAN_ROWS rows, each short
enough for a trace's idle gaps to be named after it) and the segment sum,
and `pool.drain_check` around the host sync; the counters `pool.segments`
and `pool.lane_slots` (iterations times lanes) give the pool's occupancy.
With kleins, the marches' work adds to the counters bounce.KLEIN_COUNTERS
and, on the card, KLEIN_WARP_STEPS: K4 adds them into a buffer of the
frame's (allocated only while a profiler records, a null pointer
otherwise), handed to the telemetry as 0-d tensors with no host sync;
`chunk_plain` counts them in `bounce.step`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..utils import telemetry
from . import bounce, pool_fused
from .pool_strided import Framebuffer, pool_size

CHUNK_T = 32      # bounce iterations per launch (the reference's value)
N_STATE = bounce.N_PACKED   # packed state rows: item, fresh, depth, o, d,
                            # time, rad, tp
ITEM_LIMIT = 2**31 - 1      # the kernel's work items are int32
# Flush rows a `pool.flush` span holds where each row is one add (g = m):
# on the card a row is about 25 host events, and rtbench/trace.py names an
# idle gap after a span only within 64 host events of its start.
FLUSH_SPAN_ROWS = 2
# K4's fourth klein counter: for each warp and iteration, 32 times the most
# march steps any lane of the warp took (the warp's step slots); with
# `klein.steps`, the share of the slots that do a lane's work.
KLEIN_WARP_STEPS = "klein.warp_steps"

def chunk_plain(plan, pk, sample_base, state, m, n_work, n_pix, pix0,
                total_pix, T=CHUNK_T):
    """T strided-pool iterations on the packed state in plain PyTorch (T
    `bounce.step_packed` calls): what the JAX persistent kernel computes
    (persist.py:46-111).  Returns (state, flush [T, 4, m] float32 with the
    pixel's int32 bits in row 0, segs [T] int32)."""
    flush = torch.empty(T, 4, m, dtype=torch.float32, device=state.device)
    segs = torch.empty(T, dtype=torch.int32, device=state.device)
    for t in range(T):
        item = state.view(torch.int32)[0]
        segs[t] = (item < n_work).sum()
        state = bounce.step_packed(plan, pk, sample_base, state, m, n_work,
                                   n_pix, pix0, total_pix)
        done = state[1] != 0.0
        flush.view(torch.int32)[t, 0] = torch.where(
            done, torch.fmod(item, n_pix), -1)
        flush[t, 1:] = torch.where(done, state[10:13], 0.0)
    return state, flush, segs


def tile_width(plan) -> int:
    """Threads a lane of the persistent kernel (K4) for this plan: the width
    of the tile over which each iteration's closest-hit sweeps split
    (csrc/bounce_common.cuh Tile).  Every width gives the same chunk bit for
    bit.  The rule is the fastest of the widths 1, 2, 4 and 8 that the H100
    measured (chip_smoke.py's kernel-tile phase, PERF.md), which is K1's and
    K3's (`bounce.tile_width`): 2 for a sweep of bounce.TILE_SWEEP_MIN or
    more rects and spheres (one wave: 512 blocks, 4-5 resident an SM at
    48-60 registers), 1 for a shorter sweep and with a klein, whose march a
    tile only repeats, and 4 for the bezier probe's seeds, although at 80
    registers (3 blocks an SM) its 1,024 blocks take three waves
    (bounce.launch_waves): a block holds its SM for all T iterations, but
    the split seeds win 9% and 6% over w = 2 on `bezier` and
    `cornell_bezier`."""
    return bounce.tile_width(plan)


def _kernel(plan):
    """The plan's variant of the bounce_persist library, built at first use;
    argtypes declared."""
    from ..utils import cuda_build
    lib = cuda_build.load("bounce_persist", bounce.kernel_features(plan))
    fn = lib.srt_bounce_persist
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_int] * 7
                       + bounce.SCENE_ARGTYPES + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def chunk_cuda(plan, pk, sample_base, state, m, n_work, n_pix, pix0,
               total_pix, T=CHUNK_T, tile=None, counts=None):
    """`chunk_plain` through the CUDA kernel csrc/bounce_persist.cu (the
    port of the Pallas persistent kernel `_make_call`): one launch for T
    iterations, bitwise equal to T launches of `bounce.step_packed_cuda`.
    `tile` is the threads a lane (bounce.TILE_WIDTHS), `tile_width(plan)`
    when None; every width gives the same chunk bit for bit.

    Takes what `bounce.step_packed_cuda` takes, on one CUDA device, and
    T >= 1.  `counts`, a [4] int64 tensor on the state's device, or None:
    with kleins in the plan the kernel adds into it the chunk's klein
    marches, their steps, the marches at the step cap (bounce.KLEIN_COUNTERS)
    and the warps' step slots (KLEIN_WARP_STEPS); with None it counts
    nothing.  Returns (state, flush, segs) as new tensors; launches on the
    current stream without synchronising and raises if the launch is
    refused; a launch adds one to the process counter `launches.K4`
    (utils/telemetry)."""
    fn = "chunk_cuda"
    w = bounce.check_tile(tile_width(plan) if tile is None else tile)
    pk, atlas, sb = bounce.check_packed(fn, plan, pk, sample_base, state, m)
    if T < 1:
        raise ValueError(f"{fn}: T must be at least 1, got {T}")
    dev = state.device
    if counts is not None and (counts.dtype != torch.int64
                               or counts.shape != (4,)
                               or counts.device != dev
                               or not counts.is_contiguous()):
        raise ValueError(f"{fn}: counts must be a contiguous [4] int64 "
                         f"tensor on {dev}, got {tuple(counts.shape)} "
                         f"{counts.dtype} on {counts.device}")
    out = torch.empty_like(state)
    flush = torch.empty(T, 4, m, dtype=torch.float32, device=dev)
    segs = torch.zeros(T, dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_void_p * 8)(pk.data_ptr(), sb.data_ptr(),
                                 state.data_ptr(), out.data_ptr(),
                                 flush.data_ptr(), segs.data_ptr(),
                                 bounce.tensor_ptr(atlas),
                                 bounce.tensor_ptr(counts))
    kernel = _kernel(plan)
    with torch.cuda.device(dev):
        err = kernel(ptrs, T, w, *bounce.queue_args(plan, m, n_work, n_pix,
                                                    pix0, total_pix),
                     torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"bounce_persist kernel launch failed: CUDA error "
                           f"{err}")
    telemetry.count("launches.K4")
    return out, flush, segs


def render_pool_persistent(scene, cam, config, raw0, sample_base, pix0=0,
                           total_pix=None):
    """Trace config.spp passes over raw0's pixels ([n_pix, 3] float32
    radiance sums, the frame or a row band starting at frame pixel pix0)
    in chunks of CHUNK_T iterations; return (raw, segments, iters)."""
    if raw0.dtype != torch.float32:
        raise TypeError("the persistent pool stores its state as float32; "
                        f"raw0 is {raw0.dtype}")
    with telemetry.span("pool"):
        return _render(scene, cam, config, raw0, sample_base, pix0,
                       total_pix)


def _render(scene, cam, config, raw0, sample_base, pix0, total_pix):
    n_pix = raw0.shape[0]
    total_pix = config.n_pixels if total_pix is None else total_pix
    n_work = n_pix * config.spp
    m = pool_size(config, n_work)
    T = CHUNK_T
    dev = raw0.device
    chunk = chunk_cuda if dev.type == "cuda" else chunk_plain
    pool_fused.LAST_STEP_IMPL["forward"] = (
        "persistent" if chunk is chunk_cuda else "plain")
    plan = bounce.pool_plan(scene, config)
    counts = None
    if chunk is chunk_cuda and plan.n_kleins and telemetry.tracing():
        counts = torch.zeros(4, dtype=torch.int64, device=dev)
        chunk = functools.partial(chunk_cuda, counts=counts)
    pk = bounce.pack(scene, cam, plan, torch.float32)
    sb = torch.as_tensor(sample_base, device=dev).to(torch.int32).reshape(1)

    state = bounce.initial_packed_state(m, dev)
    fb = Framebuffer(raw0, m, config.spp)
    # rows a `pool.flush` span holds: one add a row where g = gcd(m, n_pix)
    # = m, else the chunk's ranked rounds (pool_strided.Framebuffer)
    span_rows = FLUSH_SPAN_ROWS if math.gcd(m, n_pix) == m else T
    segments = torch.zeros((), dtype=torch.int64, device=dev)
    iters = 0
    drained = False
    while not drained:
        with telemetry.span("pool.chunk"):
            with telemetry.span("pool.launch"):
                state, flush, segs = chunk(plan, pk, sb, state, m, n_work,
                                           n_pix, pix0, total_pix, T)
            segments = _flush(fb, flush, segments, segs, span_rows)
            iters += T
            with telemetry.span("pool.drain_check"):
                drained = not bool((state.view(torch.int32)[0]
                                    < n_work).any())
    telemetry.add("pool.segments", segments)
    telemetry.add("pool.lane_slots", iters * m)
    if counts is not None:
        for name, n in zip(bounce.KLEIN_COUNTERS + (KLEIN_WARP_STEPS,),
                           counts.unbind()):
            telemetry.add(name, n)
    return fb.image(), segments, iters


def _flush(fb, flush, segments, segs, span_rows):
    """Add a chunk's flush rows into the framebuffer in order, a traced
    `pool.flush` span over each `span_rows` of them, and its live lanes
    into the segment count (in the first span); returns the new count."""
    pix, vals = flush[:, 0].view(torch.int32), flush[:, 1:]
    for r in range(0, pix.shape[0], span_rows):
        with telemetry.span("pool.flush"):
            if r == 0:
                segments = segments + segs.sum()
            fb.add(pix[r:r + span_rows], vals[r:r + span_rows])
    return segments
