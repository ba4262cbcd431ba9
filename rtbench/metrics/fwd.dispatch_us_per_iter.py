"""Host time of the traced whole frames' pool a bounce iteration, in us,
whichever pool runs the frame: the program's `pool` spans (each pool call
whole, its set-up included) summed, over the iterations they ran: one a
`pool.iter` span of the FIFO pool, CHUNK_T a `pool.chunk` span of the
persistent pool (one launch of CHUNK_T iterations).  None where the
program has no such span, or its traced frames are not the window's."""


def read(ctx):
    try:
        from scheme_raytrace_torch.integrator.persist import CHUNK_T
        from scheme_raytrace_torch.utils import telemetry
    except ImportError:
        return None
    snap = telemetry.snapshot()
    spans = snap["spans"]
    pool = spans.get("pool")
    iters = (spans.get("pool.iter", {}).get("n", 0)
             + CHUNK_T * spans.get("pool.chunk", {}).get("n", 0))
    if ctx["step"] or snap["units"] != ctx["units"] or not pool or not iters:
        return None
    return 1e6 * pool["total_s"] / iters
