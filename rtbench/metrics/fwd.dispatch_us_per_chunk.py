"""Host time of one persistent-pool chunk (CHUNK_T iterations in one
launch, its flush and its drain check) in the traced whole frames, in us:
the mean duration of the program's `pool.chunk` spans (its telemetry).
None where the program has no such span, or its traced frames are not the
window's."""


def read(ctx):
    try:
        from scheme_raytrace_torch.utils import telemetry
    except ImportError:
        return None
    snap = telemetry.snapshot()
    chunk = snap["spans"].get("pool.chunk")
    if ctx["step"] or snap["units"] != ctx["units"] or not chunk:
        return None
    return 1e6 * chunk["total_s"] / chunk["n"]
