"""How full the forward pool ran in the traced whole frames, in %: the
program's counters `pool.segments` (path segments traced) over
`pool.lane_slots` (iterations times lanes).  None where the program has
no such counter, or its traced frames are not the window's."""


def read(ctx):
    try:
        from scheme_raytrace_torch.utils import telemetry
    except ImportError:
        return None
    snap = telemetry.snapshot()
    c = snap["counters"]
    if ctx["step"] or snap["units"] != ctx["units"] \
            or not c.get("pool.lane_slots"):
        return None
    return 100.0 * c["pool.segments"] / c["pool.lane_slots"]
