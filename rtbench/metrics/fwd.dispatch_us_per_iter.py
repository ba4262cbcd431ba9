"""Host time of one pool iteration in the traced whole frames, in us: the
mean duration of the program's `pool.iter` spans (its telemetry).  None
where the program has no such span, or its traced frames are not the
window's."""


def read(ctx):
    try:
        from scheme_raytrace_torch.utils import telemetry
    except ImportError:
        return None
    snap = telemetry.snapshot()
    it = snap["spans"].get("pool.iter")
    if ctx["step"] or snap["units"] != ctx["units"] or not it:
        return None
    return 1e6 * it["total_s"] / it["n"]
