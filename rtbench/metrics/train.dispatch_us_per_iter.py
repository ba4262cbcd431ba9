"""Host time of one iteration of the reverse pool's forward half in the
traced whole steps, in us: the mean duration of the program's `pool.iter`
spans (its telemetry).  None where the program has no such span, or its
traced steps are not the window's."""


def read(ctx):
    try:
        from scheme_raytrace_torch.utils import telemetry
    except ImportError:
        return None
    snap = telemetry.snapshot()
    it = snap["spans"].get("pool.iter")
    if not ctx["step"] or snap["units"] != ctx["units"] or not it:
        return None
    return 1e6 * it["total_s"] / it["n"]
