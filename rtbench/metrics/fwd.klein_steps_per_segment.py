"""The klein march's distance-estimate steps a path segment in the traced
whole frames: the program's counters `klein.steps` (the DE evaluations of
the marches on live lanes) over `pool.segments` (path segments traced).
A change that marches less shows here; `correct` decides whether it was
allowed to.  None where the program has no such counter (a scene without
kleins, or a program that does not count them), or its traced frames are
not the window's."""


def read(ctx):
    try:
        from scheme_raytrace_torch.utils import telemetry
    except ImportError:
        return None
    snap = telemetry.snapshot()
    c = snap["counters"]
    if ctx["step"] or snap["units"] != ctx["units"] \
            or "klein.steps" not in c or not c.get("pool.segments"):
        return None
    return c["klein.steps"] / c["pool.segments"]
