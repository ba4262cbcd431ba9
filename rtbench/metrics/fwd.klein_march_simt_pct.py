"""How full the warps ran the klein march in the traced whole frames, in
%: the program's counters `klein.steps` (the marches' DE evaluations on
live lanes) over `klein.warp_steps` (for each warp and pool iteration, 32
times the most steps any of its lanes took: the warp's step slots, busy or
idle).  What compacting the marching lanes would raise.  None where the
program has no such counter (the CPU's plain step, a program that does not
count them), or its traced frames are not the window's."""


def read(ctx):
    try:
        from scheme_raytrace_torch.utils import telemetry
    except ImportError:
        return None
    snap = telemetry.snapshot()
    c = snap["counters"]
    if ctx["step"] or snap["units"] != ctx["units"] \
            or not c.get("klein.warp_steps") or "klein.steps" not in c:
        return None
    return 100.0 * c["klein.steps"] / c["klein.warp_steps"]
