"""Host time a traced whole frame spends in the pool's drain checks, in
ms: the program's `pool.drain_check` spans (`bool(alive.any())`, a host
sync that waits for the card) summed, over the frames.  None where the
program has no such span, or its traced frames are not the window's."""


def read(ctx):
    try:
        from scheme_raytrace_torch.utils import telemetry
    except ImportError:
        return None
    snap = telemetry.snapshot()
    drain = snap["spans"].get("pool.drain_check")
    if ctx["step"] or snap["units"] != ctx["units"] or not drain:
        return None
    return 1e3 * drain["total_s"] / ctx["units"]
