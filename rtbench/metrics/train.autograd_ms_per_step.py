"""Host time a traced whole training step spends in its backward sweep, in
ms: the program's `train.autograd` spans (`torch.autograd.grad` over the
pool, K2 and the glue's adjoints) summed, over the steps.  None where the
program has no such span, or its traced steps are not the window's."""


def read(ctx):
    try:
        from scheme_raytrace_torch.utils import telemetry
    except ImportError:
        return None
    snap = telemetry.snapshot()
    grad = snap["spans"].get("train.autograd")
    if not ctx["step"] or snap["units"] != ctx["units"] or not grad:
        return None
    return 1e3 * grad["total_s"] / ctx["units"]
