"""Device kernel launches a training step: the kernels the profiler saw in
the traced whole steps, over the steps; a mean over the ranks."""


def read(ctx):
    if not ctx["step"] or not sum(r["kernels"] for r in ctx["ranks"]):
        return None
    return sum(r["kernels"] for r in ctx["ranks"]) / len(ctx["ranks"]) \
        / ctx["units"]
