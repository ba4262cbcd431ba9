"""Device kernel launches a frame: the kernels the profiler saw in the
traced whole frames, over the frames; a mean over the ranks."""


def read(ctx):
    if ctx["step"] or not sum(r["kernels"] for r in ctx["ranks"]):
        return None
    return sum(r["kernels"] for r in ctx["ranks"]) / len(ctx["ranks"]) \
        / ctx["units"]
