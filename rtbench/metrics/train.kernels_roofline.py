"""A training step's kernels against their roofline, in %: the least time
the traced steps' work needs (the forward and its adjoint,
rtbench/roofline.py, from their exact forward segments) over the device
time of every kernel in those steps, summed over the ranks."""

from rtbench import roofline


def read(ctx):
    kernel_s = sum(r["kernel_s"] for r in ctx["ranks"])
    if not ctx["step"] or kernel_s <= 0 or ctx["segments"] <= 0:
        return None
    ops, n_bytes = roofline.work(ctx["segments"], ctx["paths"],
                                 ctx["n_pixels"], ctx["scene"], step=True)
    return 100.0 * roofline.least_seconds(ops, n_bytes) / kernel_s
