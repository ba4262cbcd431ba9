"""The frames' kernels against their roofline, in %: the least time the
traced frames' work needs on one card (rtbench/roofline.py, counted from
their exact segments and the scene's primitives) over the device time of
every kernel in those frames, summed over the ranks."""

from rtbench import roofline


def read(ctx):
    kernel_s = sum(r["kernel_s"] for r in ctx["ranks"])
    if ctx["step"] or kernel_s <= 0 or ctx["segments"] <= 0:
        return None
    ops, n_bytes = roofline.work(ctx["segments"], ctx["paths"],
                                 ctx["n_pixels"], ctx["scene"], step=False)
    return 100.0 * roofline.least_seconds(ops, n_bytes) / kernel_s
