"""The card's idle share of the traced whole frames, in %: 100 (1 - the
union of all device intervals over the window); a mean over the ranks."""


def read(ctx):
    if ctx["step"] or not sum(r["busy_s"] for r in ctx["ranks"]):
        return None
    return sum(100.0 * (1.0 - r["busy_s"] / r["window_s"])
               for r in ctx["ranks"]) / len(ctx["ranks"])
