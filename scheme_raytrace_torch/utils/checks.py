"""Numerical-hygiene checks (SURVEY §5.2): a render whose state is checked
for NaN/Inf after every bounce.

The port of scheme_raytrace_tpu/utils/checks.py.  JAX instruments every op
with `checkify`, which has no PyTorch counterpart; here the differentiable
(scan) path's radiance and throughput are checked with `torch.isfinite`
after every bounce, and the mean image at the end, and the first
non-finite value raises with its bounce.  Each check reads a flag on the
host, so this is a debug path; production renders stay unchecked and are
guarded by the NaN-regression tests (tests/test_torch_parity.py).
"""

from __future__ import annotations

import torch

from .. import render as R


class NonFiniteError(RuntimeError):
    """A render produced NaN or Inf; `bounce` is the bounce index, or None
    for the mean image."""

    def __init__(self, what, bounce=None):
        where = "the mean image" if bounce is None else f"bounce {bounce}"
        super().__init__(f"non-finite {what} at {where}")
        self.what, self.bounce = what, bounce


def _check(x, what, bounce=None):
    if not bool(torch.isfinite(x).all()):
        raise NonFiniteError(what, bounce)


def checked_render_image(scene, cam, config):
    """render_image through the scan path, checked for NaN/Inf after every
    bounce; returns the mean image or raises NonFiniteError."""
    def on_bounce(state):
        _check(state.radiance, "radiance", state.depth - 1)
        _check(state.throughput, "throughput", state.depth - 1)

    state = R.init_state(config, device=scene.device)
    state, _ = R.render_passes(scene, cam, config, state, on_bounce)
    mean = state.raw_sum / torch.clamp(state.sample_count, min=1).to(
        state.raw_sum.dtype)
    _check(mean, "mean")
    return mean
