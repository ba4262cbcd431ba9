"""Reverse-mode-differentiable regeneration pool (the fwd+bwd path).

The port of scheme_raytrace_tpu/integrator/diff_fused.py.  It is the
forward pool of integrator/pool_fused.py run for a fixed number of
iterations (`static_iters`) with every update out of place, so torch
autograd can differentiate it: the same estimator, the same counter-hash
RNG and the same framebuffer order, so with a drained queue the image
equals the forward pool's bitwise.  Reverse mode needs the iteration count
up front; `calibrate_iters` measures it with one undifferentiated forward
render, and the returned `leftover` proves the queue drained.

On the card each bounce is `bounce.step_cuda_vjp`: the forward through the
bounce_step kernel, the backward through the bounce_step_bwd kernel, with
the step's inputs as the only residuals.  On the CPU the plain `step` is
differentiated by autograd.
"""

from __future__ import annotations

import torch

from . import bounce
from . import pool_fused


def supported(scene, config) -> bool:
    """Same coverage as the fused forward step."""
    return bounce.supported(scene, config)


def calibrate_iters(scene, cam, config, slack: float = 1.25) -> int:
    """Static trip count for render_diff_fused: one forward pool render at
    the reverse-mode pool size measures the drain iteration count; `slack`
    covers run-to-run variation when the caller varies seed or
    sample_base between calls."""
    config = config.replace(
        pool_rays=config.resolve_pool_rays(reverse=True))
    raw0 = torch.zeros((config.n_pixels, 3), dtype=config.torch_dtype,
                       device=scene.device)
    with torch.no_grad():
        _, _, iters = pool_fused.render_pool_fused(scene, cam, config, raw0,
                                                   0)
    return int(-(-int(iters) * slack // 1))


def render_diff_fused_strict(scene, cam, config, n_iters: int,
                             sample_base=0):
    """render_diff_fused with a fail-loud drain guard: the radiance is NaN
    wherever the queue did not drain (leftover != 0), so an undersized
    n_iters shows in the loss and the gradients instead of biasing them."""
    raw, segs, leftover = render_diff_fused(scene, cam, config, n_iters,
                                            sample_base)
    raw = torch.where(leftover == 0, raw, torch.nan)
    return raw, segs, leftover


def render_diff_fused(scene, cam, config, n_iters: int, sample_base=0):
    """Differentiable pool render.

    Returns (raw [n_pix, 3] radiance sums over config.spp passes, segments,
    leftover).  Gradients flow to every float leaf of `scene` and `cam`
    through the packed scene vector (bounce.pack runs under autograd).
    `leftover` must be checked: a nonzero value means n_iters was too small
    to drain the work queue, and the image and gradients miss that work.
    """
    raw0 = torch.zeros((config.n_pixels, 3), dtype=config.torch_dtype,
                       device=scene.device)
    return pool_fused.render_pool_fused(scene, cam, config, raw0,
                                        sample_base, static_iters=n_iters)
