"""Rendering: pool render -> progressive accumulation -> display transform.

The port of scheme_raytrace_tpu/render.py.  The progressive accumulator is
an explicit, persistable `RenderState` (raw radiance sum + sample count).
Display transform min(1, sqrt(mean)) then floor(255.99*c)
(main.scm:461-465); PPM rows are written y-flipped (main.scm:445).

Only the forward pool render is ported: `config.differentiable=True`
(the fixed-length wavefront scan) raises NotImplementedError until
ROADMAP A.12.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import config as cfg_mod
from .camera import Camera
from .integrator.pool import render_pool_auto


@dataclasses.dataclass
class RenderState:
    """Progressive accumulation state (main.scm:430-431,531 made explicit)."""
    raw_sum: torch.Tensor       # [ny, nx, 3] running radiance sum (row 0 = bottom)
    sample_count: torch.Tensor  # 0-d int32 — completed passes


def init_state(config: cfg_mod.RenderConfig, dtype=None,
               device=None) -> RenderState:
    """A zero state on `device` (None: the card, config.resolve_device)."""
    dtype = config.torch_dtype if dtype is None else dtype
    device = cfg_mod.resolve_device(device)
    return RenderState(
        torch.zeros((config.ny, config.nx, 3), dtype=dtype, device=device),
        torch.zeros((), dtype=torch.int32, device=device))


def render_with_stats(scene, cam: Camera, config: cfg_mod.RenderConfig,
                      state: RenderState):
    """config.spp passes from `state`: returns (state, segments, iters).

    segments is the exact number of path segments traced (0-d int64
    tensor on the state's device); iters the pool iterations (int)."""
    if config.differentiable:
        raise NotImplementedError(
            "config.differentiable=True: the reverse-mode wavefront path is "
            "not ported yet (ROADMAP A.12)")
    raw, segments, iters = render_pool_auto(
        scene, cam, config,
        state.raw_sum.reshape(config.n_pixels, 3), state.sample_count)
    new_state = RenderState(raw.reshape(config.ny, config.nx, 3),
                            state.sample_count + config.spp)
    return new_state, segments, iters


def render(scene, cam: Camera, config: cfg_mod.RenderConfig,
           state: RenderState) -> RenderState:
    """config.spp sample passes from `state` through the regeneration pool."""
    return render_with_stats(scene, cam, config, state)[0]


def render_image(scene, cam: Camera, config: cfg_mod.RenderConfig,
                 dtype=None):
    """Fresh render on the scene's device: (mean radiance [ny,nx,3], state)."""
    dtype = config.torch_dtype if dtype is None else dtype
    state = render(scene, cam, config,
                   init_state(config, dtype, device=scene.device))
    mean = state.raw_sum / torch.clamp(state.sample_count, min=1).to(dtype)
    return mean, state


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def to_u8(mean) -> np.ndarray:
    """Display transform (main.scm:461-465): clamp(sqrt(mean)) -> u8."""
    mean = _np(mean)
    c = np.minimum(np.sqrt(np.maximum(mean, 0.0)), 1.0)   # gamma 2 + clamp
    return np.floor(cfg_mod.GAMMA_QUANT * c).astype(np.uint8)


def write_ppm(path: str, mean) -> None:
    """ASCII P3, y-flipped rows (main.scm:439-450)."""
    img = to_u8(mean)
    ny, nx, _ = img.shape
    with open(path, "w") as f:
        f.write(f"P3\n{nx} {ny}\n255\n")
        for y in range(ny - 1, -1, -1):                   # main.scm:445
            for x in range(nx):
                r, g, b = img[y, x]
                f.write(f"{r} {g} {b}\n")


def save_state(path: str, state: RenderState, seed: int) -> None:
    """Persist (raw_sum, sample_count, seed) — resumable renders (§5.4)."""
    np.savez(path, raw_sum=_np(state.raw_sum),
             sample_count=_np(state.sample_count), seed=seed)


def load_state(path: str, device=None) -> RenderState:
    device = cfg_mod.resolve_device(device)
    z = np.load(path)
    return RenderState(torch.as_tensor(z["raw_sum"], device=device),
                       torch.as_tensor(z["sample_count"], device=device))
