"""Rendering: pixel grid -> ray pool -> accumulation -> display transform.

The port of scheme_raytrace_tpu/render.py.  The progressive accumulator is
an explicit, persistable `RenderState` (raw radiance sum + sample count).
Forward renders run the regeneration pool (integrator/pool.py); the
differentiable render (`config.differentiable`) runs sample passes through
the wavefront scan (integrator/wavefront.py), each pass keyed by
fold_in(root_key(seed), pass index) as in JAX.  Pixel estimator: jittered
u=(x+xi)/W, v=(y+xi)/H (main.scm:456-457); display transform
min(1, sqrt(mean)) then floor(255.99*c) (main.scm:461-465); PPM rows are
written y-flipped (main.scm:445).

Unlike JAX's per-pass scan, `render` traces up to WAVE_RAYS rays of
several passes as one wavefront: each pass draws from its own key alone,
and the frames are added in pass order, so the sum is the sequential one's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import config as cfg_mod
from .camera import Camera, get_rays
from .core import rng
from .integrator.pool import render_pool_auto
from .integrator.wavefront import trace_rays_full
from .utils import telemetry

# Rays of one differentiable wavefront: smaller frames trace up to this
# many rays' worth of passes at once (the pool's forward width).
WAVE_RAYS = 64 * 1024


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


def _pixel_uv(config, key, dtype):
    """Jittered (u, v) for every pixel of one pass (main.scm:456-457); a
    batch of K pass keys gives [K, n_pixels] each."""
    idx = torch.arange(config.n_pixels, device=key.device)
    ys = torch.div(idx, config.nx, rounding_mode="floor")
    xs = idx % config.nx
    xi = rng.uniform(key, (config.n_pixels, 2), dtype)
    u = (xs.to(dtype) + xi[..., 0]) / config.nx
    v = (ys.to(dtype) + xi[..., 1]) / config.ny
    return u, v


def _trace_passes(scene, cam, config, key, dtype, on_bounce=None):
    """The wavefront of the passes keyed `key` ([2], or [K, 2] for K
    passes): the final RayState over their K * n_pixels rays, pass-major."""
    k_jit, k_lens, k_trace = rng.split(key, 3).unbind(-2)
    u, v = _pixel_uv(config, k_jit, dtype)
    o, d, time = get_rays(cam, u, v, k_lens)
    return trace_rays_full(scene, o.reshape(-1, 3), d.reshape(-1, 3),
                           time.reshape(-1), k_trace, config, on_bounce)


def render_pass(scene, cam: Camera, config: cfg_mod.RenderConfig,
                state: RenderState, pass_idx) -> RenderState:
    """One full-frame sample pass: every pixel gets one jittered ray tree
    (the wavefront's while mode, or its scan if config.differentiable)."""
    key = rng.fold_in(rng.root_key(config.seed, state.raw_sum.device),
                      pass_idx)
    radiance = _trace_passes(scene, cam, config, key,
                             state.raw_sum.dtype).radiance
    frame = radiance.reshape(config.ny, config.nx, 3)
    return RenderState(state.raw_sum + frame, state.sample_count + 1)


def render_passes(scene, cam: Camera, config: cfg_mod.RenderConfig,
                  state: RenderState, on_bounce=None):
    """config.spp differentiable passes from `state` (the wavefront scan):
    returns (state, segments).  Passes go up to WAVE_RAYS rays at a time,
    each keyed by its index as render_pass keys it; their frames add in
    pass order."""
    cfg = config.replace(differentiable=True)
    dev = state.raw_sum.device
    per = max(1, min(config.spp, WAVE_RAYS // config.n_pixels))
    raw, count = state.raw_sum, state.sample_count
    segments = torch.zeros((), dtype=torch.int64, device=dev)
    done = 0
    while done < config.spp:
        k = min(per, config.spp - done)
        idx = count + torch.arange(k, device=dev)
        key = rng.fold_in(rng.root_key(config.seed, dev), idx)
        out = _trace_passes(scene, cam, cfg, key, raw.dtype, on_bounce)
        for frame in out.radiance.reshape(k, config.ny, config.nx,
                                          3).unbind(0):
            raw = raw + frame
        count = count + k
        segments = segments + out.segments
        done += k
    return RenderState(raw, count), segments


def render_with_stats(scene, cam: Camera, config: cfg_mod.RenderConfig,
                      state: RenderState):
    """config.spp passes from `state` through the regeneration pool,
    whatever config.differentiable says (as the JAX package's): returns
    (state, segments, iters).

    segments is the exact number of path segments traced (0-d int64
    tensor on the state's device); iters the pool iterations (int)."""
    with telemetry.span("frame", unit=True):
        raw, segments, iters = render_pool_auto(
            scene, cam, config,
            state.raw_sum.reshape(config.n_pixels, 3), state.sample_count)
    new_state = RenderState(raw.reshape(config.ny, config.nx, 3),
                            state.sample_count + config.spp)
    return new_state, segments, iters


def render(scene, cam: Camera, config: cfg_mod.RenderConfig,
           state: RenderState) -> RenderState:
    """config.spp sample passes from `state`: through the regeneration pool,
    or the wavefront scan if config.differentiable (reverse mode)."""
    if config.differentiable:
        return render_passes(scene, cam, config, state)[0]
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
