"""Wavefront path tracing over a batched ray pool.

The port of scheme_raytrace_tpu/integrator/wavefront.py: the whole pool
advances one bounce per iteration, either until every ray has terminated
(the `while` mode) or for a fixed max_depth + 1 bounces (the scan mode,
`config.differentiable`, whose gradients reverse-mode autograd takes).

Behavioral contract (SURVEY §6.3):
  L = emitted + (attenuation * s_pdf) * L(scattered) / pdf   (main.scm:113-118)
  depth cap: bounce index == max_depth contributes emitted only (main.scm:112)
  miss at any depth -> per-scene sky (main.scm:120, :91-98)
  t range [SHADOW_EPS, BIG] (main.scm:104)
Scattered rays keep the primary ray's time, as in the JAX package.

Every draw is threefry, keyed per (pass, bounce, site) (core/rng.py), so
the image and gradients are the JAX module's.  What differs from it:
  * the `while` mode is a Python loop that reads `alive.any()` on the host
    once a bounce;
  * the scan mode runs each bounce under `torch.utils.checkpoint`
    (non-reentrant) while autograd records, as JAX runs each under
    `jax.checkpoint`: the tape holds a bounce's input state, not its
    intersections, and the recompute draws from the same keys, so it is
    exact;
  * the bounce index is a Python int, and every bounce's site keys are
    drawn up front in two hashes;
  * `key` may be a batch of K pass keys [K, 2]: the N rays are then K
    groups of N / K, each drawing from its own key alone, as `jax.vmap`
    over the keys would (render.py traces several passes as one wavefront).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import config as cfg
from ..core import rng
from ..core import vecmath as vm
from . import shade
from .hit import scene_hit

# the threefry sites of one bounce: medium distances, the shade matrix and
# the russian-roulette roll (bounce_key's salts)
_SITES = (rng.SITE_MEDIUM, rng.SITE_SCATTER, rng.SITE_RR)


class RayState(NamedTuple):
    o: torch.Tensor           # [N,3]
    d: torch.Tensor           # [N,3] unit
    time: torch.Tensor        # [N]
    radiance: torch.Tensor    # [N,3]
    throughput: torch.Tensor  # [N,3]
    alive: torch.Tensor       # [N] bool
    depth: int                # bounces run
    segments: torch.Tensor    # 0-d int64 — total path segments traced


def sky_color(scene, d):
    """main.scm:91-98 — lerp(white, (0.5,0.7,1.0)) by 0.5(y+1), or black."""
    t = 0.5 * (vm.unit(d)[..., 1] + 1.0)
    return (1.0 - t)[..., None] * scene.sky_a + t[..., None] * scene.sky_b


def _draw(key, n, cols, dtype):
    """[n, cols] uniforms from a key, or from a batch of K keys, each for
    its group of n / K rays."""
    k = key.shape[0] if key.dim() > 1 else 1
    return rng.uniform(key, (n // k, cols), dtype).reshape(n, cols)


def _bounce(state: RayState, scene, config, site_keys) -> RayState:
    """Advance every live ray one bounce; site_keys [..., S, 2] are this
    bounce's keys of _SITES."""
    n = state.o.shape[0]
    dtype = state.o.dtype
    k_hit, k_shade = site_keys[..., 0, :], site_keys[..., 1, :]
    xi_med = (_draw(k_hit, n, scene.med_kind.shape[0], dtype)
              if scene.has_media else None)
    k = k_shade.shape[0] if k_shade.dim() > 1 else 1
    u_shade = shade.shade_uniforms(k_shade, n // k, dtype).reshape(n, -1)

    rec = scene_hit(state.o, state.d, state.time, scene,
                    cfg.SHADOW_EPS, cfg.BIG, xi_med, config)

    missed = state.alive & ~rec.hit
    radiance = state.radiance + torch.where(
        missed[:, None], state.throughput * sky_color(scene, state.d), 0.0)

    sc = shade.shade(u_shade, scene, config, state.d, rec)
    hit_live = state.alive & rec.hit
    radiance = radiance + torch.where(hit_live[:, None],
                                      state.throughput * sc.emitted, 0.0)

    scattering = hit_live & sc.alive & (state.depth < config.max_depth)
    throughput = torch.where(scattering[:, None],
                             state.throughput * sc.mult, state.throughput)
    if config.russian_roulette:
        # OFF for parity configs (SURVEY §7.3 item 3); JAX's clip and its
        # tie gradient, and amax's even split among tied components
        p_cont = vm.clip(torch.amax(throughput, dim=-1), 0.05, 1.0)
        roll = _draw(site_keys[..., 2, :], n, 1, dtype)[:, 0]
        do_rr = scattering & (state.depth >= config.rr_start_depth)
        scattering = scattering & (~do_rr | (roll < p_cont))
        throughput = torch.where(
            do_rr[:, None], throughput / vm.maximum(p_cont, 0.05)[:, None],
            throughput)

    o = vm.where3(scattering, rec.p, state.o)
    d = vm.where3(scattering, sc.direction, state.d)
    segments = state.segments + state.alive.sum()
    return RayState(o, d, state.time, radiance, throughput, scattering,
                    state.depth + 1, segments)


def trace_rays(scene, o, d, time, key, config) -> torch.Tensor:
    """Integrate radiance for a ray pool; returns [N,3]."""
    return trace_rays_full(scene, o, d, time, key, config).radiance


def trace_rays_full(scene, o, d, time, key, config,
                    on_bounce=None) -> RayState:
    """Like trace_rays but returns the final RayState (incl. segments).

    o/d/time from camera.get_rays; key is the pass's bounce-key root ([2],
    or [K, 2] for K passes of N / K rays each).  `on_bounce(state)`, when
    given, sees the state after every bounce (utils/checks.py)."""
    n = o.shape[0]
    sites = torch.tensor(_SITES[:3 if config.russian_roulette else 2],
                         device=key.device)
    n_bounces = config.max_depth + 1
    depths = torch.arange(n_bounces, device=key.device)
    keys = rng.bounce_key(key[..., None, :], depths, sites)  # [..., D, S, 2]
    state = RayState(
        o=o, d=d, time=time,
        radiance=torch.zeros_like(o),
        throughput=torch.ones_like(o),
        alive=torch.ones(n, dtype=torch.bool, device=o.device),
        depth=0,
        segments=torch.zeros((), dtype=torch.int64, device=o.device))

    while state.depth < n_bounces:
        if not config.differentiable and not bool(state.alive.any()):
            break                                  # the while mode's exit
        site_keys = keys[..., state.depth, :, :]
        if config.differentiable and torch.is_grad_enabled():
            state = checkpoint(_bounce, state, scene, config, site_keys,
                               use_reentrant=False, preserve_rng_state=False)
        else:
            state = _bounce(state, scene, config, site_keys)
        if on_bounce is not None:
            on_bounce(state)
    return state
