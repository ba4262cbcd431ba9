"""Regeneration pool: the general masked-sweep path, and the dispatch.

The port of scheme_raytrace_tpu/integrator/pool.py.  `render_pool_auto`
routes as the JAX package does: a (scene, config) that `bounce.supported`
covers goes to the fused pool (`pool_fused.render_pool_fused`, kernel K1
on the card), everything else — BVH traversal, russian roulette, material
sort, more than MAX_FUSED_PRIMS prims, big image atlases — to the general
pool `render_pool` below; frames larger than BAND_PIX render as sequential
row-band drains of either.  Band-major issue order is bit-identical to
frame-major, since the RNG is keyed by global (pass, pixel) ids.

`render_pool` holds M rays; the moment a ray terminates its radiance is
added into the framebuffer and the lane is re-issued the next (pass,
pixel) work item, pass-major.  Every step is plain PyTorch on the scene's
device (no kernel: the JAX pool runs none either).  What differs from the
JAX module:
  * the while_loop is a Python loop that checks `alive.any()` on the host
    every iteration (one sync against the iteration's thousand-odd
    launches), so the iteration count is exact with no extra iteration;
  * the framebuffer flush adds each pixel's contributions in lane order
    with no float atomics: lanes i and i + n_pix share a pixel whenever
    M > n_pix, and the JAX scatter-add adds such duplicates in lane order.
    PyTorch's CUDA `index_put_(accumulate=True)` does not (on an H100 its
    sum differed from the lane-order one bitwise, with 65,536 lanes over
    40,000 pixels), so `flush_add_` adds in rounds.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import config as cfg
from ..camera import get_rays_u
from ..core import rng
from ..core import vecmath as vm
from . import bounce, pool_fused, shade
from .hit import scene_hit

# Pixels per row band: the JAX package's TPU value (its flush scatter slowed
# with the framebuffer's size); to be re-swept on the GPU.
BAND_PIX = 256 * 1024


class PoolState(NamedTuple):
    o: torch.Tensor           # [M,3]
    d: torch.Tensor           # [M,3] unit
    time: torch.Tensor        # [M]
    radiance: torch.Tensor    # [M,3] accumulated along the current path
    throughput: torch.Tensor  # [M,3]
    item: torch.Tensor        # [M] int64 local work-item id (pass-major)
    gitem: torch.Tensor       # [M] int32 GLOBAL work-item id (RNG counter key)
    depth: torch.Tensor       # [M] int32 bounces completed on this path
    alive: torch.Tensor       # [M] bool
    next_w: torch.Tensor      # 0-d int64 — next local work item to issue
    raw: torch.Tensor         # [n_pixels + M,3] framebuffer radiance sums,
                              # then a spill row a lane (flush_add_)
    segments: torch.Tensor    # 0-d int64 — total path segments traced


def _sky(scene, d):
    t = 0.5 * (vm.unit(d)[..., 1] + 1.0)
    return (1.0 - t)[..., None] * scene.sky_a + t[..., None] * scene.sky_b


def _camera_rays(cam, config, item, sample_base, n_pix, pix0, total_pix,
                 dtype):
    """Camera rays for local work items (pass-major over this band's n_pix
    pixels); the RNG is keyed by the GLOBAL work-item id
    (sample_base + pass) * total_pix + pixel, wrapped to int32 as the JAX
    package's int32 arithmetic wraps it."""
    pix_local = item % n_pix
    pass_idx = torch.div(item, n_pix, rounding_mode="floor")
    gpix = pix0 + pix_local
    abs_item = bounce.wrap_i32((sample_base + pass_idx) * total_pix + gpix)
    u = rng.hash_uniforms(config.seed, abs_item, rng.CAMERA_DEPTH, 5, dtype)
    ys = torch.div(gpix, config.nx, rounding_mode="floor")
    xs = gpix % config.nx
    s = (xs.to(dtype) + u[:, 0]) / config.nx      # main.scm:456-457
    t = (ys.to(dtype) + u[:, 1]) / config.ny
    o, d, time = get_rays_u(cam, s, t, u[:, 2], u[:, 3], u[:, 4])
    return o, d, time, abs_item


def flush_add_(raw, pix, val, done):
    """raw[pix[i]] += val[i] for every lane i where `done`, in place, a
    pixel's contributions added one after another in lane order.

    raw holds the frame's n_pix rows and one spill row a lane after them.
    Lanes that share a pixel are ranked in lane order (a stable sort); round
    r adds every pixel's r-th contribution with `index_add_` into indices
    that are unique within the round (the other lanes add into their own
    spill rows), so each float add has one writer: no float atomics
    contend and the sum is the lane-order sum.  The rounds' count, the
    largest rank + 1, is read on the host (one sync)."""
    m = pix.shape[0]
    n_pix = raw.shape[0] - m
    lane = torch.arange(m, device=pix.device)
    spill = n_pix + lane
    key = torch.where(done, pix, spill)
    sk, perm = torch.sort(key, stable=True)
    first = torch.ones(m, dtype=torch.bool, device=pix.device)
    first[1:] = sk[1:] != sk[:-1]
    run0 = torch.cummax(torch.where(first, lane, 0), 0).values
    rank = torch.empty_like(lane).scatter_(0, perm, lane - run0)
    for r in range(int(rank.max()) + 1):
        raw.index_add_(0, torch.where(rank == r, key, spill), val)
    return raw


def _band_rows(ny, nx):
    """Largest row count dividing ny with band_rows * nx <= BAND_PIX."""
    cap = max(1, BAND_PIX // max(nx, 1))
    for r in range(min(cap, ny), 0, -1):
        if ny % r == 0:
            return r
    return ny


def render_pool_auto(scene, cam, config, raw0, sample_base, pix0=0,
                     total_pix=None):
    """Render config.spp passes into raw0 ([n_pix, 3] radiance sums);
    return (raw, segments, iters).  The fused pool takes what
    `bounce.supported` covers, the general pool the rest."""
    if bounce.supported(scene, config):
        fn = pool_fused.render_pool_fused
    else:
        fn = render_pool

    n_pix = raw0.shape[0]
    whole_frame = (pix0 == 0 and (total_pix is None or total_pix == n_pix)
                   and n_pix == config.n_pixels)
    if whole_frame and n_pix > BAND_PIX:
        band_pix = _band_rows(config.ny, config.nx) * config.nx
        n_bands = n_pix // band_pix
        if n_bands > 1:
            raw = raw0.clone()
            segs, iters = 0, 0
            for b in range(n_bands):
                sl = slice(b * band_pix, (b + 1) * band_pix)
                raw[sl], s, i = fn(scene, cam, config, raw0[sl], sample_base,
                                   pix0=b * band_pix, total_pix=n_pix)
                segs, iters = segs + s, iters + i
            return raw, segs, iters

    return fn(scene, cam, config, raw0, sample_base, pix0, total_pix)


def _step(scene, cam, config, st: PoolState, sample_base, n_pix, n_work,
          pix0, total_pix) -> PoolState:
    """One pool iteration: every lane's closest hit, shading, the flush of
    finished paths and the re-issue of freed lanes (the JAX while_loop
    body, op for op)."""
    dtype = st.raw.dtype
    abs_item = st.gitem
    xi_med = (rng.hash_uniforms(config.seed, abs_item, st.depth,
                                scene.med_kind.shape[0], dtype,
                                group_base=rng.GROUP_MEDIUM)
              if scene.has_media else None)
    u_shade = rng.hash_uniforms(config.seed, abs_item, st.depth, shade.N_U,
                                dtype)

    rec = scene_hit(st.o, st.d, st.time, scene, cfg.SHADOW_EPS, cfg.BIG,
                    xi_med, config)
    missed = st.alive & ~rec.hit
    radiance = st.radiance + torch.where(
        missed[:, None], st.throughput * _sky(scene, st.d), 0.0)

    shade_fn = shade.shade_sorted if config.material_sort else shade.shade
    sc = shade_fn(u_shade, scene, config, st.d, rec)
    hit_live = st.alive & rec.hit
    radiance = radiance + torch.where(hit_live[:, None],
                                      st.throughput * sc.emitted, 0.0)

    scattering = hit_live & sc.alive & (st.depth < config.max_depth)
    throughput = torch.where(scattering[:, None], st.throughput * sc.mult,
                             st.throughput)
    if config.russian_roulette:
        u_rr = rng.hash_uniforms(config.seed, abs_item, st.depth, 1, dtype,
                                 group_base=rng.GROUP_RR)[:, 0]
        p_cont = vm.clip(torch.amax(throughput, dim=-1), 0.05, 1.0)
        do_rr = scattering & (st.depth >= config.rr_start_depth)
        scattering = scattering & (~do_rr | (u_rr < p_cont))
        throughput = torch.where(
            do_rr[:, None],
            throughput / vm.maximum(p_cont, 0.05)[:, None], throughput)

    # --- flush finished paths into the framebuffer -------------------------
    terminated = st.alive & ~scattering
    raw = flush_add_(st.raw, st.item % n_pix,
                     torch.where(terminated[:, None], radiance, 0.0),
                     terminated)

    # --- re-issue freed lanes the next work items --------------------------
    t_i = terminated.to(torch.int64)
    new_local = st.next_w + torch.cumsum(t_i, 0) - t_i    # exclusive rank
    has_work = terminated & (new_local < n_work)
    item = torch.where(has_work, new_local, st.item)
    o_new, d_new, time_new, gitem_new = _camera_rays(
        cam, config, item, sample_base, n_pix, pix0, total_pix, dtype)
    gitem = torch.where(has_work, gitem_new, st.gitem)

    o = vm.where3(scattering, rec.p, vm.where3(has_work, o_new, st.o))
    d = vm.where3(scattering, sc.direction,
                  vm.where3(has_work, d_new, st.d))
    time = torch.where(has_work, time_new, st.time)
    radiance = torch.where(terminated[:, None], 0.0, radiance)
    throughput = torch.where(has_work[:, None], 1.0, throughput)
    depth = torch.where(scattering, st.depth + 1,
                        torch.where(has_work, 0, st.depth))
    alive = scattering | has_work
    next_w = torch.clamp(st.next_w + t_i.sum(), max=n_work)
    segments = st.segments + st.alive.sum()
    return PoolState(o, d, time, radiance, throughput, item, gitem, depth,
                     alive, next_w, raw, segments)


def render_pool(scene, cam, config, raw0, sample_base, pix0=0,
                total_pix=None):
    """Trace config.spp passes over raw0's pixels via the regeneration pool.

    raw0: [n_pix, 3] running radiance sums (the whole frame, or a row band
    whose first pixel is `pix0` of a `total_pix`-pixel frame); it is not
    changed.  sample_base: passes already in raw0 (int or 0-d integer
    tensor), offsetting the absolute work-item ids so a resumed render
    draws fresh, reproducible randomness.  Returns (raw, segments, iters):
    segments a 0-d int64 tensor (exact path segments), iters the pool
    iterations (Python int).  Runs on raw0's device.
    """
    n_pix = raw0.shape[0]
    total_pix = config.n_pixels if total_pix is None else total_pix
    n_work = n_pix * config.spp
    m = min(config.resolve_pool_rays(), n_work)
    dev, dtype = raw0.device, raw0.dtype
    i64 = dict(dtype=torch.int64, device=dev)
    base = torch.as_tensor(sample_base, device=dev).to(torch.int64)

    item0 = torch.arange(m, **i64)
    o0, d0, time0, gitem0 = _camera_rays(cam, config, item0, base, n_pix,
                                         pix0, total_pix, dtype)
    st = PoolState(
        o=o0, d=d0, time=time0,
        radiance=torch.zeros((m, 3), dtype=dtype, device=dev),
        throughput=torch.ones((m, 3), dtype=dtype, device=dev),
        item=item0, gitem=gitem0,
        depth=torch.zeros(m, dtype=torch.int32, device=dev),
        alive=torch.ones(m, dtype=torch.bool, device=dev),
        next_w=torch.full((), m, **i64),
        raw=torch.cat([raw0, raw0.new_zeros(m, 3)]),
        segments=torch.zeros((), **i64))
    iters = 0
    while bool(st.alive.any()):
        st = _step(scene, cam, config, st, base, n_pix, n_work, pix0,
                   total_pix)
        iters += 1
    return st.raw[:n_pix], st.segments, iters
