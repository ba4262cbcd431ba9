"""Packed-state regeneration pool (scheme_raytrace_tpu/integrator/
pool_packed.py).

The strided pool of integrator/pool_strided.py with the whole pool state
in one [N_PACKED, m] float32 tensor (bounce.py N_PACKED; ints as their
bits) and the strided re-issue moved into the step: each iteration is one
launch of the packed-state kernel (K3, `bounce.step_packed_cuda`, on the
card; the plain `bounce.step_packed` on the CPU), one tensor in and one
out.  The glue left per iteration stages the finished paths, read from the
new state: fresh == 1 marks a lane whose path just terminated, its rad rows
hold that path's radiance, and its pixel is (item - m) % n_pix.  The
framebuffer add runs every FLUSH_EVERY iterations, as in the strided pool
(pool_strided.Framebuffer: ordered, race-free, bitwise reproducible).

float32 only, as the reference, which packs the state as float32; the
attribute-atlas plan flag is dropped as there (bounce.pool_plan).
Returns (raw, segments, iters) like the other pools.
"""

from __future__ import annotations

import torch

from . import bounce
from .pool_strided import FLUSH_EVERY, Framebuffer, pool_size


def render_pool_packed(scene, cam, config, raw0, sample_base, pix0=0,
                       total_pix=None):
    """Trace config.spp passes over raw0's pixels ([n_pix, 3] float32
    radiance sums, the frame or a row band starting at frame pixel pix0);
    return (raw, segments, iters)."""
    if raw0.dtype != torch.float32:
        raise TypeError("the packed pool stores its state as float32; "
                        f"raw0 is {raw0.dtype}")
    n_pix = raw0.shape[0]
    total_pix = config.n_pixels if total_pix is None else total_pix
    n_work = n_pix * config.spp
    m = pool_size(config, n_work)
    dev = raw0.device
    step = bounce.step_packed_cuda if dev.type == "cuda" else \
        bounce.step_packed
    plan = bounce.pool_plan(scene, config)
    pk = bounce.pack(scene, cam, plan, torch.float32)
    sb = torch.as_tensor(sample_base, device=dev).to(torch.int32).reshape(1)

    state = bounce.initial_packed_state(m, dev)
    fb = Framebuffer(raw0, m, config.spp)
    segments = torch.zeros((), dtype=torch.int64, device=dev)
    iters = 0
    while True:
        pixs, vals = [], []
        for _ in range(FLUSH_EVERY):
            segments = segments + (state.view(torch.int32)[0]
                                   < n_work).sum()
            state = step(plan, pk, sb, state, m, n_work, n_pix, pix0,
                         total_pix)
            item = state.view(torch.int32)[0].to(torch.int64)
            done = torch.where(state[1] != 0.0, (item - m) % n_pix, -1)
            pixs.append(done)
            vals.append(state[10:13])
            iters += 1
        fb.add(torch.stack(pixs), torch.stack(vals))
        if not bool((state.view(torch.int32)[0] < n_work).any()):
            return fb.image(), segments, iters
