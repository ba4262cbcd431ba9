"""The plain reference the benchmark compares the program with.

Plain PyTorch (any device, any float type), written from the scene's
description in a configuration file; it imports nothing of the program
under test and takes no array the program made.  Two entry points, run in
blocks of pixels so that a full frame fits beside nothing else on the card:

  * `render_frame`: the radiance sums of a frame of `spp` passes from
    `sample_base` on, and its exact path segments;
  * `train_steps`: steps of gradient descent on an image loss, each the
    loss, every parameter's gradient, the update p - lr * g and the step's
    exact path segments.

Both add the kleins' march work (lane-steps, inversions, accepted hits)
into `work`, a dict, where the caller gives one.
"""

from __future__ import annotations

import torch

from .scene import compile_scene
from .tracer import Prims, camera_basis, trace

M32 = 0xFFFFFFFF


def _setup(cfg, nx, ny, dtype, device):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sc = compile_scene(cfg, dtype=dtype, device=device)
    cam = dict(cfg["camera"], aspect=nx / ny)
    return sc, camera_basis(cam, dtype, device)


def _lanes(nx, ny, spp, sample_base, pix, dtype):
    """Work items, columns and rows of `spp` passes over pixels `pix`,
    pass-major."""
    p = torch.arange(spp, device=pix.device)[:, None]
    item = ((sample_base + p) * (nx * ny) + pix[None, :]).reshape(-1) & M32
    pix = pix.repeat(spp)
    return item, (pix % nx).to(dtype), torch.div(
        pix, nx, rounding_mode="floor").to(dtype)


def _pixel_sums(rad, spp):
    """Each pixel's passes added in pass order from 0.0 ([spp * B, 3] in
    pass-major order -> [B, 3])."""
    rad = rad.reshape(spp, -1, 3)
    acc = torch.zeros_like(rad[0])
    for k in range(spp):
        acc = acc + rad[k]
    return acc


def render_frame(cfg, nx, ny, spp, seed, sample_base=0, dtype=torch.float32,
                 device="cpu", lanes_per_block=1 << 22, work=None):
    """(radiance sums [ny * nx, 3] of `spp` passes, path segments) of the
    frame whose first pass is `sample_base`, in `dtype` on `device`."""
    rc = cfg["render"]
    sc, basis = _setup(cfg, nx, ny, dtype, device)
    n_pix = nx * ny
    block = max(1, lanes_per_block // spp)
    out, segs = [], 0
    with torch.no_grad():
        P = Prims(sc, dtype, work)
        for p0 in range(0, n_pix, block):
            pix = torch.arange(p0, min(p0 + block, n_pix), device=device)
            item, px, py = _lanes(nx, ny, spp, sample_base, pix, dtype)
            rad, seg = trace(P, rc, seed, basis, nx, ny, item, px, py)
            out.append(_pixel_sums(rad, spp))
            segs += int(seg.sum())
    return torch.cat(out), segs


def train_steps(cfg, nx, ny, spp, seeds, target, lr, dtype=torch.float32,
                device="cpu", lanes_per_block=1 << 21, keep=None, start=None,
                work=None):
    """len(seeds) steps of p <- p - lr * grad(loss), step k rendering with
    seeds[k], from the configuration's parameters, or from `start` (a dict
    of them by name: a step replayed from given parameters); the loss is
    sum((raw / spp - target)^2) / (n * 3) over the frame's radiance sums
    `raw` ([ny * nx, 3]) and target [ny, nx, 3], n = ny * nx, or over the
    pixels where the boolean mask `keep` ([ny * nx]) holds, n their count.
    Returns (losses [float], parameters before and after each step [dict],
    the first step's gradients [dict], each step's path segments [int])."""
    rc = cfg["render"]
    sc, basis = _setup(cfg, nx, ny, dtype, device)
    cur = dict(sc.leaves)
    if start is not None:
        cur = {k: start[k].to(device=device, dtype=dtype) for k in cur}
    tgt = target.to(device=device, dtype=dtype).reshape(-1, 3)
    n_pix = nx * ny
    if keep is not None:
        keep = keep.to(device)
    norm = float((n_pix if keep is None else int(keep.sum())) * 3)
    block = max(1, lanes_per_block // spp)
    losses, segments = [], []
    history = [{k: v.detach().clone() for k, v in cur.items()}]
    first = None
    for seed in seeds:
        leaves = {k: v.detach().requires_grad_() for k, v in cur.items()}
        sc.leaves = leaves
        grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
        total, segs = 0.0, 0
        for p0 in range(0, n_pix, block):
            P = Prims(sc, dtype, work)
            pix = torch.arange(p0, min(p0 + block, n_pix), device=device)
            item, px, py = _lanes(nx, ny, spp, 0, pix, dtype)
            rad, seg = trace(P, rc, seed, basis, nx, ny, item, px, py)
            segs += int(seg.sum())
            err = (_pixel_sums(rad, spp) / spp - tgt[p0:p0 + pix.numel()]) ** 2
            if keep is not None:
                err = torch.where(keep[pix][:, None], err, 0.0)
            loss = torch.sum(err) / norm
            total += float(loss.detach().double())
            gs = torch.autograd.grad(loss, list(leaves.values()),
                                     allow_unused=True)
            for (k, _), g in zip(leaves.items(), gs):
                if g is not None:
                    grads[k] += g
        losses.append(total)
        segments.append(segs)
        first = grads if first is None else first
        cur = {k: v.detach() - lr * grads[k] for k, v in leaves.items()}
        history.append({k: v.clone() for k, v in cur.items()})
    return losses, history, first, segments
