"""On-card A/B: the training step's loss and gradients through the K2
backward kernel against the plain step's VJP.

The port of tools/check_vjp_grads_tpu.py: Cornell with light sampling,
64^2 spp2 depth 24, m = 4,096; the loss sum(raw^2)/numel and every leaf's
gradient through `render_diff_fused`, once on the kernels' route (K1
forward, K2 backward: `bounce.step_cuda_vjp`) and once through the plain
`bounce.step` under torch autograd on the same card (JAX's use_pallas=False),
both on the kernels' trip count.  The port's pool picks its step by device
and takes none from its caller, so the plain route swaps the pool's two
card steps for the plain step for the length of its run (`plain_step`).
On the CPU both routes are the plain step.

It runs in float32, the JAX tool's setting, and prints the JAX tool's
lines: each leaf's largest difference over its own largest |plain
gradient|.  In float32 that ratio is not a bound on the adjoint: the
geometric leaves' gradients (a rect's offset, rotation, translation) are
sums of large per-lane terms that cancel to 1e-5-1e-4 of the largest
leaf's, and the two routes round them differently (on an H100 the ratio
reads 2.1e-2 on `rect_k`).  So the float32 pass is held as
tests/test_parity.py holds float32 gradients (its scale: each difference
over the larger of |plain gradient| and 5% of the largest |plain gradient|
of any leaf; its bound: config 4's f32_grad_rtol, BOUND), and the same
comparison in float64, where rounding no longer hides an adjoint's fault,
holds every leaf under its own largest |plain gradient| within BOUND_F64.

Then it reads both float32 routes against the float64 kernel route (which
agrees with float64 plain to within BOUND_F64): for every leaf, the
largest difference of each f32 gradient from the f64 one over the f64
leaf's largest |gradient|, and their ratio, kernel over plain.  Where the
kernel's f32 error is the plain step's, the kernel adds no error of its
own and the f32 routes' disagreement is two roundings of one cancelling
sum.  A reading only: no bound is asserted on it.

    python -m scheme_raytrace_torch.tools.check_vjp_grads [--cpu]
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch

from .. import parity
from ..config import RenderConfig
from ..integrator import bounce, diff_fused, pool_fused
from ..scene import build as sb
from .common import cornell, device_from, fwd_bwd

# float32: tests/test_parity.py's scale and bound for the Cornell config
BOUND = parity.BY_NAME["config4_cornell_light"].f32_grad_rtol
BOUND_F64 = 1e-9      # float64, each leaf over its own largest |gradient|


@contextlib.contextmanager
def plain_step():
    """The pool's card steps (forward and reverse) replaced by the plain
    `bounce.step` until the block ends."""
    saved = bounce.step_cuda, bounce.step_cuda_vjp
    bounce.step_cuda = bounce.step_cuda_vjp = bounce.step
    try:
        yield
    finally:
        bounce.step_cuda, bounce.step_cuda_vjp = saved


def grads_for(mode, scene, cam, config, n_iters):
    """(loss, {leaf: gradient as numpy}, the step that ran) of one route:
    "auto" (the pool's own step) or "plain"."""
    params, rest = sb.partition(scene)
    with plain_step() if mode == "plain" else contextlib.nullcontext():
        loss, (_, leftover), g = fwd_bwd(params, rest, cam, config, n_iters)
    assert int(leftover) == 0
    return (float(loss), {k: v.double().cpu().numpy() for k, v in g.items()},
            pool_fused.LAST_STEP_IMPL["reverse"])


def compare(scene, cam, config):
    """Both routes on one trip count; print the JAX tool's lines and
    return (loss rel, {leaf: rel}, {leaf: floored rel}, the kernel route's
    step, the kernel route's gradients, the plain route's)."""
    n_iters = diff_fused.calibrate_iters(scene, cam, config)
    l_a, g_a, impl = grads_for("auto", scene, cam, config, n_iters)
    l_j, g_j, plain = grads_for("plain", scene, cam, config, n_iters)
    assert plain == "plain" and impl == ("cuda" if scene.device.type == "cuda"
                                         else "plain"), (impl, plain)
    loss_rel = abs(l_a - l_j) / abs(l_j)
    print(f"[{config.dtype}] loss", l_a, l_j, "rel", loss_rel, flush=True)
    floor = 0.05 * max(np.abs(j).max(initial=0.0) for j in g_j.values())
    rel, floored = {}, {}
    for k in g_a:
        a, j = g_a[k], g_j[k]
        diff = np.abs(a - j)
        scale = max(np.abs(j).max(initial=0.0), 1e-8)
        rel[k] = float(diff.max(initial=0.0) / scale)
        floored[k] = float((diff / np.maximum(np.abs(j), floor + 1e-7))
                           .max(initial=0.0))
        print(f"{k:16s} max|g_plain|={np.abs(j).max(initial=0.0):.3e}  "
              f"rel_diff={rel[k]:.2e}  (floored {floored[k]:.2e})",
              flush=True)
    print(f"[{config.dtype}] worst rel", max(rel.values()), "floored",
          max(floored.values()), flush=True)
    return loss_rel, rel, floored, impl, g_a, g_j


def _rel_to(g, ref):
    """Largest |g - ref| over ref's largest |value| (floored at 1e-8)."""
    scale = max(np.abs(ref).max(initial=0.0), 1e-8)
    return float(np.abs(g - ref).max(initial=0.0) / scale)


def anchored(f32, f64):
    """Print and return {leaf: (kernel f32 rel, plain f32 rel, ratio)}, each
    f32 route's gradients against the f64 kernel route's; f32 and f64 are
    (kernel route, plain route) gradient dicts."""
    out = {}
    for k, ref in f64[0].items():
        a, b = _rel_to(f32[0][k], ref), _rel_to(f32[1][k], ref)
        ratio = a / b if b > 0 else (1.0 if a == 0 else float("inf"))
        out[k] = (a, b, ratio)
        print(f"{k:16s} max|g_f64|={np.abs(ref).max(initial=0.0):.3e}  "
              f"f32 kernel={a:.2e}  f32 plain={b:.2e}  "
              f"kernel/plain={ratio:.2f}", flush=True)
    worst = max(out, key=lambda k: out[k][2])
    print(f"[f32 vs f64] worst kernel {max(v[0] for v in out.values()):.2e} "
          f"plain {max(v[1] for v in out.values()):.2e}; kernel/plain at "
          f"most {out[worst][2]:.2f} ({worst})", flush=True)
    return out


def run(size=64, spp=2, max_depth=24, m=4096, device=None):
    """Print the JAX tool's lines for float32 and float64, then the f32
    routes against f64; return dict(impl, f32=..., f64=..., anchored=...),
    f32 and f64 each (loss rel, worst, worst floored), anchored as
    `anchored` returns it; raise if a bound is missed."""
    out, grads = {}, {}
    for dtype, name in ((torch.float32, "f32"), (torch.float64, "f64")):
        scene, cam = cornell(device, dtype)
        config = RenderConfig(nx=size, ny=size, spp=spp, max_depth=max_depth,
                              light_sampling=True, seed=0, pool_rays=m,
                              dtype=name)
        loss_rel, rel, floored, impl, *grads[name] = compare(scene, cam,
                                                             config)
        out[name] = (loss_rel, max(rel.values()), max(floored.values()))
    out["anchored"] = anchored(grads["f32"], grads["f64"])
    assert out["f32"][2] < BOUND, out["f32"]
    assert out["f64"][1] < BOUND_F64, out["f64"]
    print(f"OK: {impl} step's grads match plain-step grads (f32 floored "
          f"{out['f32'][2]:.2e} < {BOUND}, f64 {out['f64'][1]:.2e} < "
          f"{BOUND_F64})", flush=True)
    return dict(impl=impl, **out)


def main(argv=None):
    _, dev = device_from(sys.argv[1:] if argv is None else argv)
    run(device=dev)


if __name__ == "__main__":
    main()
