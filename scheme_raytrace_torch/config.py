"""Render configuration of the PyTorch port.

The port keeps its own `RenderConfig` rather than importing
scheme_raytrace_tpu.config: the fields, defaults and numeric constants are
the same (tests/test_torch_host.py holds them equal), but the tuned values
that came from TPU sweeps — `resolve_pool_rays` first — are to be re-swept
on the GPU, and that happens here without touching the JAX package.

Differences from the JAX config:
  * `jnp_dtype` becomes `torch_dtype`;
  * `use_pallas` is dropped: the device of the tensors picks the step
    implementation (CUDA kernel for CUDA tensors, plain PyTorch on the CPU);
  * `resolve_device` is the one place that turns an entry point's
    `device=None` into the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# Numerical-constants ledger (SURVEY.md §6.4), reproduced as named config
# defaults; values equal scheme_raytrace_tpu/config.py's.
BIG = 999999999999.0          # constant.scm:6 (+max-float+)
SHADOW_EPS = 0.001            # main.scm:104 (t_min of every scattered ray)
RECT_PAD = 0.0001             # geometry.scm:391,410,429 (rect AABB thickness)
MEDIUM_REHIT_EPS = 0.0001     # geometry.scm:553 (re-probe offset)
KLEIN_MAX_STEPS = 100         # geometry.scm:635
KLEIN_ITERATIONS = 10         # geometry.scm:610-620
KLEIN_SURF_EPS = 0.001        # geometry.scm:656
KLEIN_NORMAL_H = 0.01         # geometry.scm:627-632
KLEIN_DE_SCALE = 0.7          # geometry.scm:607,621
KLEIN_R = 125.0               # geometry.scm:600
KLEIN_SPHERE_R = 300.0        # geometry.scm:590-598
SAH_T_TRI = 1.0               # geometry.scm:297
SAH_T_AABB = 1.0              # geometry.scm:298
GAMMA_QUANT = 255.99          # main.scm:463


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds its tensors on.

    `None` means the current CUDA card: the port runs on the card unless the
    caller asks for the CPU.  Where no CUDA device is present it raises
    rather than carry on on the CPU by itself; `device="cpu"` is the request
    for the plain PyTorch path."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available and no device was named: the port "
            "runs on the card by default; pass device=\"cpu\" to run its "
            "plain PyTorch path on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static rendering configuration (hashable Python scalars only)."""

    nx: int = 200                 # image width  (main.scm:126)
    ny: int = 200                 # image height (main.scm:127)
    spp: int = 16                 # samples per pixel per render() call
    max_depth: int = 100          # bounce cap (main.scm:26)
    seed: int = 0
    # Integrator options
    light_sampling: bool = False  # mixture cosine/light PDF (pdf.scm intent, B5)
    russian_roulette: bool = False  # OFF for parity (SURVEY §7.3 item 3)
    rr_start_depth: int = 4
    # "brute" masked sweep or "bvh" traversal (general pool; needs a scene
    # compiled with bvh=, else it brute-forces)
    traversal: str = "brute"
    # Reverse-mode path: the wavefront's fixed-length scan
    # (integrator/wavefront.py, render.render / render_pass)
    differentiable: bool = False
    # Regeneration-pool size cap (lanes in flight).  None = AUTO.  The auto
    # values are still the JAX package's TPU sweep optima (64k forward, 24k
    # reverse); an H100 sweep replaces them here.
    pool_rays: Optional[int] = None

    def resolve_pool_rays(self, reverse: bool = False) -> int:
        if self.pool_rays is not None:
            return self.pool_rays
        return (24 if reverse else 64) * 1024
    # Precision of the compute path: "f32" or "f64" (the CPU oracle)
    dtype: str = "f32"
    # Bezier intersection: seed samples and Newton steps
    bezier_seeds: int = 32
    bezier_newton: int = 8
    # Material-sorted shading for the general pool (bit-identical to masked)
    material_sort: bool = False

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    @property
    def n_pixels(self) -> int:
        return self.nx * self.ny

    @property
    def torch_dtype(self) -> torch.dtype:
        if self.dtype not in ("f32", "f64"):
            raise ValueError(f"dtype must be 'f32' or 'f64', got {self.dtype!r}")
        return torch.float64 if self.dtype == "f64" else torch.float32
