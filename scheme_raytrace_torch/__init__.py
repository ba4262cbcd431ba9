"""PyTorch / CUDA port of scheme_raytrace_tpu.

Same module layout and names as the JAX package, which stays the reference
the port is held against (tests/test_torch_*.py).  Tensors on a CUDA device
run the hand-written kernels under csrc/; tensors on the CPU run the plain
PyTorch version of each kernel.  This package never imports JAX.

Covered so far: the forward render of every scene of `scenes.SCENES`
through the fused regeneration pool (kernel K1 on the card) or, for what the
fused bounce does not take (BVH traversal, russian roulette, material sort,
more than 4,096 prims), the general pool in plain PyTorch; the fwd+bwd step
of `integrator/diff_fused.py`; the strided pools; the differentiable
wavefront path (`render.render_pass`, `config.differentiable`, threefry
keys) with its parity harness (`parity.py`) and checks (`utils/checks.py`).
Not yet: the sharded pools, the CLI and the viewer.
"""

from .config import RenderConfig  # noqa: F401
