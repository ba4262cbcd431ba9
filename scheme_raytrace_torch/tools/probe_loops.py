"""Loop-form probes: the port of tools/repro_mosaic_crash.py (K6).

The nine loop forms of the JAX repro (repro_mosaic_crash.py:29-123) on a
(64, 128) float32 array: counted and nested counted loops, a five-value
carry under a mask, the forward-mode tangent of a loop (carried by hand),
float and bool carries, a bool carried as an int, and an early-exit while
loop under a cross-lane any().  CASES holds the plain PyTorch versions, in
the reference's order; `loops_cuda(name, x)` runs csrc/probe_loops.cu, one
case per launch, bitwise equal to the plain version (the kernel rounds
each product and sum on its own).  On the card:

    python -c "from scheme_raytrace_torch.tools import probe_loops; \\
               print(probe_loops.main())"
"""

from __future__ import annotations

import ctypes

import torch

from ..config import resolve_device

SHAPE = (64, 128)

# Launches of the probe_loops kernel in this process.
LAUNCHES = 0


def case_fori(x):
    a = x
    for _ in range(100):
        a = a * 1.0001 + 0.1
    return a


def case_nested_fori(x):
    a = x
    for _ in range(100):
        for _ in range(10):
            a = a * 1.0001 + 0.1
    return a


def case_fori_carry5(x):
    a, b, c, d, e = x, x + 1, x + 2, x + 3, x > 0
    for _ in range(100):
        for _ in range(10):
            m = (a * a + b * b) < 4.0
            a = torch.where(m, a * 1.1 + 0.1, a)
            b = torch.where(m, b * 0.9, b)
            d = torch.where(m, d * 1.01, d)
            e = e & m
    return a + b + c + d + e.to(x.dtype)


def case_jvp_fori(x):
    # f(t) = fori(10, b -> b * t + 0.1, t) and its tangent at dt = 1:
    # d(b t) = db t + b dt
    t = x
    b, db = t, torch.ones_like(t)
    for _ in range(10):
        b, db = b * t + 0.1, db * t + b
    return b + db


def case_nested_float_carry(x):
    a, b = x, x + 1
    for _ in range(100):
        for _ in range(10):
            m = (a * a) < 4.0
            a, b = torch.where(m, a * 1.1, a), torch.where(m, b * 0.9, b)
    return a + b


def _bool_carry(a, e, outer):
    for _ in range(outer):
        for _ in range(10):
            m = (a * a) < 4.0
            a, e = torch.where(m, a * 1.1 + 0.1, a), e & m
    return a + e.to(a.dtype)


def case_single_bool_carry(x):
    return _bool_carry(x, x > 0, 1)


def case_nested_bool_carry(x):
    return _bool_carry(x, x > 0, 100)


def case_bool_carry_as_i32(x):
    a, e = x, (x > 0).to(torch.int32)
    for _ in range(10):
        m = (a * a) < 4.0
        a = torch.where(m, a * 1.1 + 0.1, a)
        e = ((e != 0) & m).to(torch.int32)
    return a + e.to(x.dtype)


def case_while_any(x):
    a = x
    done = torch.zeros_like(x, dtype=torch.int32)
    k = 0
    while k < 100 and bool((done == 0).any()):
        a2 = a * 1.3 + 0.1
        done = done | (a2 > 100.0).to(torch.int32)
        a = torch.where(done != 0, a, a2)
        k += 1
    return a


CASES = {n[5:]: f for n, f in list(globals().items())
         if n.startswith("case_")}


def inputs(seed=0, device=None):
    """A (64, 128) float32 input whose lanes take both sides of every mask
    (uniform in [-3, 3)), on `device` (None: the card)."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(SHAPE, generator=g, dtype=torch.float32) * 6.0 - 3.0
    return x.to(device)


def _kernel():
    from ..utils import cuda_build
    fn = cuda_build.load("probe_loops").srt_probe_loops
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def loops_cuda(name, x):
    """CASES[name] through csrc/probe_loops.cu: x a contiguous float32
    tensor on a CUDA device.  Returns a new tensor; raises for an unknown
    case or a refused launch."""
    global LAUNCHES
    if name not in CASES:
        raise KeyError(f"no loop case {name!r}; cases: {', '.join(CASES)}")
    if x.device.type != "cuda":
        raise ValueError(f"loops_cuda takes CUDA tensors, got {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("loops_cuda: a contiguous float32 tensor")
    out = torch.empty_like(x)
    ptrs = (ctypes.c_void_p * 2)(x.data_ptr(), out.data_ptr())
    fn = _kernel()
    with torch.cuda.device(x.device):
        err = fn(ptrs, x.numel(), list(CASES).index(name),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"probe_loops kernel launch failed ({name}): CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out


def loops(name, x):
    """CASES[name] on the tensor's device: the kernel on a card, the plain
    version on the CPU."""
    return loops_cuda(name, x) if x.device.type == "cuda" else CASES[name](x)


def main(device=None):
    x = inputs(device=device)
    return {n: bool(torch.equal(loops(n, x), CASES[n](x))) for n in CASES}
