"""Loop-form probes: the port of tools/repro_mosaic_crash.py (K6).

The nine loop forms of the JAX repro (repro_mosaic_crash.py:29-123) on a
(64, 128) float32 array: counted and nested counted loops, a five-value
carry under a mask, the forward-mode tangent of a loop (carried by hand),
float and bool carries, a bool carried as an int, and an early-exit while
loop under a cross-lane any().  CASES holds the plain PyTorch versions, in
the reference's order.  EXT_CASES holds the port's extension, which the JAX
tool does not have: the loop form of the bezier probe (a loop over seeds,
each a fixed count of guarded, clipped Newton steps, an accept test and a
running minimum).  `loops_cuda(name, x)` runs csrc/probe_loops.cu, one case
per launch, bitwise equal to the plain version (the kernel rounds each
product and sum on its own).  `main` returns the two groups' results side by
side, (cases, ext).  On the card:

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

# The extension's seeds and Newton steps a seed (csrc/probe_loops.cu
# kBezSeeds, kBezNewton).
BEZ_SEEDS = 8
BEZ_NEWTON = 4


def ext_bezier_seeds(x):
    """The bezier probe's loop form (integrator/bounce.py _bezier_hit): the
    curve c(s) = (s s - a, (s - 0.5) / 2) across a ray, a = x / 4; Newton on
    g'(s) = 0 for g = |c|^2 from BEZ_SEEDS fixed seeds, BEZ_NEWTON guarded
    and clipped steps each; the ribbon is hit where g < 0.04, at distance
    1 + s; the closest hit over the seeds, 100 for none."""
    a = x * 0.25
    best = torch.full_like(x, 100.0)
    for k in range(BEZ_SEEDS):
        s = torch.zeros_like(x) + (k + 0.5) * (1.0 / BEZ_SEEDS)
        for _ in range(BEZ_NEWTON):
            cx, cy, cx1 = s * s - a, (s - 0.5) * 0.5, s * 2.0
            dg = (cx * cx1 + cy * 0.5) * 2.0
            d2g = (cx1 * cx1 + 0.25) * 2.0 + cx * 4.0
            curved = d2g > 1e-12
            stepn = torch.where(curved, dg / torch.where(curved, d2g, 1e-12),
                                0.0)
            s = torch.clamp(s - stepn, 0.0, 1.0)
        cx, cy = s * s - a, (s - 0.5) * 0.5
        g = cx * cx + cy * cy
        best = torch.minimum(best, torch.where(g < 0.04, 1.0 + s, 100.0))
    return best


EXT_CASES = {n[4:]: f for n, f in list(globals().items())
             if n.startswith("ext_")}
ALL_CASES = {**CASES, **EXT_CASES}


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
    """ALL_CASES[name] through csrc/probe_loops.cu: x a contiguous float32
    tensor on a CUDA device.  Returns a new tensor; raises for an unknown
    case or a refused launch."""
    global LAUNCHES
    if name not in ALL_CASES:
        raise KeyError(f"no loop case {name!r}; cases: "
                       f"{', '.join(ALL_CASES)}")
    if x.device.type != "cuda":
        raise ValueError(f"loops_cuda takes CUDA tensors, got {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("loops_cuda: a contiguous float32 tensor")
    out = torch.empty_like(x)
    ptrs = (ctypes.c_void_p * 2)(x.data_ptr(), out.data_ptr())
    fn = _kernel()
    with torch.cuda.device(x.device):
        err = fn(ptrs, x.numel(), list(ALL_CASES).index(name),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"probe_loops kernel launch failed ({name}): CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out


def loops(name, x):
    """ALL_CASES[name] on the tensor's device: the kernel on a card, the
    plain version on the CPU."""
    return (loops_cuda(name, x) if x.device.type == "cuda"
            else ALL_CASES[name](x))


def main(device=None):
    """Every case against its plain version: (the nine cases' results, the
    extension's)."""
    x = inputs(device=device)
    same = lambda group: {n: bool(torch.equal(loops(n, x), f(x)))
                          for n, f in group.items()}
    return same(CASES), same(EXT_CASES)
