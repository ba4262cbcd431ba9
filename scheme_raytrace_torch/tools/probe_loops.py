"""Loop-form probes: the port of tools/repro_mosaic_crash.py (K6).

The nine loop forms of the JAX repro (repro_mosaic_crash.py:29-123) on a
(64, 128) float32 array: counted and nested counted loops, a five-value
carry under a mask, the forward-mode tangent of a loop (carried by hand),
float and bool carries, a bool carried as an int, and an early-exit while
loop under a cross-lane any().  CASES holds the plain PyTorch versions, in
the reference's order.  EXT_CASES holds the port's extension, which the JAX
tool does not have: the loop form of the bezier probe (a loop over seeds,
each a fixed count of guarded, clipped Newton steps, an accept test and a
running minimum) and that of the klein march (a bounded sphere trace with
per-lane retirement around an inner inversion loop that a lane leaves when
its point escapes).  `loops_cuda(name, x)` runs one case through
csrc/probe_loops.cu, `loops_cuda_all(x)` every case in one launch (a row a
case, in ALL_CASES' order, as `all_cases_plain(x)` stacks the plain
versions); both are bitwise equal to the plain versions (the kernel rounds
each product and sum on its own).  `main` takes the one launch and returns
the two groups' results side by side, (cases, ext).  On the card:

    python -c "from scheme_raytrace_torch.tools import probe_loops; \\
               print(probe_loops.main())"
"""

from __future__ import annotations

import ctypes

import torch

from ..config import resolve_device
from ..utils import telemetry

SHAPE = (64, 128)

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


def case_while_any(x, group=None):
    """The early-exit loop under a cross-lane any().  `group` (an int) takes
    the any() over each run of `group` consecutive elements of the flattened
    array on its own, as the kernel's blocks do; None, over the whole array,
    as the JAX tool's jnp.any.  Every grouping gives the same values: an
    element not yet done keeps its group iterating, a done one is frozen."""
    if group is not None:
        return torch.cat([case_while_any(part) for part in
                          x.reshape(-1).split(group)]).reshape(x.shape)
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


# The klein loop form's march steps, inversions a step at most, inversion
# spheres (centre, r^2) and distance-estimate constants (csrc/probe_loops.cu
# kKlSteps, kKlIters).
KLEIN_STEPS = 40
KLEIN_ITERS = 6
KLEIN_SPHERES = (-1.0, 2.0)
KLEIN_R2 = 0.36


def ext_klein_march(x, stats=None):
    """The klein march's loop form (integrator/bounce.py _klein_march) on a
    line: from x, step along +1 by a distance estimate that up to KLEIN_ITERS
    inversions in two spheres (the first whose interior holds the point)
    scale, 0.5 (|P| - 0.3) / |dr|; a lane accepts where the estimate falls
    under 1e-3 past 1e-3 (its distance is the result), and retires
    backward-stuck (an estimate <= 0 at a distance <= 1e-3) or past 6; 100
    for a lane that never accepts.  The loop form of the JAX step's, masks and
    all; the kernel's lane leaves each loop when it is done.  `stats` (a
    dict), if given, counts the steps and the inversions of the lanes still
    marching."""
    tiny = torch.finfo(x.dtype).tiny
    length = torch.zeros_like(x)
    out = torch.full_like(x, 100.0)
    done = torch.zeros_like(x, dtype=torch.bool)
    for _ in range(KLEIN_STEPS):
        if bool(done.all()):
            break
        if stats is not None:
            stats["steps"] += int((~done).sum())
        p, dr = x + length, torch.ones_like(x)
        active = torch.ones_like(done)
        for _ in range(KLEIN_ITERS):
            found = torch.zeros_like(done)
            for s in KLEIN_SPHERES:
                q = p - s
                q2 = q * q
                sel = active & ~found & (q2 < KLEIN_R2)
                scale = x.new_tensor(KLEIN_R2) / torch.maximum(
                    q2, x.new_tensor(tiny))
                p = torch.where(sel, q * scale + s, p)
                dr = torch.where(sel, dr * scale, dr)
                found = found | sel
            active = active & found
            if stats is not None:
                stats["inversions"] += int((active & ~done).sum())
        dist = (torch.abs(p) - 0.3) * 0.5 / torch.abs(dr)
        new_len = length + dist
        accept = ~done & (dist < 1e-3) & (new_len > 1e-3)
        stuck = (dist <= 0.0) & (length <= 1e-3)
        out = torch.where(accept, new_len, out)
        length = torch.where(done, length, new_len)
        done = done | accept | stuck | (x + length > 6.0)
    return out


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


def _check(x, who):
    if x.device.type != "cuda":
        raise ValueError(f"{who} takes CUDA tensors, got {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{who}: a contiguous float32 tensor")


def _launch(x, out, which, what):
    """One launch of the kernel on x's device and current stream; raises if
    it is refused."""
    ptrs = (ctypes.c_void_p * 2)(x.data_ptr(), out.data_ptr())
    fn = _kernel()
    with torch.cuda.device(x.device):
        err = fn(ptrs, x.numel(), which,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"probe_loops kernel launch failed ({what}): CUDA "
                           f"error {err}")


def loops_cuda(name, x):
    """ALL_CASES[name] through csrc/probe_loops.cu: x a contiguous float32
    tensor on a CUDA device.  Returns a new tensor; raises for an unknown
    case or a refused launch.  A launch adds one to the process counter
    `launches.K6` (utils/telemetry)."""
    if name not in ALL_CASES:
        raise KeyError(f"no loop case {name!r}; cases: "
                       f"{', '.join(ALL_CASES)}")
    _check(x, "loops_cuda")
    out = torch.empty_like(x)
    _launch(x, out, list(ALL_CASES).index(name), name)
    telemetry.count("launches.K6")
    return out


def loops_cuda_all(x):
    """Every case of ALL_CASES through csrc/probe_loops.cu in one launch
    (`which` = -1): x a contiguous float32 tensor on a CUDA device.  Returns
    a new (len(ALL_CASES), *x.shape) tensor, a row a case in ALL_CASES'
    order; raises for a refused launch."""
    _check(x, "loops_cuda_all")
    out = torch.empty((len(ALL_CASES), *x.shape), dtype=x.dtype,
                      device=x.device)
    _launch(x, out, -1, "all cases")
    telemetry.count("launches.K6")
    return out


def all_cases_plain(x):
    """The plain versions of every case, stacked as loops_cuda_all's rows."""
    return torch.stack([f(x) for f in ALL_CASES.values()])


def loops(name, x):
    """ALL_CASES[name] on the tensor's device: the kernel on a card, the
    plain version on the CPU."""
    return (loops_cuda(name, x) if x.device.type == "cuda"
            else ALL_CASES[name](x))


def loops_all(x):
    """Every case on the tensor's device: the one launch on a card, the
    plain versions on the CPU."""
    return (loops_cuda_all(x) if x.device.type == "cuda"
            else all_cases_plain(x))


def main(device=None):
    """Every case, in one launch on a card, against its plain version: (the
    nine cases' results, the extension's)."""
    x = inputs(device=device)
    rows = dict(zip(ALL_CASES, loops_all(x)))
    same = lambda group: {n: bool(torch.equal(rows[n], f(x)))
                          for n, f in group.items()}
    return same(CASES), same(EXT_CASES)
