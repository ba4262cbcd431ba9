"""PyTorch port, the kernel probes against the JAX package's tools.

  * K5, the op probe: `tools/probe_ops.probe_plain` against the body of
    tools/probe_pallas_ops.py (`kernel`) run through `pl.pallas_call` in
    interpret mode, on the tool's own inputs and on random int32 items
    (negative ones included): outputs that come from the int path exactly,
    the transcendental ones within 2e-6 relative (sin, cos and pow are
    rounded differently by XLA and PyTorch); the probe's extension (the
    operations of the textures and the media, which the JAX tool does not
    have) against numpy: the floor and hash rows exactly, log, atan2 and
    rsqrt within 2e-6 relative;
  * K6, the loop probes: each `tools/probe_loops.CASES` function against the
    jnp case of tools/repro_mosaic_crash.py, bitwise.  The JAX cases run op
    by op (`jax.disable_jit`): compiled, XLA's CPU compiler contracts
    a * c + b into an FMA, where PyTorch (and the CUDA kernel, with
    __fmul_rn / __fadd_rn) rounds the product and the sum apart, and a mask
    such as a * a < 4 then flips on some lanes.

    The extension cases (`EXT_CASES`: the bezier probe's and the klein
    march's loop forms, which the JAX tool does not have) are held against
    the same loops in numpy float32, bitwise.

    The one launch of every case (`loops_cuda_all`, `which` = -1) writes a
    row a case in the order of csrc/probe_loops.cu's Case enum:
    `all_cases_plain` stacks the plain versions in that order.  Its blocks
    of 128 threads take the early-exit loop's any() over 128 elements: the
    plain loop with its any() over groups of 128, of 256 and over the whole
    array gives the same values bitwise, and equals the JAX case.

The CUDA kernels run only on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import importlib.util
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from scheme_raytrace_torch.tools import probe_loops, probe_ops
from scheme_raytrace_torch.utils import telemetry


def launches(kernel):
    """The process's launches of one kernel so far (utils/telemetry)."""
    return telemetry.counter(f"launches.{kernel}")


ROOT = pathlib.Path(__file__).resolve().parent.parent
TOOLS = ROOT / "tools"
LOOPS_CU = ROOT / "scheme_raytrace_torch" / "csrc" / "probe_loops.cu"


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"_tool_{name}",
                                                  TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def repro():
    return _tool("repro_mosaic_crash")


def _pallas_probe(pack, item):
    kernel = _tool("probe_pallas_ops").kernel
    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(item.shape, jnp.float32),
        in_specs=[vmem, vmem], out_specs=vmem, interpret=True)(
            jnp.asarray(pack), jnp.asarray(item)))


@pytest.mark.parametrize("items", ["tool", "random"])
def test_probe_ops_matches_pallas_interpret(items):
    pack, item = probe_ops.inputs("cpu")
    if items == "random":
        r = np.random.default_rng(0)
        item = torch.as_tensor(r.integers(-2 ** 31, 2 ** 31, (8, 128),
                                          dtype=np.int64).astype(np.int32))
    want = _pallas_probe(pack.numpy(), item.numpy())
    got, ext = (x.numpy() for x in probe_ops.probe(pack, item))
    assert np.isfinite(got).all() and np.isfinite(ext).all()
    # the select's int branch: pix's x coordinate, exact
    u_small = want != np.round(want)
    assert u_small.any() and (~u_small).any()
    np.testing.assert_array_equal(got[~u_small], want[~u_small])
    np.testing.assert_allclose(got[u_small], want[u_small], rtol=2e-6)


def test_probe_ops_extension_matches_numpy():
    r = np.random.default_rng(1)
    item = r.integers(-2 ** 31, 2 ** 31, (8, 128), dtype=np.int64).astype(
        np.int32)
    pack, _ = probe_ops.inputs("cpu")
    ext = probe_ops.probe(pack, torch.as_tensor(item))[1].numpy()
    assert ext.shape == (len(probe_ops.EXT_ROWS), 8, 128)
    # the probe's uniform, in numpy uint64 arithmetic
    pix = item.astype(np.int64) % 40000
    m32 = np.uint64(0xFFFFFFFF)
    lcg = lambda v: (v * np.uint64(1664525) + np.uint64(1013904223)) & m32
    a = lcg(item.astype(np.int64).astype(np.uint64) & m32)
    b = lcg((pix // 200 + 1).astype(np.uint64))
    a = (a + ((b * a) & m32)) & m32
    a = a ^ (a >> np.uint64(16))
    u = (a >> np.uint64(8)).astype(np.float32) * np.float32(2.0 ** -24)
    x = (u - np.float32(0.5)) * np.float32(37.5)
    fl = np.floor(x)
    assert (fl < 0).any() and (fl > 0).any()
    h = lcg(fl.astype(np.int64).astype(np.uint64) & m32)
    h = h ^ (h >> np.uint64(16))
    v = (h >> np.uint64(8)).astype(np.float32) * np.float32(2.0 ** -24)
    np.testing.assert_array_equal(ext[0], fl)
    np.testing.assert_array_equal(ext[1], v)
    tiny = np.finfo(np.float32).tiny
    for row, want in ((2, np.log(np.maximum(u, tiny).astype(np.float64))),
                      (3, np.arctan2(x.astype(np.float64),
                                     (u - np.float32(0.25)).astype(np.float64))),
                      (4, 1.0 / np.sqrt((u + np.float32(0.25)).astype(
                          np.float64)))):
        np.testing.assert_allclose(ext[row], want, rtol=2e-6, atol=1e-7,
                                   err_msg=probe_ops.EXT_ROWS[row])


@pytest.mark.parametrize("name", list(probe_loops.CASES))
def test_probe_loops_match_jax_cases(repro, name):
    assert list(probe_loops.CASES) == list(repro.CASES)
    x = probe_loops.inputs(seed=1, device="cpu")
    with jax.disable_jit():
        want = np.asarray(repro.CASES[name](jnp.asarray(x.numpy())))
    got = probe_loops.loops(name, x)
    assert got.shape == probe_loops.SHAPE and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_probe_loops_extension_matches_numpy():
    # the nine cases stay case for case; the extension follows them
    assert list(probe_loops.ALL_CASES) == [*probe_loops.CASES,
                                           "bezier_seeds", "klein_march"]
    x = probe_loops.inputs(seed=3, device="cpu")
    f = np.float32
    a = x.numpy() * f(0.25)
    best = np.full(a.shape, f(100.0))
    K, N = probe_loops.BEZ_SEEDS, probe_loops.BEZ_NEWTON
    for k in range(K):
        s = np.full(a.shape, f((k + 0.5) / K))
        for _ in range(N):
            cx, cy, cx1 = s * s - a, (s - f(0.5)) * f(0.5), s * f(2.0)
            dg = (cx * cx1 + cy * f(0.5)) * f(2.0)
            d2g = (cx1 * cx1 + f(0.25)) * f(2.0) + cx * f(4.0)
            curved = d2g > f(1e-12)
            step = np.where(curved, dg / np.where(curved, d2g, f(1e-12)),
                            f(0.0))
            s = np.clip(s - step, f(0.0), f(1.0))
        cx, cy = s * s - a, (s - f(0.5)) * f(0.5)
        g = cx * cx + cy * cy
        best = np.minimum(best, np.where(g < f(0.04), f(1.0) + s, f(100.0)))
    got = probe_loops.loops("bezier_seeds", x)
    assert got.dtype == torch.float32 and best.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), best)
    hit = best < 100.0
    assert 0.3 < hit.mean() < 0.8 and len(np.unique(best[hit])) > 1000
    cases, ext = probe_loops.main("cpu")
    assert list(cases) == list(probe_loops.CASES) and all(cases.values())
    assert ext == {"bezier_seeds": True, "klein_march": True}


def test_probe_loops_klein_march_matches_numpy():
    # the march as the kernel's lane runs it, in numpy float32 with a mask a
    # lane: the lane leaves the inner loop when its point escapes both
    # spheres, and the march when it accepts, sticks or passes 6
    x = probe_loops.inputs(seed=4, device="cpu").numpy()
    f = np.float32
    r2, tiny = f(probe_loops.KLEIN_R2), np.finfo(np.float32).tiny
    length = np.zeros_like(x)
    out = np.full_like(x, f(100.0))
    live = np.ones(x.shape, bool)
    for _ in range(probe_loops.KLEIN_STEPS):
        p, dr = x + length, np.ones_like(x)
        inner = live.copy()
        for _ in range(probe_loops.KLEIN_ITERS):
            found = np.zeros_like(inner)
            for s in probe_loops.KLEIN_SPHERES:
                q = p - f(s)
                q2 = q * q
                sel = inner & ~found & (q2 < r2)
                sc = r2 / np.maximum(q2, tiny)
                p = np.where(sel, q * sc + f(s), p)
                with np.errstate(over="ignore"):   # dr may overflow to inf
                    dr = np.where(sel, dr * sc, dr)
                found |= sel
            inner &= found
        dist = (np.abs(p) - f(0.3)) * f(0.5) / np.abs(dr)
        new_len = length + dist
        accept = live & (dist < f(1e-3)) & (new_len > f(1e-3))
        out = np.where(accept, new_len, out)
        stuck = (dist <= 0) & (length <= f(1e-3))
        length = np.where(live, new_len, length)
        live &= ~(accept | stuck | (x + length > f(6.0)))
    got = probe_loops.loops("klein_march", probe_loops.inputs(seed=4,
                                                               device="cpu"))
    assert got.dtype == torch.float32 and out.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), out)
    hit = out < 100.0
    assert 0.3 < hit.mean() < 0.9 and len(np.unique(out[hit])) > 1000


def test_probe_wrappers_take_cuda_tensors_only():
    before = launches("K5"), launches("K6")
    with pytest.raises(ValueError, match="CUDA"):
        probe_ops.probe_cuda(*probe_ops.inputs("cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        probe_loops.loops_cuda("fori", probe_loops.inputs(device="cpu"))
    with pytest.raises(KeyError, match="no loop case"):
        probe_loops.loops_cuda("nope", probe_loops.inputs(device="cpu"))
    assert (launches("K5"), launches("K6")) == before


def test_all_cases_rows_follow_the_case_enum():
    # the rows that `which` = -1 writes are the Case enum's order; the one
    # launch's issue order is a permutation of it
    src = LOOPS_CU.read_text()
    enum = re.search(r"enum Case \{(.*?)\};", src, re.S).group(1)
    enum = re.sub(r"//[^\n]*", "", enum)
    names = [n.strip() for n in enum.split(",") if n.strip()]
    assert names[-1] == "N_CASES"
    assert [n.lower() for n in names[:-1]] == list(probe_loops.ALL_CASES)
    order = re.search(r"kIssueOrder\[N_CASES\] = \{(.*?)\};", src,
                      re.S).group(1)
    assert sorted(n.strip() for n in order.split(",")) == sorted(names[:-1])
    x = probe_loops.inputs(seed=5, device="cpu")
    rows = probe_loops.all_cases_plain(x)
    assert rows.shape == (len(probe_loops.ALL_CASES), *probe_loops.SHAPE)
    for row, f in zip(rows, probe_loops.ALL_CASES.values()):
        assert torch.equal(row, f(x))
    assert torch.equal(probe_loops.loops_all(x), rows)


def _while_any_trips(x):
    """Iterations the early-exit loop runs on x with one any() over all of
    it."""
    a, done, k = x, torch.zeros_like(x, dtype=torch.bool), 0
    while k < 100 and not bool(done.all()):
        a2 = a * 1.3 + 0.1
        done = done | (a2 > 100.0)
        a = torch.where(done, a, a2)
        k += 1
    return k


@pytest.mark.parametrize("inputs", ["tool", "random"])
def test_while_any_grouping_gives_the_same_values(repro, inputs):
    if inputs == "tool":
        x = probe_loops.inputs(seed=0, device="cpu")
    else:
        # half the rows (groups of 128) above the fixed point -1/3: each
        # such group is done in fewer than 100 iterations, while a mixed
        # row keeps its group, and the whole array, at 100
        r = np.random.default_rng(6)
        x = r.uniform(-3.0, 3.0, probe_loops.SHAPE)
        x[::2] = r.uniform(-0.3, 60.0, (probe_loops.SHAPE[0] // 2,
                                        probe_loops.SHAPE[1]))
        x = torch.as_tensor(x.astype(np.float32))
        trips = [_while_any_trips(row) for row in x]
        assert max(trips[::2]) < 100 and min(trips[1::2]) == 100
        assert len(set(trips[::2])) > 1
    whole = probe_loops.case_while_any(x)
    for group in (128, 256):
        assert torch.equal(probe_loops.case_while_any(x, group), whole)
    with jax.disable_jit():
        want = np.asarray(repro.CASES["while_any"](jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(whole.numpy(), want)


def test_one_launch_and_launch_floor_take_cuda_tensors_only():
    before = launches("K5"), launches("K6")
    with pytest.raises(ValueError, match="CUDA"):
        probe_loops.loops_cuda_all(probe_loops.inputs(device="cpu"))
    for floor in (probe_ops.empty_cuda, probe_ops.copy_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            floor(*probe_ops.inputs("cpu"))
    assert (launches("K5"), launches("K6")) == before
