"""PyTorch port: the root entry point's twin, scheme_raytrace_torch/entry.py
(CPU).

  * `entry()`'s fn against `__graft_entry__.entry()`'s fn on the same
    arguments: in f64 (scene and camera built from the JAX package's
    numpy arrays, under jax_enable_x64) the image within 1e-9 and the same
    sample_count; in f32, each side's own flagship arguments, within
    tests/test_parity.py's bounds (mean |difference| < 5e-3, under 1% of
    pixels off by > 0.05);
  * `dryrun_multichip(2, device="cpu")` (two gloo processes) passes its
    assertions and prints the JAX line with finite losses;
  * without device="cpu", on a host with no card, `entry()` and
    `dryrun_multichip(n)` raise and name device="cpu";
  * importing `entry` and every tool of scheme_raytrace_torch/tools loads
    no `jax`, nothing of scheme_raytrace_tpu and nothing of tools/ (a
    fresh interpreter);
  * `parallel.distributed.spawn` takes "cpu" or "cuda" and refuses more
    ranks than cards.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import contextlib
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scheme_raytrace_tpu import render as j_render
from scheme_raytrace_tpu import scenes as j_scenes
from scheme_raytrace_tpu.config import RenderConfig as JConfig
from scheme_raytrace_tpu.scene import build as j_build
from scheme_raytrace_torch import entry
from scheme_raytrace_torch import render as t_render
from scheme_raytrace_torch.camera import CAMERA_FIELDS, camera_from_arrays
from scheme_raytrace_torch.config import RenderConfig as TConfig
from scheme_raytrace_torch.scene import build as t_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("bench_scenes", "bench_diff", "check_vjp_grads",
         "profile_diff_step", "profile_hotpath", "profile_scatter",
         "diag_fwdbwd_variance", "bench_bvh_crossover",
         "bench_material_sort", "bench_shard_overhead", "bench_scaling",
         "make_goldens")


@contextlib.contextmanager
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _graft_entry():
    sys.path.insert(0, ROOT)
    import __graft_entry__
    return __graft_entry__


def test_entry_matches_jax_f64():
    g = _graft_entry()
    with x64():
        jfn, _ = g.entry()
        spec = j_scenes.cornell_box()
        js = j_build.compile_scene(spec.objects, sky=spec.sky,
                                   dtype=jnp.float64)
        jc = spec.camera(dtype=jnp.float64, aspect=1.0)
        jcfg = JConfig(nx=64, ny=64, spp=1, max_depth=8, dtype="f64")
        want = jax.jit(jfn)(js, jc, j_render.init_state(jcfg))
        want_raw = np.asarray(want.raw_sum)
        want_count = int(want.sample_count)
    ts = t_build.scene_from_arrays(
        {f: np.asarray(getattr(js, f)) for f in j_build._DATA_FIELDS},
        {f: getattr(js, f) for f in j_build._META_FIELDS},
        dtype=torch.float64, device="cpu")
    tc = camera_from_arrays({k: np.asarray(getattr(jc, k))
                             for k in CAMERA_FIELDS}, dtype=torch.float64,
                            device="cpu")
    tfn, (_, _, state) = entry.entry(device="cpu")
    got = tfn(ts, tc, t_render.init_state(
        TConfig(nx=64, ny=64, dtype="f64"), device="cpu"))
    assert state.raw_sum.shape == (64, 64, 3)
    assert got.raw_sum.dtype == torch.float64
    np.testing.assert_allclose(got.raw_sum.numpy(), want_raw, rtol=1e-9,
                               atol=1e-9)
    assert int(got.sample_count) == want_count == 1
    assert want_raw.max() > 0.0


def test_entry_matches_jax_f32():
    g = _graft_entry()
    jfn, jargs = g.entry()
    want = np.asarray(jax.jit(jfn)(*jargs).raw_sum)
    tfn, targs = entry.entry(device="cpu")
    out = tfn(*targs)
    got = out.raw_sum.numpy()
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (64, 64, 3)
    assert np.isfinite(got).all() and int(out.sample_count) == 1
    diff = np.abs(got.astype(np.float64) - want)
    assert diff.mean() < 5e-3, diff.mean()
    assert (diff.max(axis=-1) > 0.05).mean() < 0.01


def test_dryrun_multichip_on_cpu(capsys):
    loss, loss_f = entry.dryrun_multichip(2, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    m = re.fullmatch(r"dryrun_multichip\(2\): ok, loss=(\S+), "
                     r"fused loss=(\S+)", line)
    assert m, line
    assert np.isfinite([float(m[1]), float(m[2])]).all()
    assert (float(m[1]), float(m[2])) == (round(loss, 6), round(loss_f, 6))
    assert loss > 0.0 and loss_f > 0.0


@pytest.mark.parametrize("call", [
    lambda: entry.entry(),
    lambda: entry.dryrun_multichip(1),
    lambda: entry.dryrun_multichip(2),
], ids=["entry", "dryrun-1", "dryrun-2"])
def test_no_card_raises_and_names_cpu(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call()


def test_imports_load_no_jax():
    mods = ["scheme_raytrace_torch.entry"] + [
        f"scheme_raytrace_torch.tools.{t}" for t in TOOLS]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'scheme_raytrace_tpu', 'tools', "
        "'__graft_entry__')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_spawn_takes_cpu_or_the_cards(monkeypatch):
    from scheme_raytrace_torch.parallel import distributed as pdist
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        pdist.spawn(entry._dryrun_rank, 1, 1, device="tpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="0 CUDA devices"):
        pdist.spawn(entry._dryrun_rank, 2, 2, device="cuda")
