"""PyTorch port: scheme_raytrace_torch/bench.py, the root bench.py's twin
(CPU).

  * (a) `_measure_forward` on Cornell 16x16 spp1 depth 100 in float64
    returns the root bench.py's segment count on the JAX scene and config
    exactly, and its logged warm-up render (from zeros) has the JAX
    `render_with_stats`' segments and iterations;
  * (b) `_measure_fwd_bwd` the same way: `calibrate_iters(slack=1.1)`
    gives JAX's n_iters, the step JAX's segments, both logged as JAX logs
    them;
  * (c) `main(["--cpu"])` prints a last line that parses, with every key
    of bench.py's `json.dumps` dict (read from its source with `ast`) and
    "card";
  * (d) with no CUDA device and no `--cpu`, `main([])` raises;
  * (e) a trip count too small to drain makes `_measure_fwd_bwd` raise;
  * (f) importing the twin loads neither JAX nor the JAX package nor the
    root bench.py.

The root bench.py is loaded as a module from its file (its __main__ block
does not run); the log lines and bench.py's keys are read by chip_smoke.py's
`bench_line` and `bench_keys`, as its `bench` phase reads them on the card.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import importlib.util
import json
import os
import subprocess
import sys

import chip_smoke
import jax
import jax.numpy as jnp
import pytest
import torch

from scheme_raytrace_tpu import render as j_render
from scheme_raytrace_tpu import scenes as j_scenes
from scheme_raytrace_tpu.config import RenderConfig as JConfig
from scheme_raytrace_tpu.scene import build as j_build
from scheme_raytrace_torch import bench
from scheme_raytrace_torch.config import RenderConfig as TConfig
from scheme_raytrace_torch.integrator import diff_fused
from scheme_raytrace_torch.tools.common import cornell

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_PY = os.path.join(ROOT, "bench.py")
CPU = "cpu"
# Cornell light-sampled at the bench's depth cap, cut to 16x16 spp1
SMALL = dict(nx=16, ny=16, spp=1, max_depth=100, light_sampling=True,
             seed=0, dtype="f64")


def _jax_bench():
    """The root bench.py as a module."""
    spec = importlib.util.spec_from_file_location("jax_root_bench", BENCH_PY)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_cornell():
    spec = j_scenes.cornell_box()
    scene = j_build.compile_scene(spec.objects, sky=spec.sky,
                                  dtype=jnp.float64)
    return scene, spec.camera(dtype=jnp.float64, aspect=1.0)


class _X64:
    """jax_enable_x64 for an f64 block, restored on exit."""

    def __enter__(self):
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        jax.config.update("jax_enable_x64", False)


def test_forward_matches_root_bench(capsys):
    jb = _jax_bench()
    with _X64():
        j_scene, j_cam = _jax_cornell()
        jcfg = JConfig(**SMALL)
        _, j_segs = jb._measure_forward(j_scene, j_cam, jcfg)
        _, w_segs, w_iters = j_render.render_with_stats(
            j_scene, j_cam, jcfg, j_render.init_state(jcfg))
        w_segs, w_iters = int(w_segs), int(w_iters)
    j_log = chip_smoke.bench_line(capsys.readouterr().err, "fwd")

    scene, cam = cornell(CPU, torch.float64)
    rate, segs = bench._measure_forward(scene, cam, TConfig(**SMALL))
    t_log = chip_smoke.bench_line(capsys.readouterr().err, "fwd")
    assert rate > 0
    assert segs == j_segs == j_log["segs"] == t_log["segs"]
    # the last render's iterations, and the warm-up's from zeros
    assert t_log["iters"] == j_log["iters"]
    assert t_log["warm"] == (w_segs, w_iters)
    assert len(t_log["times"]) == bench.N_TIMED == 5


def test_fwd_bwd_matches_root_bench(capsys):
    jb = _jax_bench()
    with _X64():
        j_scene, j_cam = _jax_cornell()
        _, j_segs = jb._measure_fwd_bwd(j_scene, j_cam, JConfig(**SMALL))
    # n_iters as the JAX bench calibrated it (slack 1.1)
    j_log = chip_smoke.bench_line(capsys.readouterr().err, "fwd+bwd")

    scene, cam = cornell(CPU, torch.float64)
    cfg = TConfig(**SMALL)
    assert (diff_fused.calibrate_iters(scene, cam, cfg, slack=1.1)
            == j_log["n_iters"])
    rate, segs = bench._measure_fwd_bwd(scene, cam, cfg)
    t_log = chip_smoke.bench_line(capsys.readouterr().err, "fwd+bwd")
    assert rate > 0
    assert segs == j_segs == t_log["segs"] == j_log["segs"]
    assert t_log["n_iters"] == j_log["n_iters"]


def test_main_cpu_prints_bench_keys(capsys):
    bench.main(["--cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    keys = chip_smoke.bench_keys()        # bench.py's, read with ast
    assert len(keys) == 11 and "fwd_1024_rays_per_s" in keys
    assert list(out) == keys and keys[-1] == "card"
    assert out["metric"] == "rays/s (path segments, Cornell 64x64, CPU)"
    assert out["unit"] == "rays/s" and out["card"] == "CPU"
    assert out["value"] > 0 and out["fwd_bwd_rays_per_s"] > 0
    assert out["vs_baseline"] == pytest.approx(out["value"] / 1.25e7)
    assert out["fwd_bwd_workload"] == "64x64 spp1 depth100"
    assert out["step_impl"] == out["fwd_bwd_step_impl"] == "plain"
    assert out["fwd_1024_rays_per_s"] is None and out["n_chips"] == 1


def test_main_without_card_or_cpu_raises(monkeypatch):
    # no card here or not: the test takes the card away itself
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        bench.main([])


def test_undrained_step_raises(monkeypatch):
    # 16x16 spp4: 1,024 paths over 256 lanes need more than the 8
    # iterations of one block
    scene, cam = cornell(CPU)
    cfg = TConfig(**dict(SMALL, spp=4, dtype="f32"))
    monkeypatch.setattr(diff_fused, "calibrate_iters", lambda *a, **k: 1)
    with pytest.raises(RuntimeError, match="did not drain"):
        bench._measure_fwd_bwd(scene, cam, cfg)


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import scheme_raytrace_torch.bench\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'scheme_raytrace_tpu', 'bench', 'tools', "
        "'__graft_entry__')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
