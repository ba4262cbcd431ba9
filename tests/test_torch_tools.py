"""PyTorch port: the instruments of scheme_raytrace_torch/tools (CPU).

  * `bench_bvh_crossover.grid_scene(n)`, n = 16 and 64, brute and SAH,
    compiles to the flat arrays and camera of the JAX tool's
    tools/bench_bvh_crossover.grid_scene(n) (imported as a module: none
    of its __main__ code runs);
  * `make_goldens` on config 1 into a temporary directory: the keys of
    tests/goldens/config1_three_spheres.npz, the image within 1e-9,
    grad_ad within 1e-9 and grad_fd within 1e-6 (relative, with
    tests/test_parity.py's scale floor);
  * each tool's main function at a tiny size (16^2, spp1, depth 2,
    m = 256) prints lines of the JAX tool's form, and its assertions hold
    (drained steps, finite numbers, identical fixed-params losses);
    `check_vjp_grads` also prints each leaf's f32 gradients of both routes
    against the f64 kernel route, finite, and equal on the CPU, where both
    routes are the plain step; `bench_flush` (no JAX twin) at 16^2 spp2,
    where m = 512 and g = 256, prints its JSON line with equal segments in
    the three pools, its flush counts whole blocks, and its counting
    wrappers are removed afterwards;
  * `pool_fused.LAST_STEP_IMPL` reads "plain" after CPU renders, forward
    and reverse, and `check_vjp_grads.plain_step` restores the pool's card
    steps;
  * `--cpu` names the CPU; without it and with no card a tool raises.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

from scheme_raytrace_tpu.scene import build as j_build
from scheme_raytrace_torch import render as t_render
from scheme_raytrace_torch.camera import CAMERA_FIELDS
from scheme_raytrace_torch.config import RenderConfig as TConfig
from scheme_raytrace_torch.integrator import (bounce, diff_fused, persist,
                                              pool_fused, pool_strided)
from scheme_raytrace_torch.tools import (bench_bvh_crossover, bench_diff,
                                         bench_flush, bench_material_sort,
                                         bench_scaling,
                                         bench_scenes, bench_shard_overhead,
                                         check_vjp_grads, common,
                                         diag_fwdbwd_variance, make_goldens,
                                         profile_diff_step, profile_hotpath,
                                         profile_scatter)
from scheme_raytrace_torch.tools.common import cornell

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "config1_three_spheres.npz")
CPU = "cpu"
NUM = r"-?[\d.]+(?:e[-+]\d+)?"


def _jax_tool(name):
    """A JAX tool of tools/ as a module (its __main__ block does not run)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(got, want):
    want = np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want), 0.05 * np.abs(want).max() + 1e-7)
    return np.abs(np.asarray(got) - want) / scale


@pytest.mark.parametrize("bvh", [None, "sah"], ids=["brute", "sah"])
@pytest.mark.parametrize("n", [16, 64])
def test_grid_scene_matches_jax(n, bvh):
    js, jc = _jax_tool("bench_bvh_crossover").grid_scene(n, bvh=bvh)
    ts, tc = bench_bvh_crossover.grid_scene(n, bvh=bvh, device=CPU)
    for f in j_build._DATA_FIELDS:
        want = np.asarray(getattr(js, f))
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      want.astype(getattr(ts, f).numpy()
                                                  .dtype), err_msg=f)
    for f in j_build._META_FIELDS:
        assert getattr(ts, f) == getattr(js, f), f
    for f in CAMERA_FIELDS:
        np.testing.assert_allclose(getattr(tc, f).numpy(),
                                   np.asarray(getattr(jc, f)), rtol=1e-6,
                                   err_msg=f)
    assert ts.sph_r.shape[0] == n + 1


def test_make_goldens_config1(tmp_path, capsys):
    make_goldens.main(["--out", str(tmp_path), "--only",
                       "config1_three_spheres"])
    got = np.load(tmp_path / "config1_three_spheres.npz")
    want = np.load(GOLDEN)
    assert sorted(got.files) == sorted(want.files)
    np.testing.assert_allclose(got["image"], want["image"], rtol=1e-9,
                               atol=1e-9)
    assert (_rel(got["grad_ad"], want["grad_ad"]) < 1e-9).all()
    assert (_rel(got["grad_fd"], want["grad_fd"]) < 1e-6).all()
    assert (_rel(got["grad_ad_big"], want["grad_ad_big"]) < 1e-9).all()
    assert list(got["probes"]) == list(want["probes"])
    assert str(got["nominal"]) == str(want["nominal"])
    out = capsys.readouterr().out
    assert "[config1_three_spheres] wrote " in out
    assert not (tmp_path / "config2_rtow_final.npz").exists()


def test_make_goldens_needs_out():
    with pytest.raises(SystemExit):
        make_goldens.main(["--only", "config1_three_spheres"])


# tool -> (its main function at 16^2 spp1 depth 2 m=256, the patterns its
# printed lines match in order)
TINY = {
    "bench_scenes": (
        lambda: bench_scenes.bench_one("cornell", 16, 1, CPU, 2, 256),
        [rf"cornell\s+impl=plain\s+{NUM}M rays/s \(\d+ segs, \d+ ms\)"]),
    "bench_diff": (
        lambda: bench_diff.run(16, 1, 256, CPU, 2, n_timed=2),
        [rf"calibrated n_iters=\d+ in {NUM}s",
         rf"compile\+warmup {NUM}s  leftover=0  segs=\d+",
         rf"mode=auto size=16 spp=1 m=256: {NUM}M rays/s \(times "
         rf"\['{NUM}', '{NUM}'\]\)"]),
    "check_vjp_grads": (
        lambda: check_vjp_grads.run(16, 1, 2, 256, CPU),
        [line for dt in ("f32", "f64") for line in (
            [rf"\[{dt}\] loss {NUM} {NUM} rel {NUM}"]
            + [rf"\w+\s+max\|g_plain\|={NUM}  rel_diff={NUM}  "
               rf"\(floored {NUM}\)"] * 35
            + [rf"\[{dt}\] worst rel {NUM} floored {NUM}"])]
        + [rf"\w+\s+max\|g_f64\|={NUM}  f32 kernel={NUM}  f32 plain={NUM}  "
           rf"kernel/plain={NUM}"] * 35
        + [rf"\[f32 vs f64\] worst kernel {NUM} plain {NUM}; kernel/plain "
           rf"at most {NUM} \(\w+\)"]
        + [rf"OK: plain step's grads match plain-step grads \(f32 floored "
           rf"{NUM} < 0.1, f64 {NUM} < 1e-09\)"]),
    "profile_diff_step": (
        lambda: profile_diff_step.run(256, 16, 1, 2, CPU, reps=1),
        [r"m=256 n_iters=\d+", r"segs=\d+ leftover=0"]
        + [rf"{w} fwd(\+bwd)?\s+{NUM} ms  \(\s*{NUM}M rays/s-equiv\)"
           for w in ("kernel", "kernel", "glue", "glue", "full", "full")]),
    "profile_hotpath": (
        lambda: profile_hotpath.run(16, 1, 2, 256, k=2, device=CPU),
        [r"device: cpu"]
        + [rf"\s*{re.escape(s)}: \s*{NUM} ms  \(\s*{NUM} Mrays/s "
           rf"equivalent\)  \[CPU wall\]" for s in (
               "rng (12 cols)", "camera regen", "scene_hit", "shade",
               "fb scatter-add", "body (hit+shade+scatter)")]),
    "profile_scatter": (
        lambda: profile_scatter.run(256, 256, k=2, device=CPU),
        [rf"\s*{re.escape(s)}: \s*{NUM} ms  \[CPU wall\]" for s in (
            "(a) scatter-add M rows", "(a2) scatter-add M/8 rows",
            "(a3) scatter-add sorted", "(b) one-hot seq C=32",
            "(b8) one-hot seq C=8", "(c) dense lane add",
            "(d) pool.flush_add_ M rows")]),
    "diag_fwdbwd_variance": (
        lambda: diag_fwdbwd_variance.run(2, 16, 1, 256, 2, CPU),
        [r"n_iters=\d+ segs=\d+"]
        + [rf"{m}\s+min\s+{NUM}ms \(\s*{NUM}M\) med\s+{NUM}ms \(\s*{NUM}M\) "
           rf"max\s+{NUM}ms  all \['\d+', '\d+'\]"
           for m in ("chained", "blocked", "fixed")]),
    "bench_bvh_crossover": (
        lambda: bench_bvh_crossover.run([16], CPU, 16, 1, 2, 256),
        [rf"n=\s+16  fused-brute\[plain\]:\s+{NUM}M  bvh-pool:\s+{NUM}M "
         r"rays/s"]),
    "bench_material_sort": (
        lambda: bench_material_sort.run(CPU, 16, 1, 2, 256),
        [rf"{s}\s+masked:\s+{NUM}M  sorted:\s+{NUM}M  ratio sorted/masked:"
         rf"\s+{NUM}" for s in ("test_scene", "rtow_final")]),
    "bench_shard_overhead": (
        lambda: bench_shard_overhead.run(size=16, spp=2, max_depth=2,
                                         device=CPU, n=1),
        [r"\{.*\}"]),
    "bench_scaling": (
        lambda: bench_scaling.run(CPU, n_dev=2, size=16, spp=1,
                                  pool_rays=256),
        [r"\{.*\}"]),
    "bench_flush": (
        lambda: bench_flush.run(16, 2, 1, CPU),
        [r"\{.*\}"]),
}


@pytest.mark.parametrize("name", list(TINY))
def test_tool_prints_the_jax_lines(name, capsys):
    fn, patterns = TINY[name]
    fn()
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.strip()]
    assert len(lines) == len(patterns), lines
    for line, pat in zip(lines, patterns):
        assert re.fullmatch(pat, line), (pat, line)
    if name == "check_vjp_grads":
        # the f64-anchored readings: finite, and on the CPU both f32 routes
        # are the plain step, so their errors are one
        read = [re.search(rf"=({NUM})  f32 kernel=({NUM})  f32 plain=({NUM})"
                          rf"  kernel/plain=({NUM})", ln).groups()
                for ln in lines if "f32 kernel=" in ln]
        assert len(read) == 35
        vals = np.array(read, dtype=float)
        assert np.isfinite(vals).all()
        np.testing.assert_array_equal(vals[:, 1], vals[:, 2])
        assert (vals[:, 3] == 1.0).all() and vals[:, 1].max() > 0
    if name == "bench_flush":
        # 16^2 spp2: m = 512, g = 256, so the ranked flush; the counting
        # wrappers are gone afterwards
        out = json.loads(lines[0])
        assert (out["m"], out["g"]) == (512, 256)
        assert list(out["pools"]) == ["fifo", "strided", "persistent"]
        segs = {p["segments"] for p in out["pools"].values()}
        assert len(segs) == 1 and segs.pop() > 0
        for pool_name, rows in (("strided", pool_strided.FLUSH_EVERY),
                                ("persistent", persist.CHUNK_T)):
            f = out["pools"][pool_name]["flush"]
            assert f["rows"] == f["calls"] * rows > 0
            assert f["kernels"] is None and f["host_ms"] > 0
            assert out["pools"][pool_name]["image_outside_1e-5"] == 0
        assert pool_strided.Framebuffer.add.__name__ == "add"
    if name in ("bench_shard_overhead", "bench_scaling"):
        out = json.loads(lines[0])
        if name == "bench_shard_overhead":
            assert set(out) == {
                "workload", "fwd_sharded_over_unsharded_time",
                "train_sharded_over_unsharded_time", "drain_tail_occupancy",
                "drain_tail_efficiency_model", "note"}
            occ = out["drain_tail_occupancy"]
            assert list(occ) == ["1", "2", "4", "8"]
            assert all(0.0 < v <= 1.0 for v in occ.values())
            assert out["drain_tail_efficiency_model"]["1"] == 1.0
        else:
            assert out["n_devices"] == 2 and out["unit"] == "efficiency"
            assert out["rays_per_s_1dev"] > 0 and out["rays_per_s_ndev"] > 0
            assert out["value"] == pytest.approx(
                out["rays_per_s_ndev"] / (2 * out["rays_per_s_1dev"]))


def test_last_step_impl_reads_plain_on_cpu():
    pool_fused.LAST_STEP_IMPL.clear()
    scene, cam = cornell(CPU)
    cfg = TConfig(nx=16, ny=16, spp=1, max_depth=2, light_sampling=True,
                  pool_rays=256)
    t_render.render_with_stats(scene, cam, cfg,
                               t_render.init_state(cfg, device=CPU))
    assert pool_fused.LAST_STEP_IMPL == {"forward": "plain"}
    diff_fused.render_diff_fused(scene, cam, cfg, 16)
    assert pool_fused.LAST_STEP_IMPL == {"forward": "plain",
                                         "reverse": "plain"}
    assert pool_fused.pool_step(torch.device(CPU), True) is bounce.step


def test_plain_step_swaps_and_restores():
    saved = bounce.step_cuda, bounce.step_cuda_vjp
    with pytest.raises(KeyError):
        with check_vjp_grads.plain_step():
            assert bounce.step_cuda is bounce.step_cuda_vjp is bounce.step
            assert pool_fused.pool_step(torch.device("cuda"), True) \
                is bounce.step
            raise KeyError
    assert (bounce.step_cuda, bounce.step_cuda_vjp) == saved


def test_bench_diff_has_one_mode():
    with pytest.raises(SystemExit, match="auto"):
        bench_diff.main(["16", "1", "256", "jnp", "--cpu"])


def test_device_from(monkeypatch):
    args, dev = common.device_from(["--cpu", "8"])
    assert args == ["8"] and dev == torch.device(CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        common.device_from(["8"])
