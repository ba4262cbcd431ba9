"""PyTorch port: the command line (python -m scheme_raytrace_torch)
against the JAX package's (CPU).

  * tests/test_cli.py's three cases with --cpu: `scenes` lists, `render`
    writes the PPM, the state and the progress lines, a resumed render
    equals the one-shot render's PPM;
  * a state saved by the JAX CLI resumed by the port's and the reverse:
    the .npz keys are shared, and each resumed image is within
    tests/test_parity.py's f32 bounds (MAE < 5e-3, < 1% of pixels off by
    more than 0.05) of the other package's one-shot render;
  * `probe` prints, per sample and on average, the JAX probe's radiance
    within 1e-5 (its threefry keys are bitwise JAX's);
  * `--profile` writes a torch.profiler trace.

The JAX runs take tests/test_cli.py's resume configuration, so its
compiled renders are shared through the persistent cache.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import re

import numpy as np
import pytest

from scheme_raytrace_tpu.__main__ import main as j_main
from scheme_raytrace_torch import scenes as t_scenes
from scheme_raytrace_torch.__main__ import main

COMMON = ["--scene", "three_spheres", "--nx", "8", "--ny", "8",
          "--max-depth", "3", "--chunk", "2", "--pool-rays", "128"]


def test_cli_scenes_lists(capsys):
    main(["scenes"])
    out = capsys.readouterr().out.split()
    assert out == list(t_scenes.SCENES)
    assert "cornell" in out and "three_spheres" in out


def test_cli_render_writes_ppm_and_stats(tmp_path, capsys):
    out = tmp_path / "img.ppm"
    st = tmp_path / "state.npz"
    main(["render", "--scene", "three_spheres", "--nx", "12", "--ny", "12",
          "--spp", "4", "--max-depth", "3", "--chunk", "2",
          "--pool-rays", "256", "--cpu",
          "--out", str(out), "--save-state", str(st)])
    text = capsys.readouterr().out
    assert "Mrays/s" in text and "occupancy" in text and "device=cpu" in text
    assert out.exists() and st.exists()
    with open(out) as f:
        assert f.readline().strip() == "P3"
        assert f.readline().split() == ["12", "12"]
    z = np.load(st)
    assert sorted(z.files) == ["raw_sum", "sample_count", "seed"]
    assert int(z["sample_count"]) == 4 and z["raw_sum"].shape == (12, 12, 3)


def test_cli_resume_matches_one_shot(tmp_path):
    o1 = tmp_path / "a.ppm"
    o2 = tmp_path / "b.ppm"
    st = tmp_path / "st.npz"
    main(["render", *COMMON, "--cpu", "--spp", "2", "--out", str(o1),
          "--save-state", str(st)])
    main(["render", *COMMON, "--cpu", "--spp", "4", "--out", str(o1),
          "--resume", str(st)])
    main(["render", *COMMON, "--cpu", "--spp", "4", "--out", str(o2)])
    assert o1.read_text() == o2.read_text()


def _mean(path):
    z = np.load(path)
    return z["raw_sum"] / int(z["sample_count"]), int(z["sample_count"])


def _within_parity(got, want):
    assert want.max() > 0
    diff = np.abs(got - want)
    assert diff.mean() < 5e-3, diff.mean()
    assert (diff.max(axis=-1) > 0.05).mean() < 0.01


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_state_moves_between_packages(tmp_path, first):
    """Two passes by one package, saved; two more by the other, resumed;
    against the other's four passes in one run."""
    port = lambda args: main([*args, "--cpu"])
    start, finish = (j_main, port) if first == "jax" else (port, j_main)
    ppm = str(tmp_path / "x.ppm")
    half, resumed, whole = (str(tmp_path / f"{n}.npz")
                            for n in ("half", "resumed", "whole"))
    start(["render", *COMMON, "--spp", "2", "--out", ppm,
           "--save-state", half])
    finish(["render", *COMMON, "--spp", "4", "--out", ppm, "--resume", half,
            "--save-state", resumed])
    finish(["render", *COMMON, "--spp", "4", "--out", ppm,
            "--save-state", whole])
    got, n_got = _mean(resumed)
    want, n_want = _mean(whole)
    assert n_got == n_want == 4
    _within_parity(got, want)


_RAD = re.compile(r"radiance\s+= \(([-\d.]+), ([-\d.]+), ([-\d.]+)\)")


def test_probe_matches_jax(capsys):
    args = ["probe", "3", "4", *COMMON, "--samples", "16", "--show", "16"]
    j_main(args)
    want = capsys.readouterr().out
    main([*args, "--cpu"])
    got = capsys.readouterr().out
    w = np.array(_RAD.findall(want), float)
    g = np.array(_RAD.findall(got), float)
    assert w.shape == g.shape == (17, 3)          # 16 samples and the mean
    assert np.isfinite(g).all() and w.max() > 0
    # printed to 5 decimals: values within 1e-5 print at most 1e-5 apart
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 + 1e-9)
    assert "segments/sample" in got and "display (u8)" in got


def test_render_profile_writes_a_trace(tmp_path, capsys):
    trace = tmp_path / "trace"
    main(["render", *COMMON, "--cpu", "--spp", "2", "--out",
          str(tmp_path / "p.ppm"), "--profile", str(trace)])
    assert "torch.profiler trace" in capsys.readouterr().out
    assert any(p.name.endswith(".pt.trace.json") for p in trace.iterdir())
