"""A configuration, a traffic mix, a per-layer metric and a cell added as
files (and entries of BENCHMARK.json, the index) to a copy of the
benchmark are found by name and run, and no file that was there changes;
so is a klein configuration, under frames and under steps."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from rtbench.tests.klein import cornell_klein

ROOT = Path(__file__).resolve().parents[2]

DRIVER = """
import json, sys, time, torch
from rtbench import run
bench = run.benchmark()
cell = run.cell_of(bench, sys.argv[1])
for trace in (0, 1):
    line = run.run_cell(bench, cell, 5, 0.05, trace, torch.device("cpu"),
                        t0=time.perf_counter())
    print(json.dumps(line))
"""


def digest(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_cell_added_as_files(tmp_path):
    shutil.copytree(ROOT / "rtbench", tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(tmp_path / "rtbench")
    here = tmp_path / "rtbench"
    cfg = json.loads((here / "configs" / "cornell.json").read_text())
    cfg.update(name="cornell_shallow", reduced=["spp", "max_depth"])
    cfg["render"] = dict(cfg["render"], max_depth=3)
    (here / "configs" / "cornell_shallow.json").write_text(json.dumps(cfg))
    (here / "traffic" / "frames-8.json").write_text(json.dumps(
        {"loop": "frames", "why": "tiny", "nx": 8, "ny": 8, "spp": 2,
         "ranks": 1, "trace_units": 1}))
    (here / "metrics" / "fwd.frames_traced.py").write_text(
        "def read(ctx):\n    return float(ctx['units'])\n")
    (here / "limits" / "cornell_shallow.frames-8.json").write_text(
        json.dumps({"img_gap": 1e-6, "seg_gap": 0.0}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "cornell_shallow", "source": "a test",
                             "file": "rtbench/configs/cornell_shallow.json",
                             "reduced": ["spp", "max_depth"], "why": "a test"})
    bench["workloads"].append({"name": "cornell_shallow.frames-8",
                               "config": "cornell_shallow",
                               "traffic": "frames-8", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"].startswith("fwd_"):
            m["workloads"].append("cornell_shallow.frames-8")
    bench["per_layer"].append({"name": "fwd.frames_traced", "unit": "frames",
                               "better": "higher", "source": "device_trace",
                               "layer": "the card", "moves": "fwd_rays_per_s",
                               "workloads": ["cornell_shallow.frames-8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    lines = drive(tmp_path, "cornell_shallow.frames-8")
    assert lines[0]["correct"] and lines[1]["correct"]
    assert set(lines[0]["metrics"]) == {"fwd_rays_per_s", "fwd_frame_ms_p90",
                                        "setup_s"}
    assert lines[1]["metrics"]["fwd.frames_traced"]["value"] == 1.0
    after = digest(tmp_path / "rtbench")
    assert {k: after[k] for k in before} == before


def drive(root, cell):
    """The result lines of `cell` run untraced and traced from a copy at
    `root`, on the CPU."""
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", DRIVER, cell], cwd=root,
                         env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(x) for x in out.stdout.splitlines()
            if x.startswith("{")]


KLEIN_TRAFFIC = {
    "frames": {"loop": "frames", "why": "tiny", "nx": 8, "ny": 8, "spp": 2,
               "ranks": 1, "trace_units": 1},
    "steps": {"loop": "steps", "why": "tiny", "nx": 8, "ny": 8, "spp": 2,
              "lr": 0.01, "job_seed": 1,
              "perturb": {"albedo": 0.2, "emission": 0.2,
                          "bezier_points": 0.05, "klein_center": 5.0},
              "checked_steps": 3, "trace_units": 1},
}
# set from the readings of this seed at depth 3 (img_gap 3.7e-8, seg_gap 0;
# loss_gap 2.0e-7, seg_gap 0, step1_gap 2.1e-8, step3_gap 1.4e-7,
# window_median_gap 0), with room for another build of torch
KLEIN_LIMITS = {
    "frames": {"img_gap": 1e-5, "seg_gap": 1e-3},
    "steps": {"loss_gap": 1e-5, "seg_gap": 1e-3, "step1_gap": 1e-4,
              "step3_gap": 1e-4, "window_median_gap": 1e-4, "undrained": 0},
}


@pytest.mark.parametrize("loop", ["frames", "steps"])
def test_klein_added_as_files(tmp_path, loop):
    shutil.copytree(ROOT / "rtbench", tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(tmp_path / "rtbench")
    here = tmp_path / "rtbench"
    name, cell = "cornell_klein", f"cornell_klein.{loop}-8"
    cfg = dict(cornell_klein(max_depth=3), reduced=["spp", "max_depth"])
    (here / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    (here / "traffic" / f"{loop}-8.json").write_text(
        json.dumps(KLEIN_TRAFFIC[loop]))
    (here / "limits" / f"{cell}.json").write_text(
        json.dumps(KLEIN_LIMITS[loop]))
    kind = "fwd" if loop == "frames" else "train"
    metric = f"{kind}.klein_steps_per_segment"
    (here / "metrics" / f"{metric}.py").write_text(
        "def read(ctx):\n    return ctx['scene']['klein_steps']\n")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": name, "source": "a test",
                             "file": f"rtbench/configs/{name}.json",
                             "reduced": ["spp", "max_depth"],
                             "why": "a test"})
    bench["workloads"].append({"name": cell, "config": name,
                               "traffic": f"{loop}-8", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"].startswith(kind + "_"):
            m["workloads"].append(cell)
    bench["per_layer"].append({"name": metric, "unit": "steps",
                               "better": "lower", "source": "device_trace",
                               "layer": "the card",
                               "moves": f"{kind}_rays_per_s",
                               "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    lines = drive(tmp_path, cell)
    assert lines[0]["correct"] and lines[1]["correct"], lines
    assert set(lines[0]["metrics"]) >= {"setup_s", f"{kind}_rays_per_s"}
    # the reference's march work a segment reaches the readers
    assert lines[1]["metrics"][metric]["value"] > 0.0
    after = digest(tmp_path / "rtbench")
    assert {k: after[k] for k in before} == before
