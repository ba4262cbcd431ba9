"""A configuration, a traffic mix, a per-layer metric and a cell added as
files (and entries of BENCHMARK.json, the index) to a copy of the
benchmark are found by name and run, and no file that was there changes."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

DRIVER = """
import json, sys, time, torch
from rtbench import run
bench = run.benchmark()
cell = run.cell_of(bench, "cornell_shallow.frames-8")
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
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", DRIVER], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(x) for x in out.stdout.splitlines()
             if x.startswith("{")]
    assert lines[0]["correct"] and lines[1]["correct"]
    assert set(lines[0]["metrics"]) == {"fwd_rays_per_s", "fwd_frame_ms_p90",
                                        "setup_s"}
    assert lines[1]["metrics"]["fwd.frames_traced"]["value"] == 1.0
    after = digest(tmp_path / "rtbench")
    assert {k: after[k] for k in before} == before
