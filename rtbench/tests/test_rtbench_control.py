"""The control (the reference in bfloat16, in the program's place) comes
out as not correct, at a size a test run holds: a frame cell's and a
training cell's.  On the card the same readings are taken at each cell's
own size with `python -m rtbench.control` (PERF.md)."""

import pytest
import torch

from rtbench import check, control, run

CPU = torch.device("cpu")


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5])
def test_frame_control_fails(seed):
    cell = "cornell-fwd-512"
    cfg = run.load("configs", "cornell")
    tr = dict(run.load("traffic", "fwd"), nx=24, ny=24, spp=2)
    (r,) = control.frame_readings(cfg, tr, seed, CPU, torch.bfloat16)
    nums = {k: r[k] for k in ("img_gap", "seg_gap")}
    assert not check.correct(nums, run.load("limits", cell)), r


@pytest.mark.parametrize("cell", ["bezier-train-512"])
def test_step_control_and_half_batch_fail(cell):
    c = run.cell_of(run.benchmark(), cell)
    cfg = run.load("configs", c["config"])
    tr = dict(run.load("traffic", c["traffic"]), nx=16, ny=16, spp=2)
    limits = run.load("limits", cell)
    for r in control.step_readings(cfg, tr, 11, CPU, torch.bfloat16):
        if "error" in r:
            continue            # a control that crashes has failed
        nums = {k: r[k] for k in limits if k in r}
        assert not check.correct(nums, limits), r
