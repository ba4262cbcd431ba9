"""A run of each kind of cell, with the look for a chip skipped and the
timed path broken underneath, comes out as not correct: a step that
returns its state unchanged, half of the batch left out (the mean taken
over the rest), an answer altered where it is produced (a cell on one
card has no exchange between chips to leave out).  The same runs unbroken
come out correct."""

import time

import pytest
import torch

from rtbench import run
from rtbench.tests import plants

CPU = torch.device("cpu")
SEED = 2 ** 31 + 9


def go(cell, fault, **tr_over):
    bench = run.benchmark()
    cell = run.cell_of(bench, cell)
    tr = dict(run.load("traffic", cell["traffic"]), nx=16, ny=16, **tr_over)
    return run.run_cell(bench, cell, SEED, 0.05, 0, CPU,
                        t0=time.perf_counter(), fault=fault, traffic=tr)


@pytest.mark.parametrize("fault", [None, plants.frames_unchanged,
                                   plants.frames_half, plants.frames_altered],
                         ids=["sound", "unchanged", "half", "altered"])
def test_frames(fault):
    line = go("cornell-fwd-512", fault, spp=2)
    assert line["correct"] is (fault is None), line["check"]


@pytest.mark.parametrize("cell", ["bezier-train-512"])
@pytest.mark.parametrize("fault", [None, plants.steps_unchanged,
                                   plants.steps_half, plants.steps_altered],
                         ids=["sound", "unchanged", "half", "altered"])
def test_steps(cell, fault):
    line = go(cell, fault, spp=2)
    assert line["correct"] is (fault is None), line["check"]


def test_steps_whose_segments_cannot_be_read_stop_the_run():
    with pytest.raises(RuntimeError, match="no segment count"):
        go("bezier-train-512", plants.steps_rerouted, spp=2)
