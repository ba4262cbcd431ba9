"""The `cornell_klein` configuration file (configs/cornell_klein.json) is
the scene the tests' helper builds (tests/klein.py: soma-arc/scheme-raytrace
main.scm:409-426) at its published size, and the plain reference holds the
port's CPU path to it at 16x16 from the file itself: in float64 the same
frame and segments, in float32 within the bounds of
test_rtbench_reference.py's klein frame (paths part on the fractal)."""

import copy

import pytest
import torch

from rtbench import check, program, reference, run
from rtbench.tests.klein import cornell_klein

NX = NY = 16
SEED = 2 ** 31 + 77
CPU = torch.device("cpu")
# what the file holds beyond the scene: its provenance, and the march's
# constants, which the program and the reference fix in code
NOTES = {"source", "why", "reduced_why", "assumed", "klein"}


def test_file_is_the_published_scene():
    c = run.load("configs", "cornell_klein")
    helper = cornell_klein()
    assert {k: v for k, v in c.items() if k not in NOTES} == \
        {k: v for k, v in helper.items() if k not in NOTES}
    assert c["reduced"] == ["spp"] and c["render"]["max_depth"] == 100
    assert c["render"]["dtype"] == "f32" and c["render"]["light_sampling"]
    assert [o["klein"]["center"] for o in c["objects"] if "klein" in o] \
        == [[250, 200, 280]]


def test_no_width_of_the_march_is_cut():
    from rtbench.reference import tracer
    k = run.load("configs", "cornell_klein")["klein"]
    assert (k["max_steps"], k["iterations"], k["surf_eps"], k["de_scale"],
            k["r"], k["sphere_r"]) == (
        tracer.KLEIN_MAX_STEPS, tracer.KLEIN_ITERATIONS, tracer.KLEIN_EPS,
        tracer.KLEIN_DE_SCALE, tracer.KLEIN_R, tracer.KLEIN_SPHERE_R)


@pytest.mark.parametrize("dtype,img_tol,seg_tol", [
    ("f64", 1e-12, 0.0), ("f32", 0.02, 0.015)])
def test_file_frame_matches_port(dtype, img_tol, seg_tol):
    c = copy.deepcopy(run.load("configs", "cornell_klein"))
    c["render"] = dict(c["render"], dtype=dtype)
    seed = SEED & 0xFFFFFFFF
    scene, cam, config = program.build(c, NX, NY, 4, seed, CPU)
    st0 = program.zero_state(config, CPU)
    st1, _ = program.frame(scene, cam, config, st0)
    st2, seg = program.frame(scene, cam, config, st1)
    work = dict(steps=0, inversions=0, hits=0)
    ref, ref_seg = reference.render_frame(
        c, NX, NY, 4, seed, sample_base=4, work=work,
        dtype=torch.float64 if dtype == "f64" else torch.float32)
    nums = check.frame_numbers(st1.raw_sum, st2.raw_sum, int(seg), ref,
                               ref_seg)
    assert nums["img_gap"] <= img_tol and nums["seg_gap"] <= seg_tol, nums
    assert 0 < work["hits"] < work["steps"] and work["inversions"] > 0
