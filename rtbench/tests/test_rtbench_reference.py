"""The plain reference against the port's CPU path (its plain PyTorch
step) at 16x16: the same frame and segments, the same training steps, each
number within the cell's limit; the klein march on a Cornell-klein scene
(rtbench/tests/klein.py) in float64 and float32."""

import json

import pytest
import torch

from rtbench import check, program, reference, run
from rtbench.tests.klein import cornell_klein

NX = NY = 16
SEED = 2 ** 31 + 77        # larger than 32 signed bits hold
CPU = torch.device("cpu")


def cfg(name):
    return run.load("configs", name)


@pytest.mark.parametrize("name,cell", [("cornell", "cornell-fwd-512"),
                                       ("bezier", None)])
def test_frame_matches_port(name, cell):
    c = cfg(name)
    seed = SEED & 0xFFFFFFFF
    scene, cam, config = program.build(c, NX, NY, 4, seed, CPU)
    st0 = program.zero_state(config, CPU)
    st1, _ = program.frame(scene, cam, config, st0)
    st2, seg = program.frame(scene, cam, config, st1)
    ref, ref_seg = reference.render_frame(c, NX, NY, 4, seed, sample_base=4)
    nums = check.frame_numbers(st1.raw_sum, st2.raw_sum, int(seg), ref,
                               ref_seg)
    assert int(seg) == ref_seg
    assert nums["seg_gap"] == 0.0 and nums["img_gap"] < 1e-6
    if cell:
        assert check.correct(nums, run.load("limits", cell))


@pytest.mark.parametrize("name,cell", [("cornell", None),
                                       ("bezier", "bezier-train-512")])
def test_steps_match_port(name, cell):
    tr = dict(run.load("traffic", "train"), nx=NX, ny=NY, spp=2)
    nums, moved_ref, moved_prog = _steps(cfg(name), tr)
    # once the walls have moved, a path in a few thousand may take another
    # way by an ulp (Cornell at this size: 1 of 1,530 in step 3)
    assert nums["seg_gap"] < 2e-3 and nums["undrained"] == 0.0
    assert nums["loss_gap"] < 1e-6
    assert nums["step1_gap"] < 1e-5 and nums["step3_gap"] < 1e-5
    assert nums["window_median_gap"] < 1e-5
    if cell:
        assert check.correct(nums, run.load("limits", cell))
    # the leaves that move in the reference are the program's
    assert moved_ref == moved_prog


def test_start_is_seeded_and_near_the_published_scene():
    tr = run.load("traffic", "train")
    c = cfg("bezier")
    a, b = run.start_config(c, tr, SEED), run.start_config(c, tr, SEED + 1)
    assert a == run.start_config(c, tr, SEED) and a != b and a != c
    pts = lambda x: [p for o in x["objects"] if "bezier" in o
                     for p in o["bezier"]["points"]]
    for p, q in zip(pts(a), pts(c)):
        assert max(abs(u - v) for u, v in zip(p, q)) <= \
            tr["perturb"]["bezier_points"]
    for m, n in zip(a["materials"].values(), c["materials"].values()):
        assert m.keys() == n.keys()
    # only the numbers the perturbation names move: the geometry stays
    assert [o.get("sphere") for o in a["objects"]] == \
        [o.get("sphere") for o in c["objects"]]


def test_klein_centre_moves_only_where_the_mix_says():
    tr = run.load("traffic", "train")
    c = cornell_klein()
    centre = lambda x: [o["klein"]["center"] for o in x["objects"]
                        if "klein" in o]
    assert centre(run.start_config(c, tr, SEED)) == centre(c)  # no key
    moved = dict(tr, perturb=dict(tr["perturb"], klein_center=5.0))
    a = run.start_config(c, moved, SEED)
    assert a == run.start_config(c, moved, SEED)
    (p,), (q,) = centre(a), centre(c)
    assert p != q and max(abs(u - v) for u, v in zip(p, q)) <= 5.0
    # drawn after every other number: the rest of the start is the same
    same = lambda x: [o for o in x["objects"] if "klein" not in o]
    b = run.start_config(c, tr, SEED)
    assert same(a) == same(b) and a["materials"] == b["materials"]


def test_steps_are_one_fitting_job():
    # the start configuration and the build's and calibration's render
    # seed come from the mix's job_seed, whatever the run's seed; the
    # target, the steps' seeds and the checked window step from the run's
    tr = dict(run.load("traffic", "train"), nx=8, ny=8, spp=1,
              checked_steps=1)
    c = cfg("bezier")
    calibrated = []

    def watch(program):
        class Program:
            def __getattr__(self, name):
                return getattr(program, name)

            def calibrate(self, scene, cam, config, mesh):
                calibrated.append(config.seed)
                return program.calibrate(scene, cam, config, mesh)
        return Program()

    outs = [run.run_steps(c, tr, seed, 0.01, False, CPU, fault=watch)
            ["program"] for seed in (SEED, SEED + 1000)]
    job = tr["job_seed"]
    assert outs[0]["config"] == outs[1]["config"] \
        == run.start_config(c, tr, job)
    assert calibrated == [run.step_seed(job, 0)] * 2
    assert outs[0]["seeds"] == [run.step_seed(SEED, 0)]
    assert outs[1]["seeds"] == [run.step_seed(SEED + 1000, 0)]
    assert not torch.equal(outs[0]["target"], outs[1]["target"])


def test_configuration_files_are_the_scenes_run():
    # the port's own compiler takes the configuration's objects; the
    # reference's compiler gives the same float leaves, value for value
    for c in (cfg("cornell"), cfg("bezier"), cornell_klein()):
        scene, _, _ = program.build(c, NX, NY, 1, 0, CPU)
        ours = reference.scene.compile_scene(c).leaves
        params, _ = program.params_of(scene)
        for k, v in ours.items():
            assert torch.equal(params[k], v), k
    assert json.dumps(cfg("cornell")["render"]).count("light_sampling") == 1


def _steps(c, tr, n_iters=None):
    """The port's four steps of test_steps_match_port on configuration c
    (the checked three and the window's) against the reference's, and
    which leaves moved in the first step on each side; the pool's trip
    count is the calibrated one, or `n_iters`."""
    dt = torch.float64 if c["render"]["dtype"] == "f64" else torch.float32
    target = run.make_target(c, tr, SEED, CPU).to(dt)
    start = run.start_config(c, tr, SEED)
    seeds = [run.step_seed(SEED, k) for k in range(4)]
    scene, cam, config = program.build(start, NX, NY, tr["spp"], seeds[0],
                                       CPU)
    with program.one_rank(CPU) as mesh, program.SegmentCounter() as counter:
        if n_iters is None:
            n_iters = program.calibrate(scene, cam, config, mesh)
        params, rest = program.params_of(scene)
        hist, losses, left, segs = [dict(params)], [], [], []
        for s in seeds:
            params, loss, lo = program.train_step(
                params, rest, cam, config.replace(seed=s), target, mesh,
                n_iters, tr["lr"])
            hist.append(params)
            losses.append(float(loss))
            left.append(int(lo))
            segs.append(int(counter.last))
    prog = dict(losses=losses[:3], history=hist[:4], segments=segs[:3],
                leftovers=left[:3],
                window=dict(before=hist[3], after=hist[4], loss=losses[3],
                            segments=segs[3], leftover=left[3]))
    steps = lambda seeds, **kw: reference.train_steps(
        start, NX, NY, tr["spp"], seeds, target, tr["lr"], dtype=dt, **kw)
    ref = steps(seeds[:3])
    ref_win = steps(seeds[3:], start=hist[3])
    moved = lambda h: {k for k in h[1] if not torch.equal(h[1][k], h[0][k])}
    return check.step_numbers(prog, ref, ref_win), moved(ref[1]), moved(hist)


# The float32 frame's gaps at 16x16 spp4 (the second frame), on seeds
# 2**31 + 77 + 0..5: img_gap 1.9e-7-9.7e-3, seg_gap 4.7e-4-6.3e-3 (2.1e-5
# and 1.4e-3 on this seed); the tolerances are about twice the highest.
# They are not rounding of the answer but paths that part: the reference
# takes the normal as autograd's gradient of its DE, the program as its own
# tangents, apart by rounding (up to 1e-3 where the inversions magnify
# it), and a ray scattered off the fractal starts inside the DE < 0.001
# band, where that picks another re-hit; one such path that then meets the
# light is 1% of a 16x16 frame.  In float64 the same frame agrees to 1e-16
# with exact segments.
@pytest.mark.parametrize("dtype,img_tol,seg_tol", [
    ("f64", 1e-12, 0.0), ("f32", 0.02, 0.015)])
def test_klein_frame_matches_port(dtype, img_tol, seg_tol):
    c = cornell_klein(dtype)
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
    # the march ran, and hit: some tens of steps a hit
    assert 0 < work["hits"] < work["steps"] and work["inversions"] > 0


def test_klein_steps_match_port():
    # float64, the klein's centre perturbed: the implicit t and the
    # autograd normal give the program's loss, segments and every leaf's
    # update to rounding.  float32 steps at this size part by whole paths
    # (the frame's test above), so they are compared on the card at the
    # cell's size instead (PERF.md).  The trip count is max_depth + 1: at
    # 16x16 the pool holds every path at once, and one path of up to 100
    # bounces sets the calibration's drain, so 1.25 times it leaves a later
    # seed's step undrained (the program's stale trip count, PERF.md
    # section 7; twice it still did on this seed); this test holds the
    # march, so it runs the count that ends every path and asserts that
    # every step drained.
    tr = dict(run.load("traffic", "train"), nx=NX, ny=NY, spp=2)
    tr["perturb"] = dict(tr["perturb"], klein_center=5.0)
    c = cornell_klein("f64")
    nums, moved_ref, moved_prog = _steps(c, tr, c["render"]["max_depth"] + 1)
    assert nums["undrained"] == 0.0 and nums["seg_gap"] == 0.0, nums
    assert nums["loss_gap"] < 1e-12, nums
    assert nums["step1_gap"] < 1e-10 and nums["step3_gap"] < 1e-10, nums
    assert nums["window_median_gap"] < 1e-10, nums
    assert "kl_center" in moved_ref and moved_ref == moved_prog


def test_median_leaf_gap_reads_the_median_leaf_alone():
    t = lambda *v: torch.tensor(v, dtype=torch.float64)
    p0 = {"a": t(0.0), "b": t(0.0, 0.0), "c": t(0.0)}
    ref = {"a": t(1.0), "b": t(0.0, 2.0), "c": t(3.0)}
    keep = ["a", "b", "c"]
    # the smallest and largest leaves part; the median leaf agrees
    prog = {"a": t(1.5), "b": t(2.0, 0.0), "c": t(0.0)}
    assert check.median_leaf_gap(p0, prog, p0, ref, keep) == 0.0
    prog["b"] = t(0.0, 2.2)
    assert abs(check.median_leaf_gap(p0, prog, p0, ref, keep) - 0.1) < 1e-12
    # a state left unchanged reads 1; of two in the middle, the upper
    assert check.median_leaf_gap(p0, p0, p0, ref, keep) == 1.0
    assert check.median_leaf_gap(p0, dict(prog, c=t(3.0)), p0, ref,
                                 ["a", "c"]) == 0.0
    # a leaf the program moved that the reference does not have
    assert check.median_leaf_gap(dict(p0, d=t(0.0)), dict(prog, d=t(1.0)),
                                 p0, ref, keep) == float("inf")
