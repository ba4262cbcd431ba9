"""The plain reference against the port's CPU path (its plain PyTorch
step) at 16x16: the same frame and segments, the same training steps, each
number within the cell's limit."""

import json

import pytest
import torch

from rtbench import check, program, reference, run

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
    c = cfg(name)
    tr = dict(run.load("traffic", "train"), nx=NX, ny=NY, spp=2)
    target = run.make_target(c, tr, SEED, CPU)
    start = run.start_config(c, tr, SEED)
    seeds = [run.step_seed(SEED, k) for k in range(4)]
    scene, cam, config = program.build(start, NX, NY, 2, seeds[0], CPU)
    with program.one_rank(CPU) as mesh, program.SegmentCounter() as counter:
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
    # the first three steps checked, the fourth as the window's
    prog = dict(losses=losses[:3], history=hist[:4], segments=segs[:3],
                leftovers=left[:3],
                window=dict(before=hist[3], after=hist[4], loss=losses[3],
                            segments=segs[3], leftover=left[3]))
    steps = lambda seeds, **kw: reference.train_steps(
        start, NX, NY, 2, seeds, target, tr["lr"], **kw)
    ref = steps(seeds[:3])
    ref_win = steps(seeds[3:], start=hist[3])
    nums = check.step_numbers(prog, ref, ref_win)
    # once the walls have moved, a path in a few thousand may take another
    # way by an ulp (Cornell at this size: 1 of 1,530 in step 3)
    assert nums["seg_gap"] < 2e-3 and nums["undrained"] == 0.0
    assert nums["loss_gap"] < 1e-6
    assert nums["step1_gap"] < 1e-5 and nums["step3_gap"] < 1e-5
    assert nums["window_step_gap"] < 1e-5
    if cell:
        assert check.correct(nums, run.load("limits", cell))
    # the leaves that move in the reference are the program's
    rh = ref[1]
    moved = {k for k in rh[1] if not torch.equal(rh[1][k], rh[0][k])}
    assert moved == {k for k in hist[1] if not torch.equal(hist[1][k],
                                                           hist[0][k])}


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


def test_configuration_files_are_the_scenes_run():
    # the port's own compiler takes the configuration's objects; the
    # reference's compiler gives the same float leaves, value for value
    for name in ("cornell", "bezier"):
        c = cfg(name)
        scene, _, _ = program.build(c, NX, NY, 1, 0, CPU)
        ours = reference.scene.compile_scene(c).leaves
        params, _ = program.params_of(scene)
        for k, v in ours.items():
            assert torch.equal(params[k], v), k
    assert json.dumps(cfg("cornell")["render"]).count("light_sampling") == 1
