"""The roofline's arithmetic against a count by hand: a two-rect scene,
the ribbons' seeds, a klein's march, and the cells with no klein counting
what they counted before the klein term."""

import pytest

from rtbench import roofline, run


def test_two_rects_by_hand():
    scene = dict(n_rects=2, n_spheres=0, n_beziers=0, n_lights=1,
                 bez_seeds=32, bez_newton=8)
    # 10 paths, 25 segments: every segment sweeps 2 rects (12 each), every
    # path casts a camera ray (60), 15 segments shade (100)
    ops, n_bytes = roofline.work(25, 10, 4, scene)
    assert ops == 25 * 24 + 10 * 60 + 15 * 100
    # the 4-pixel frame read and written (4 * 3 floats twice) and the
    # scene once: a header of 27, 26 a rect, 11 the light
    assert n_bytes == 4 * 3 * 4 * 2 + 4 * (27 + 2 * 26 + 11)
    # a step: the adjoint replays the sweep and the camera, shades twice,
    # and reads the target and writes the gradient once more
    ops2, n_bytes2 = roofline.work(25, 10, 4, scene, step=True)
    assert ops2 == ops + 25 * 24 + 10 * 60 + 2 * 15 * 100
    assert n_bytes2 == n_bytes + 4 * 3 * 4 + 4 * (27 + 2 * 26 + 11)
    assert roofline.least_seconds(ops, n_bytes) == max(
        ops / 67e12, n_bytes / 3.35e12)


def test_bezier_seed_count():
    # a ribbon segment: the frame once (30); a curve's projections (100)
    # and 32 seeds, each 8 Newton steps of g and its derivatives (40 + 5),
    # one last evaluation (40) and the end (11)
    seed = 8 * 45 + 40 + 11
    assert roofline.segment_ops(0, 1, 3, 32, 8) == 18 + 30 + 3 * (
        100 + 32 * seed)


def test_klein_by_hand():
    # one klein in a room of six rects: every segment tests the klein's
    # ball (20) and pays the reference's march a segment: 10.5 steps (101
    # each), 4.25 inversions (18) and 0.25 accepted hits, a normal each
    # (100); a step adds a hit's adjoint (300), not a second march
    scene = dict(n_rects=6, n_spheres=0, n_beziers=0, n_lights=1,
                 bez_seeds=32, bez_newton=8, n_kleins=1, klein_steps=10.5,
                 klein_inversions=4.25, klein_hits=0.25)
    march = 20 + 10.5 * 101 + 4.25 * 18
    ops, n_bytes = roofline.work(40, 16, 8, scene)
    assert ops == 40 * 6 * 12 + 16 * 60 + 24 * 100 + 40 * (march + 0.25 * 100)
    # a klein holds 15 floats of the scene
    assert n_bytes == 8 * 3 * 4 * 2 + 4 * (27 + 6 * 26 + 11 + 15)
    ops2, _ = roofline.work(40, 16, 8, scene, step=True)
    assert ops2 == (ops + 40 * 6 * 12 + 16 * 60 + 2 * 24 * 100
                    + 40 * 0.25 * 300)


@pytest.mark.parametrize("name", ["cornell", "bezier"])
@pytest.mark.parametrize("step", [False, True])
def test_cells_without_a_klein_count_what_they_counted(name, step):
    # the cells' scenes (run.scene_counts, as a traced run hands them to
    # the readers) count the sweep, camera, shading and bytes alone, as the
    # roofline did before it knew the klein
    scene = run.scene_counts(run.load("configs", name))
    assert scene["n_kleins"] == 0 and "klein_steps" not in scene
    sweep = roofline.segment_ops(scene["n_rects"], scene["n_spheres"],
                                 scene["n_beziers"], 32, 8)
    segs, paths, pix = 3_141_593, 2_097_152, 262_144
    ops = segs * sweep + paths * 60 + (segs - paths) * 100
    scene_bytes = 4 * (27 + scene["n_rects"] * 26 + scene["n_spheres"] * 21
                       + scene["n_lights"] * 11 + scene["n_beziers"] * 25)
    n_bytes = pix * 24 + scene_bytes
    if step:
        ops += segs * sweep + paths * 60 + 2 * (segs - paths) * 100
        n_bytes += pix * 12 + scene_bytes
    got = roofline.work(segs, paths, pix, scene, step=step)
    assert got == (ops, n_bytes) and all(isinstance(x, int) for x in got)
    ctx = dict(step=step, segments=segs, paths=paths, n_pixels=pix,
               scene=scene, ranks=[dict(kernel_s=0.5)])
    metric = ("train" if step else "fwd") + ".kernels_roofline"
    assert run.reader(metric)(ctx) == \
        100.0 * max(ops / 67e12, n_bytes / 3.35e12) / 0.5
