"""The roofline's arithmetic against a count by hand on a two-rect scene."""

from rtbench import roofline


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
