"""The least time the card could take for a frame's or a step's work.

Frozen copies of the renderer's operation counts (chip_smoke.py as of
commit 96aaa41), so that a later change to the program cannot move the
yardstick:

  * PEAK_BYTES_S, PEAK_F32_FLOPS: chip_smoke.py:323-324, the published peaks
    of one NVIDIA H100 SXM (3.35 TB/s of HBM, 67 TFLOP/s in float32 outside
    the tensor cores; at its 700 W limit);
  * RECT_FLOPS, SPHERE_FLOPS, CAMERA_FLOPS, SHADE_FLOPS: chip_smoke.py:331-332,
    a floor of the float operations of a rect probe, a sphere probe, a fresh
    lane's camera ray and a scattering lane's shading;
  * BEZ_G_OPS, BEZ_STEP_OPS, BEZ_END_OPS, BEZ_CURVE_OPS, BEZ_FRAME_OPS:
    chip_smoke.py:356-357, the bezier probe's, in the arithmetic of
    `bezier_ops` (chip_smoke.py:830-840);
  * KLEIN_PRECULL_OPS, KLEIN_STEP_OPS, KLEIN_INV_OPS, KLEIN_NORMAL_OPS,
    KLEIN_ADJ_OPS: chip_smoke.py:382-383 (as of commit aa22e9e), the klein
    probe's: a lane's test of the ball the march can accept in, a march
    step, an inversion, a hit's normal, and a hit's adjoint in the backward
    kernel.

The work is counted from what the inputs need, not from what a pool or a
kernel launches: every path segment sweeps every rect and sphere and, with
ribbons, runs every seed of every curve to its end; every path's camera ray
once; every segment but a path's last shades.  With kleins, every segment
tests each klein's ball, and on top pays the march steps, inversions and
accepted hits (a normal each) that the plain reference's march takes a
segment on the run's checked frame or steps, counted on the lanes that
enter the ball alone (the scene's `klein_steps`, `klein_inversions`,
`klein_hits`).  A training step runs the forward once and its adjoint,
which replays the sweep and the ribbons and shades twice, and adds a
klein hit's adjoint, not a second march: however the program gets back a
hit's distance, the work counted stays the same.  Bytes: the frame read
and written once and the scene once (a step also reads its target and
writes the scene's gradient once).  So the share reads the same whichever
pool or kernel does the work, and a share over 100% can only mean work was
left out of the count.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
RECT_FLOPS, SPHERE_FLOPS = 12, 18
CAMERA_FLOPS, SHADE_FLOPS = 60, 100
BEZ_G_OPS, BEZ_STEP_OPS, BEZ_END_OPS = 40, 5, 11
BEZ_CURVE_OPS, BEZ_FRAME_OPS = 100, 30
KLEIN_PRECULL_OPS, KLEIN_STEP_OPS, KLEIN_INV_OPS = 20, 101, 18
KLEIN_NORMAL_OPS, KLEIN_ADJ_OPS = 100, 300

# scene floats a primitive holds in the renderer's packed layout (a header
# of 27, 26 a rect, 21 a sphere, 11 a light, 25 a ribbon, 15 a klein;
# integrator/bounce.py:104-146 as of commit aa22e9e)
HDR_FLOATS, RECT_FLOATS, SPH_FLOATS, LIGHT_FLOATS, BEZ_FLOATS = (
    27, 26, 21, 11, 25)
KL_FLOATS = 15


def segment_ops(n_rects, n_spheres, n_beziers, bez_seeds, bez_newton):
    """Operations of one segment's closest-hit sweep, ribbons included."""
    ops = n_rects * RECT_FLOPS + n_spheres * SPHERE_FLOPS
    if n_beziers:
        seed = bez_newton * (BEZ_G_OPS + BEZ_STEP_OPS) + BEZ_G_OPS + BEZ_END_OPS
        ops += BEZ_FRAME_OPS + n_beziers * (BEZ_CURVE_OPS + bez_seeds * seed)
    return ops


def klein_ops(scene, step=False):
    """Operations of one segment's klein probes: every klein's ball test,
    and the reference's march steps, inversions and accepted hits a
    segment, a hit's normal and, in a step, its adjoint."""
    hit = KLEIN_NORMAL_OPS + (KLEIN_ADJ_OPS if step else 0)
    return (scene["n_kleins"] * KLEIN_PRECULL_OPS
            + scene["klein_steps"] * KLEIN_STEP_OPS
            + scene["klein_inversions"] * KLEIN_INV_OPS
            + scene["klein_hits"] * hit)


def work(segments, paths, n_pixels, scene, step=False):
    """(operations, bytes) of frames or steps that traced `segments` path
    segments over `paths` paths and wrote `n_pixels` pixels in all.  scene:
    dict of n_rects, n_spheres, n_beziers, n_lights, bez_seeds, bez_newton
    and, where it has kleins, n_kleins and their march work a segment
    (klein_steps, klein_inversions, klein_hits)."""
    sweep = segment_ops(scene["n_rects"], scene["n_spheres"],
                        scene["n_beziers"], scene["bez_seeds"],
                        scene["bez_newton"])
    shaded = segments - paths
    ops = segments * sweep + paths * CAMERA_FLOPS + shaded * SHADE_FLOPS
    n_kleins = scene.get("n_kleins", 0)
    if n_kleins:
        ops += segments * klein_ops(scene, step)
    scene_bytes = 4 * (HDR_FLOATS + scene["n_rects"] * RECT_FLOATS
                       + scene["n_spheres"] * SPH_FLOATS
                       + scene["n_lights"] * LIGHT_FLOATS
                       + scene["n_beziers"] * BEZ_FLOATS
                       + n_kleins * KL_FLOATS)
    n_bytes = n_pixels * 3 * 4 * 2 + scene_bytes
    if step:
        ops += segments * sweep + paths * CAMERA_FLOPS + 2 * shaded * SHADE_FLOPS
        n_bytes += n_pixels * 3 * 4 + scene_bytes
    return ops, n_bytes


def least_seconds(ops, n_bytes):
    """The larger of operations over the float32 peak and bytes over the
    memory peak."""
    return max(ops / PEAK_F32_FLOPS, n_bytes / PEAK_BYTES_S)
