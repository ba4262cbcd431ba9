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
    `bezier_ops` (chip_smoke.py:830-840).

The work is counted from what the inputs need, not from what a pool or a
kernel launches: every path segment sweeps every rect and sphere and, with
ribbons, runs every seed of every curve to its end; every path's camera ray
once; every segment but a path's last shades.  A training step runs the
forward once and its adjoint, which replays the sweep and the ribbons and
shades twice.  Bytes: the frame read and written once and the scene once
(a step also reads its target and writes the scene's gradient once).  So
the share reads the same whichever pool or kernel does the work, and a
share over 100% can only mean work was left out of the count.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
RECT_FLOPS, SPHERE_FLOPS = 12, 18
CAMERA_FLOPS, SHADE_FLOPS = 60, 100
BEZ_G_OPS, BEZ_STEP_OPS, BEZ_END_OPS = 40, 5, 11
BEZ_CURVE_OPS, BEZ_FRAME_OPS = 100, 30

# scene floats a primitive holds in the renderer's packed layout (a header
# of 27, 26 a rect, 21 a sphere, 11 a light, 25 a ribbon)
HDR_FLOATS, RECT_FLOATS, SPH_FLOATS, LIGHT_FLOATS, BEZ_FLOATS = (
    27, 26, 21, 11, 25)


def segment_ops(n_rects, n_spheres, n_beziers, bez_seeds, bez_newton):
    """Operations of one segment's closest-hit sweep, ribbons included."""
    ops = n_rects * RECT_FLOPS + n_spheres * SPHERE_FLOPS
    if n_beziers:
        seed = bez_newton * (BEZ_G_OPS + BEZ_STEP_OPS) + BEZ_G_OPS + BEZ_END_OPS
        ops += BEZ_FRAME_OPS + n_beziers * (BEZ_CURVE_OPS + bez_seeds * seed)
    return ops


def work(segments, paths, n_pixels, scene, step=False):
    """(operations, bytes) of frames or steps that traced `segments` path
    segments over `paths` paths and wrote `n_pixels` pixels in all.  scene:
    dict of n_rects, n_spheres, n_beziers, n_lights, bez_seeds, bez_newton."""
    sweep = segment_ops(scene["n_rects"], scene["n_spheres"],
                        scene["n_beziers"], scene["bez_seeds"],
                        scene["bez_newton"])
    shaded = segments - paths
    ops = segments * sweep + paths * CAMERA_FLOPS + shaded * SHADE_FLOPS
    scene_bytes = 4 * (HDR_FLOATS + scene["n_rects"] * RECT_FLOATS
                       + scene["n_spheres"] * SPH_FLOATS
                       + scene["n_lights"] * LIGHT_FLOATS
                       + scene["n_beziers"] * BEZ_FLOATS)
    n_bytes = n_pixels * 3 * 4 * 2 + scene_bytes
    if step:
        ops += segments * sweep + paths * CAMERA_FLOPS + 2 * shaded * SHADE_FLOPS
        n_bytes += n_pixels * 3 * 4 + scene_bytes
    return ops, n_bytes


def least_seconds(ops, n_bytes):
    """The larger of operations over the float32 peak and bytes over the
    memory peak."""
    return max(ops / PEAK_F32_FLOPS, n_bytes / PEAK_BYTES_S)
