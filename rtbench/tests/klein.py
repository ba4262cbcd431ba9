"""A Cornell-klein configuration for the tests: soma-arc/scheme-raytrace
main.scm:409-426 (cornell-klein), the Cornell walls with the wide light and
the Kleinian fractal at (250, 200, 280), built from the cornell
configuration.  The benchmark has no klein cell; this is what the tests
hold the reference's march to."""

import copy

from rtbench import run

WIDE_LIGHT = {"rect": {"plane": "xz", "a": [113, 443], "b": [127, 432],
                       "k": 554},
              "material": "light", "flip_normals": True}
KLEIN = {"klein": {"center": [250, 200, 280]}, "material": "blue"}


def cornell_klein(dtype="f32", max_depth=100):
    c = copy.deepcopy(run.load("configs", "cornell"))
    c.update(name="cornell_klein", reduced=["spp"])
    c["materials"]["blue"] = {"lambertian": [0.05, 0.65, 0.65]}
    walls = c["objects"][:6]           # the five walls and the light
    walls[2] = copy.deepcopy(WIDE_LIGHT)
    c["objects"] = walls + [copy.deepcopy(KLEIN)]
    c["render"] = dict(c["render"], dtype=dtype, max_depth=max_depth)
    return c
