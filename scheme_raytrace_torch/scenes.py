"""The reference's scene library (main.scm:31-89,155-426), as build functions.

Each function returns (objects, camera, sky, lights) ready for
`scene.compile_scene`; randomized scenes take an explicit numpy seed (the
reference consumes the global srfi-27 RNG at module load — SURVEY §6.3).
`random_scene` fixes the dead-code arity bug B6 (main.scm:89) so the RTOW
final scene actually renders (BASELINE config 2).

A copy of scheme_raytrace_tpu/scenes.py, whose imports pull JAX in;
`SceneSpec.camera` returns the port's Camera.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import camera as cam_mod
from .scene import objects as ob

SIZE_X, SIZE_Y = 200, 200     # main.scm:126-127

CHECKER = ob.CheckerTexture(ob.ConstantTexture((0.2, 0.3, 0.1)),
                            ob.ConstantTexture((0.9, 0.9, 0.9)))
RED = ob.Lambertian((0.65, 0.05, 0.05))
WHITE = ob.Lambertian((0.73, 0.73, 0.73))
GREEN = ob.Lambertian((0.12, 0.45, 0.15))
BLUE = ob.Lambertian((0.12, 0.15, 0.45))


@dataclasses.dataclass
class SceneSpec:
    objects: List[ob.Hittable]
    camera_kwargs: dict
    sky: str
    lights: Optional[List[ob.Hittable]] = None

    def camera(self, dtype=None, aspect: Optional[float] = None,
               device=None):
        kw = dict(self.camera_kwargs)
        if aspect is not None:
            kw["aspect"] = aspect
        if dtype is not None:
            kw["dtype"] = dtype
        return cam_mod.make_camera(**kw, device=device)


def default_camera() -> dict:
    """*camera* (main.scm:141-153)."""
    return dict(lookfrom=(0.0, 5.0, 5.0), lookat=(0.0, 0.0, 0.0),
                vup=(0.0, 1.0, 0.0), vfov=40.0, aspect=SIZE_X / SIZE_Y,
                aperture=0.0, focus_dist=1.0, time0=0.0, time1=1.0)


def cornell_camera() -> dict:
    """*cornell-camera* (main.scm:129-139)."""
    return dict(lookfrom=(278.0, 278.0, -800.0), lookat=(278.0, 278.0, 0.0),
                vup=(0.0, 1.0, 0.0), vfov=40.0, aspect=SIZE_X / SIZE_Y,
                aperture=0.0, focus_dist=1.0, time0=0.0, time1=1.0)


def _cornell_walls(light_wide: bool) -> List[ob.Hittable]:
    """The 5 walls + light shared by the cornell-* scenes (main.scm:330-426)."""
    light = ob.DiffuseLight((3.0, 3.0, 3.0))
    light_rect = (ob.xz_rect(113, 443, 127, 432, 554, light) if light_wide
                  else ob.xz_rect(213, 343, 227, 332, 554, light))
    return [
        ob.FlipNormals(ob.yz_rect(0, 555, 0, 555, 555, GREEN)),
        ob.yz_rect(0, 555, 0, 555, 0, RED),
        ob.FlipNormals(light_rect),
        ob.FlipNormals(ob.xz_rect(0, 555, 0, 555, 555, WHITE)),
        ob.xz_rect(0, 555, 0, 555, 0, WHITE),
        ob.FlipNormals(ob.xy_rect(0, 555, 0, 555, 555, WHITE)),
    ]


def three_spheres() -> SceneSpec:
    """BASELINE config 1 — 3-sphere Lambertian scene (CPU-runnable oracle).

    Not a reference scene: BASELINE.json prescribes it as the minimal parity
    workload.  Ground + two Lambertian spheres under the gradient sky
    (sky-color, main.scm:91-95) so every path terminates by escaping."""
    objs = [
        ob.Sphere((0, -100.5, -1), 100, ob.Lambertian((0.8, 0.8, 0.0))),
        ob.Sphere((0, 0, -1), 0.5, ob.Lambertian((0.1, 0.2, 0.5))),
        ob.Sphere((1, 0, -1), 0.5, ob.Lambertian((0.7, 0.3, 0.3))),
    ]
    cam = dict(lookfrom=(0.0, 0.5, 2.0), lookat=(0.0, 0.0, -1.0),
               vup=(0.0, 1.0, 0.0), vfov=45.0, aspect=1.0,
               aperture=0.0, focus_dist=1.0, time0=0.0, time1=1.0)
    return SceneSpec(objs, cam, "gradient")


def _parity_test_image() -> np.ndarray:
    """Deterministic 16x16 RGB test card for the image-texture parity scene."""
    yy, xx = np.mgrid[0:16, 0:16]
    img = np.stack([xx / 15.0, yy / 15.0, ((xx // 2 + yy // 2) % 2).astype(float)],
                   axis=-1)
    return img.astype(np.float64)


def textured_scene() -> SceneSpec:
    """BASELINE config 3 — checker + Perlin-noise textures, image texture
    on a sphere.  Exercises every texture family (texture.scm:12-50),
    including the image path the reference ships but never calls (its
    `image-texture`, texture.scm:36-50, has no loader — SURVEY §6.6)."""
    objs = [
        ob.Sphere((0, -100.5, -1), 100, ob.Lambertian(CHECKER)),
        ob.Sphere((-1.1, 0, -1), 0.5, ob.Lambertian(ob.MarbleTexture(4.0))),
        ob.Sphere((0, 0, -1), 0.5,
                  ob.Lambertian(ob.ImageTexture(_parity_test_image()))),
        ob.Sphere((1.1, 0, -1), 0.5, ob.Lambertian(ob.NoiseTexture(2.0))),
    ]
    cam = dict(lookfrom=(0.0, 0.5, 2.0), lookat=(0.0, 0.0, -1.0),
               vup=(0.0, 1.0, 0.0), vfov=45.0, aspect=1.0,
               aperture=0.0, focus_dist=1.0, time0=0.0, time1=1.0)
    return SceneSpec(objs, cam, "gradient")


def test_scene() -> SceneSpec:
    """main.scm:155-174 — 5-sphere RTOW sampler incl. hollow dielectric."""
    objs = [
        ob.Sphere((0, 0, -1), 0.5, ob.Lambertian((0.1, 0.2, 0.5))),
        ob.Sphere((0, -100.5, -1), 100, ob.Lambertian(CHECKER)),
        ob.Sphere((1, 0, -1), 0.5, ob.Metal((0.8, 0.6, 0.2), 0.3)),
        ob.Sphere((-1, 0, -1), 0.5, ob.Dielectric(1.5)),
        ob.Sphere((-1, 0, -1), -0.45, ob.Dielectric(1.5)),   # hollow trick
    ]
    return SceneSpec(objs, default_camera(), "black")


def line_upped_spheres(nx: int, ny: int, seed: int = 0) -> List[ob.Hittable]:
    """main.scm:177-191 — nx*ny grid of random lambertian spheres."""
    rng = np.random.default_rng(seed)
    out = []
    for x in range(nx):
        for y in range(ny):
            out.append(ob.Sphere((x, 0, y), 0.5,
                                 ob.Lambertian(tuple(rng.uniform(0, 1, 3)))))
    return out


def test_scene_grid(seed: int = 0) -> SceneSpec:
    """main.scm:204-235 — checker ground + 10x10 sphere grid.

    The non-bvh / bvh / bvh-sah triple is a *traversal* choice here
    (RenderConfig.traversal), not three scenes — same image either way.
    """
    objs = [ob.Sphere((0, -100.5, -1), 100, ob.Lambertian(CHECKER))]
    objs += line_upped_spheres(10, 10, seed)
    return SceneSpec(objs, default_camera(), "gradient")


def test_bezier() -> SceneSpec:
    """main.scm:237-277 — ground + 6 marker spheres + 3 bezier curves."""
    objs = [ob.Sphere((0, -100.5, -1), 100, ob.Lambertian(CHECKER)),
            ob.Sphere((2, 0, 2), 0.5, RED),
            ob.Sphere((-2, 0, -2), 0.5, GREEN),
            ob.Sphere((-1, 0, -1), 0.1, BLUE),
            ob.Sphere((-0.8, 1, 1), 0.1, BLUE),
            ob.Sphere((0.8, -1, 1), 0.1, BLUE),
            ob.Sphere((1, 0, -1), 0.1, BLUE),
            ob.Bezier(np.array([[-1, 0, -1], [-0.8, 1, 1],
                                [0.8, -1, 1], [1, 0, -1]], float), 0.1, RED),
            ob.Bezier(np.array([[-1, 0, 1], [-0.8, 1, -1],
                                [0.8, -1, -1], [1, 0, 1]], float), 0.1, RED),
            ob.Bezier(np.array([[-1, 0, 2], [-0.8, 1, -2],
                                [0.8, -1, -2], [1, 0, 2]], float), 0.1, RED)]
    return SceneSpec(objs, default_camera(), "gradient")


def test_scene2() -> SceneSpec:
    """main.scm:316-328 — 'simple light': marble ground+sphere, two emitters."""
    marble = ob.MarbleTexture(1.0)
    light = ob.DiffuseLight((4.0, 4.0, 4.0))
    objs = [ob.Sphere((0, -1000, -1), 1000, ob.Lambertian(marble)),
            ob.Sphere((0, 2, 0), 2, ob.Lambertian(marble)),
            ob.Sphere((0, 7, 0), 2, light),
            ob.xy_rect(3, 5, 1, 3, -2, light)]
    return SceneSpec(objs, default_camera(), "black")


def cornell_box() -> SceneSpec:
    """main.scm:330-351 — note the gradient sky (B12, reproduced)."""
    objs = _cornell_walls(light_wide=False) + [
        ob.Translate(ob.RotateY(ob.Box((0, 0, 0), (165, 165, 165), WHITE),
                                -18.0), (130, 0, 65)),
        ob.Translate(ob.RotateY(ob.Box((0, 0, 0), (165, 330, 165), WHITE),
                                15.0), (265, 0, 295)),
    ]
    return SceneSpec(objs, cornell_camera(), "gradient")


def cornell_materials() -> SceneSpec:
    """Not a reference scene: the coverage scene of the fused bounce
    kernels' Cornell slice.  The Cornell room with a fuzzy-metal left wall,
    a checker floor, a glass short box and a mirror tall box, seen through
    a lens aperture, with a sphere as a second light-sampling target beside
    the ceiling light, so one plan takes every rule the kernels cover."""
    walls = _cornell_walls(light_wide=False)
    walls[0] = ob.FlipNormals(ob.yz_rect(0, 555, 0, 555, 555,
                                         ob.Metal((0.8, 0.85, 0.88), 0.2)))
    walls[4] = ob.xz_rect(0, 555, 0, 555, 0, ob.Lambertian(CHECKER))
    objs = walls + [
        ob.Translate(ob.RotateY(ob.Box((0, 0, 0), (165, 165, 165),
                                       ob.Dielectric(1.5)), -18.0),
                     (130, 0, 65)),
        ob.Translate(ob.RotateY(ob.Box((0, 0, 0), (165, 330, 165),
                                       ob.Metal((0.9, 0.9, 0.9), 0.0)), 15.0),
                     (265, 0, 295)),
    ]
    lights = [walls[2], ob.Sphere((400.0, 450.0, 200.0), 40.0,
                                  ob.DiffuseLight((2.0, 2.0, 2.0)))]
    return SceneSpec(objs, dict(cornell_camera(), aperture=20.0,
                                focus_dist=800.0), "gradient", lights)


def cornell_bezier() -> SceneSpec:
    """main.scm:353-373 — Cornell walls + one fat bezier (w=10)."""
    objs = _cornell_walls(light_wide=False) + [
        ob.Bezier(np.array([[130, 0, 65], [150, 0, 190],
                            [130, 0, 190], [265, 0, 295]], float), 10.0, RED)]
    return SceneSpec(objs, cornell_camera(), "gradient")


def cornell_smoke() -> SceneSpec:
    """main.scm:375-398 — wide light + two rho=0.01 media boxes."""
    b1 = ob.Translate(ob.RotateY(ob.Box((0, 0, 0), (165, 165, 165), WHITE),
                                 -18.0), (130, 0, 65))
    b2 = ob.Translate(ob.RotateY(ob.Box((0, 0, 0), (165, 330, 165), WHITE),
                                 15.0), (265, 0, 295))
    objs = _cornell_walls(light_wide=True) + [
        ob.ConstantMedium(b1, 0.01, (1.0, 1.0, 1.0)),
        ob.ConstantMedium(b2, 0.01, (0.0, 0.0, 0.0)),
    ]
    return SceneSpec(objs, cornell_camera(), "black")


def klein_scene() -> SceneSpec:
    """main.scm:400-407."""
    objs = [ob.Sphere((0, -1003, -1), 1000, WHITE),
            ob.Klein((0, 2, 0), RED)]
    return SceneSpec(objs, default_camera(), "gradient")


def cornell_klein() -> SceneSpec:
    """main.scm:409-426 — wide light + klein at (250,200,280)."""
    blue = ob.Lambertian((0.05, 0.65, 0.65))
    objs = _cornell_walls(light_wide=True) + [ob.Klein((250, 200, 280), blue)]
    return SceneSpec(objs, cornell_camera(), "gradient")


def points_chain_scene(csv_path: Optional[str] = None,
                       width: float = 0.1) -> SceneSpec:
    """main.scm:279-314 (`test-bezier-points`, commented out in the ref) —
    ground sphere + a CSV-driven Catmull-Rom Bezier chain (points.scm).

    The reference's data files (2-2.csv / points.csv) never shipped, so
    with csv_path=None a built-in helix point set stands in — the pipeline
    (load -> window -> cp -> Bezier objects) is identical either way."""
    from . import points as pts
    if csv_path is not None:
        chain = pts.load_bezier_chain(csv_path, width, RED)
    else:
        t = np.linspace(0.0, 4.0 * np.pi, 12)
        helix = np.stack([np.cos(t), 0.15 * t - 0.3, np.sin(t)], axis=1)
        chain = pts.bezier_objs(pts.points_to_bezier_cps(helix), width, RED)
    objs = [ob.Sphere((0, -100.5, -1), 100, ob.Lambertian(CHECKER))]
    objs += chain
    return SceneSpec(objs, default_camera(), "gradient")


def random_scene(seed: int = 0) -> SceneSpec:
    """main.scm:31-89 — RTOW book-1 final scene (arity bug B6 fixed).

    Moving diffuse spheres (motion blur), metal/dielectric minis, 3 heroes.
    RNG draw order matches the reference loop so the *distribution* of
    scenes is the same (values differ — srfi-27 vs numpy, SURVEY §7.3.4).
    """
    rng = np.random.default_rng(seed)
    objs: List[ob.Hittable] = [
        ob.Sphere((0, -1000, 0), 1000, ob.Lambertian(CHECKER))]
    for a in range(-5, 10):
        for b in range(-5, 10):
            choose = rng.uniform()
            center = np.array([a + 0.9 * rng.uniform(), 0.2,
                               b + 0.9 * rng.uniform()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose < 0.8:
                albedo = rng.uniform(0, 1, 3) * rng.uniform(0, 1, 3)
                objs.append(ob.MovingSphere(
                    center, center + np.array([0, 0.5 * rng.uniform(), 0]),
                    0.0, 1.0, 0.2, ob.Lambertian(tuple(albedo))))
            elif choose < 0.95:
                albedo = 0.5 * (1 + rng.uniform(0, 1, 3))
                objs.append(ob.Sphere(center, 0.2,
                                      ob.Metal(tuple(albedo),
                                               0.5 * rng.uniform())))
            else:
                objs.append(ob.Sphere(center, 0.2, ob.Dielectric(1.5)))
    objs += [ob.Sphere((0, 1, 0), 1, ob.Dielectric(1.5)),
             ob.Sphere((-4, 1, 0), 1, ob.Lambertian((0.4, 0.2, 0.1))),
             ob.Sphere((4, 1, 0), 1, ob.Metal((0.7, 0.6, 0.5), 0.0))]
    return SceneSpec(objs, default_camera(), "gradient")


SCENES = {
    "three_spheres": three_spheres,
    "textured": textured_scene,
    "test": test_scene,
    "grid": test_scene_grid,
    "bezier": test_bezier,
    "simple_light": test_scene2,
    "cornell": cornell_box,
    "cornell_bezier": cornell_bezier,
    "cornell_smoke": cornell_smoke,
    "klein": klein_scene,
    "cornell_klein": cornell_klein,
    "random": random_scene,
    "points_chain": points_chain_scene,
}
