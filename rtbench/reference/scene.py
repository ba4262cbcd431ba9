"""A configuration's scene, from its JSON, as the reference's own arrays.

The configuration file (rtbench/configs/<name>.json) describes the scene as
the reference scene library does: materials by name, and a list of rects,
boxes (six rects, optionally rotated about +y, then translated), spheres,
cubic Bezier ribbons and Kleinian limit-set fractals (a centre each).
`compile_scene` flattens it into named arrays: the float arrays are the
differentiable parameters a training step updates, under the names the
renderer's own scene compiler gives them (`rect_k`, `rect_rot`,
`kl_center`, `tex_color`, `sky_a`, ...), so that a step's update can be
compared leaf by leaf.  The reference derives everything from the JSON
here; it takes no array from the program under test.

Materials are Lambertian (constant or checker albedo) and diffuse lights;
the sky is the gradient or black.  Lights are the scene's xz-rects whose
material emits.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

MAT_LAMBERTIAN, MAT_DIFFUSE_LIGHT = 0, 3     # the renderer's material ids
TEX_CONSTANT, TEX_CHECKER = 0, 1             # and texture ids

# the float arrays a training step updates, and the id tables beside them
LEAVES = ("rect_k", "rect_a0", "rect_a1", "rect_b0", "rect_b1", "rect_flip",
          "rect_rot", "rect_trans", "sph_c0", "sph_r", "bez_cp", "bez_w",
          "kl_center", "tex_color", "sky_a", "sky_b", "light_rect")


@dataclasses.dataclass
class RefScene:
    leaves: dict          # name -> float tensor (the parameters)
    rect_axis: np.ndarray     # [R] 0 yz, 1 xz, 2 xy
    rect_mat: np.ndarray
    sph_mat: np.ndarray
    bez_mat: np.ndarray
    kl_mat: np.ndarray
    mat_type: np.ndarray
    mat_tex: np.ndarray
    tex_type: np.ndarray
    tex_child0: np.ndarray
    tex_child1: np.ndarray
    n_lights: int
    camera: dict

    @property
    def n_rects(self):
        return len(self.rect_axis)

    @property
    def n_spheres(self):
        return len(self.sph_mat)

    @property
    def n_beziers(self):
        return len(self.bez_mat)

    @property
    def n_kleins(self):
        return len(self.kl_mat)


def rot_y(deg: float) -> np.ndarray:
    """Object-to-world rotation about +y by `deg` degrees."""
    r = math.radians(deg)
    c, s = math.cos(r), math.sin(r)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


PLANES = {"yz": 0, "xz": 1, "xy": 2}


def box_faces(pmin, pmax):
    """The six faces of a box as (plane, a, b, k, flipped), the min-side
    faces flipped, in the order a box is made of them."""
    (x0, y0, z0), (x1, y1, z1) = pmin, pmax
    return [("xy", (x0, x1), (y0, y1), z1, False),
            ("xy", (x0, x1), (y0, y1), z0, True),
            ("xz", (x0, x1), (z0, z1), y1, False),
            ("xz", (x0, x1), (z0, z1), y0, True),
            ("yz", (y0, y1), (z0, z1), x1, False),
            ("yz", (y0, y1), (z0, z1), x0, True)]


def _xform(obj):
    """(rot, trans) of an object: rotate about +y, then translate."""
    rot = rot_y(obj["rotate_y"]) if "rotate_y" in obj else np.eye(3)
    trans = np.asarray(obj.get("translate", (0.0, 0.0, 0.0)), np.float64)
    return rot, trans


def compile_scene(cfg: dict, dtype=torch.float32, device="cpu") -> RefScene:
    """Flatten the configuration's scene into a RefScene on `device`."""
    mat_names, textures, tex_ids = [], [], {}

    def material(name):
        if name not in mat_names:
            mat_names.append(name)
        return mat_names.index(name)

    rects, spheres, beziers, kleins, lights = [], [], [], [], []
    for obj in cfg["objects"]:
        mid = material(obj["material"])
        if "rect" in obj or "box" in obj:
            rot, trans = _xform(obj)
            flip = bool(obj.get("flip_normals", False))
            if "rect" in obj:
                r = obj["rect"]
                faces = [(r["plane"], r["a"], r["b"], r["k"], False)]
            else:
                faces = box_faces(obj["box"]["min"], obj["box"]["max"])
            for plane, a, b, k, fl in faces:
                rects.append((PLANES[plane], a, b, k, flip ^ fl, mid, rot,
                              trans))
            emits = "diffuse_light" in cfg["materials"][obj["material"]]
            if "rect" in obj and emits and obj["rect"]["plane"] == "xz":
                if "rotate_y" in obj or "translate" in obj:
                    raise ValueError("a light rect takes no transform")
                r = obj["rect"]
                lights.append((*r["a"], *r["b"], r["k"]))
        elif "sphere" in obj:
            s = obj["sphere"]
            spheres.append((s["center"], s["radius"], mid))
        elif "bezier" in obj:
            b = obj["bezier"]
            beziers.append((b["points"], b["width"], mid))
        elif "klein" in obj:
            if "rotate_y" in obj or "translate" in obj:
                raise ValueError("a klein takes no transform: move its centre")
            kleins.append((obj["klein"]["center"], mid))
        else:
            raise ValueError(f"unknown object {obj!r}")

    # materials, then their textures in the order materials name them, then
    # a checker's two children after every material's own
    mat_type, mat_tex = [], []
    for name in mat_names:
        m = cfg["materials"][name]
        kind = "lambertian" if "lambertian" in m else "diffuse_light"
        if kind not in m or len(m) != 1:
            raise ValueError(f"material {name}: one of lambertian, "
                             f"diffuse_light")
        mat_type.append(MAT_LAMBERTIAN if kind == "lambertian"
                        else MAT_DIFFUSE_LIGHT)
        textures.append(m[kind])
        mat_tex.append(len(textures) - 1)
    tex_type, tex_color = [], []
    child0, child1 = [], []
    pending = []
    for t in textures:
        if isinstance(t, dict):
            tex_type.append(TEX_CHECKER)
            tex_color.append((0.0, 0.0, 0.0))
            pending.append(len(tex_type) - 1)
            child0.append(0)
            child1.append(0)
        else:
            tex_type.append(TEX_CONSTANT)
            tex_color.append(tuple(t))
            child0.append(0)
            child1.append(0)
    for i in pending:
        chk = textures[i]
        for side, child in (("even", child0), ("odd", child1)):
            tex_type.append(TEX_CONSTANT)
            tex_color.append(tuple(chk[side]))
            child0.append(0)
            child1.append(0)
            child[i] = len(tex_type) - 1

    f = lambda x: torch.tensor(np.asarray(x, np.float64), dtype=dtype,
                               device=device)
    leaves = {}
    if rects:
        leaves.update(
            rect_k=f([r[3] for r in rects]),
            rect_a0=f([r[1][0] for r in rects]),
            rect_a1=f([r[1][1] for r in rects]),
            rect_b0=f([r[2][0] for r in rects]),
            rect_b1=f([r[2][1] for r in rects]),
            rect_flip=f([-1.0 if r[4] else 1.0 for r in rects]),
            rect_rot=f(np.stack([r[6] for r in rects])),
            rect_trans=f(np.stack([r[7] for r in rects])))
    if spheres:
        leaves.update(sph_c0=f([s[0] for s in spheres]),
                      sph_r=f([s[1] for s in spheres]))
    if beziers:
        leaves.update(bez_cp=f([b[0] for b in beziers]),
                      bez_w=f([b[1] for b in beziers]))
    if kleins:
        leaves["kl_center"] = f([k[0] for k in kleins])
    leaves["tex_color"] = f(tex_color)
    if cfg.get("sky", "black") == "gradient":
        leaves.update(sky_a=f((1.0, 1.0, 1.0)), sky_b=f((0.5, 0.7, 1.0)))
    else:
        leaves.update(sky_a=f((0.0,) * 3), sky_b=f((0.0,) * 3))
    if lights:
        leaves["light_rect"] = f(lights)
    i32 = lambda x: np.asarray(x, np.int64)
    return RefScene(
        leaves=leaves,
        rect_axis=i32([r[0] for r in rects]), rect_mat=i32([r[5] for r in rects]),
        sph_mat=i32([s[2] for s in spheres]), bez_mat=i32([b[2] for b in beziers]),
        kl_mat=i32([k[1] for k in kleins]),
        mat_type=i32(mat_type), mat_tex=i32(mat_tex), tex_type=i32(tex_type),
        tex_child0=i32(child0), tex_child1=i32(child1), n_lights=len(lights),
        camera=dict(cfg["camera"]))
