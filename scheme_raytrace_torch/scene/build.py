"""Scene compiler: host object list -> SoA `Scene` of tensors.

The port of scheme_raytrace_tpu/scene/build.py: closures/vtables become
flat, typed parameter arrays and the material/texture object graph becomes
integer-id tables.  The host-side flattening is the JAX module's, line for
line, in numpy; only the final arrays become torch tensors on `device`.
The float fields are the differentiable scene leaves (`partition`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import bvh as bvh_mod
from . import objects as ob
from ..config import resolve_device

# Texture type tags
TEX_CONSTANT = 0
TEX_CHECKER = 1
TEX_NOISE = 2
TEX_MARBLE = 3
TEX_IMAGE = 4

# Medium boundary kinds
MED_BOX = 0
MED_SPHERE = 1

# Light kinds (hittable-PDF targets, pdf.scm intent / bug B5)
LIGHT_XZ_RECT = 0
LIGHT_SPHERE = 1

_DATA_FIELDS = [
    # spheres (static & moving unified: center(t) lerped by ray time)
    "sph_c0", "sph_c1", "sph_t0", "sph_t1", "sph_r", "sph_mat", "sph_valid",
    # rects (with per-prim rigid transform for box instancing)
    "rect_axis", "rect_k", "rect_a0", "rect_a1", "rect_b0", "rect_b1",
    "rect_flip", "rect_mat", "rect_rot", "rect_trans", "rect_valid",
    # constant media
    "med_kind", "med_pmin", "med_pmax", "med_center", "med_radius",
    "med_rot", "med_trans", "med_neg_inv_d", "med_mat", "med_valid",
    # beziers
    "bez_cp", "bez_w", "bez_mat", "bez_valid",
    # klein fractals
    "kl_center", "kl_mat", "kl_valid",
    # materials
    "mat_type", "mat_tex", "mat_fuzz", "mat_ref",
    # textures
    "tex_type", "tex_color", "tex_child0", "tex_child1", "tex_scale",
    "tex_image", "tex_iw", "tex_ih", "images",
    # flat threaded BVH over spheres and rects (scene/bvh.py;
    # geometry.scm:217-374)
    "bvh_pmin", "bvh_pmax", "bvh_hit", "bvh_miss", "bvh_prims",
    # sky gradient endpoints (black sky = both zero)
    "sky_a", "sky_b",
    # light-sampling targets
    "light_kind", "light_rect", "light_center", "light_radius", "light_valid",
]
# integer id tables and validity masks; every other data field is float
_INT_FIELDS = {"sph_mat", "rect_axis", "rect_mat", "med_kind", "med_mat",
               "bez_mat", "kl_mat", "bvh_hit", "bvh_miss", "bvh_prims",
               "mat_type", "mat_tex", "tex_type", "tex_child0", "tex_child1",
               "tex_image", "tex_iw", "tex_ih", "light_kind"}
_BOOL_FIELDS = {"sph_valid", "rect_valid", "med_valid", "bez_valid",
                "kl_valid", "light_valid"}
_META_FIELDS = ["has_spheres", "has_rects", "has_media", "has_beziers",
                "has_klein", "n_lights", "has_perlin_tex", "has_image_tex",
                "has_checker_tex", "has_moving", "has_rect_xform", "has_bvh",
                "perlin_seed", "img_dims", "img_groups"]


@dataclasses.dataclass
class Scene:
    # -- data (tensors; float fields are the differentiable leaves) --
    sph_c0: torch.Tensor; sph_c1: torch.Tensor; sph_t0: torch.Tensor
    sph_t1: torch.Tensor; sph_r: torch.Tensor; sph_mat: torch.Tensor
    sph_valid: torch.Tensor
    rect_axis: torch.Tensor; rect_k: torch.Tensor
    rect_a0: torch.Tensor; rect_a1: torch.Tensor
    rect_b0: torch.Tensor; rect_b1: torch.Tensor
    rect_flip: torch.Tensor; rect_mat: torch.Tensor
    rect_rot: torch.Tensor; rect_trans: torch.Tensor; rect_valid: torch.Tensor
    med_kind: torch.Tensor; med_pmin: torch.Tensor; med_pmax: torch.Tensor
    med_center: torch.Tensor; med_radius: torch.Tensor
    med_rot: torch.Tensor; med_trans: torch.Tensor
    med_neg_inv_d: torch.Tensor; med_mat: torch.Tensor; med_valid: torch.Tensor
    bez_cp: torch.Tensor; bez_w: torch.Tensor; bez_mat: torch.Tensor
    bez_valid: torch.Tensor
    kl_center: torch.Tensor; kl_mat: torch.Tensor; kl_valid: torch.Tensor
    bvh_pmin: torch.Tensor; bvh_pmax: torch.Tensor
    bvh_hit: torch.Tensor; bvh_miss: torch.Tensor; bvh_prims: torch.Tensor
    mat_type: torch.Tensor; mat_tex: torch.Tensor
    mat_fuzz: torch.Tensor; mat_ref: torch.Tensor
    tex_type: torch.Tensor; tex_color: torch.Tensor
    tex_child0: torch.Tensor; tex_child1: torch.Tensor; tex_scale: torch.Tensor
    tex_image: torch.Tensor; tex_iw: torch.Tensor; tex_ih: torch.Tensor
    images: torch.Tensor
    sky_a: torch.Tensor; sky_b: torch.Tensor
    light_kind: torch.Tensor; light_rect: torch.Tensor
    light_center: torch.Tensor; light_radius: torch.Tensor
    light_valid: torch.Tensor
    # -- static metadata (selects which groups the integrator runs) --
    has_spheres: bool = False
    has_rects: bool = False
    has_media: bool = False
    has_beziers: bool = False
    has_klein: bool = False
    n_lights: int = 0
    has_perlin_tex: bool = False
    has_image_tex: bool = False
    has_checker_tex: bool = False
    has_moving: bool = False        # any sphere with center0 != center1
    has_rect_xform: bool = False    # any rect with a non-identity transform
    has_bvh: bool = False           # flat sphere BVH arrays populated
    perlin_seed: int = 0
    img_dims: tuple = ()     # ((ih, iw), ...) per image, atlas order
    img_groups: tuple = ()   # prim groups whose materials use an image tex

    @property
    def dtype(self) -> torch.dtype:
        return self.sph_c0.dtype

    @property
    def device(self) -> torch.device:
        return self.sph_c0.device

    def astype(self, dtype) -> "Scene":
        def cast(x):
            return x.to(dtype) if x.is_floating_point() else x
        data = {f: cast(getattr(self, f)) for f in _DATA_FIELDS}
        meta = {f: getattr(self, f) for f in _META_FIELDS}
        return Scene(**data, **meta)


def partition(scene: Scene):
    """Split a Scene into (float param dict, the Scene itself).

    The float fields are the differentiable scene parameters; reassemble
    with `combine` (the int/bool id tables stay in the Scene)."""
    params = {f: getattr(scene, f) for f in _DATA_FIELDS
              if getattr(scene, f).is_floating_point()}
    return params, scene


def combine(params: dict, scene: Scene) -> Scene:
    """Rebuild a Scene from `partition` output with (possibly new) params."""
    data = {f: params.get(f, getattr(scene, f)) for f in _DATA_FIELDS}
    meta = {f: getattr(scene, f) for f in _META_FIELDS}
    return Scene(**data, **meta)


def scene_from_arrays(arrays: dict, meta: dict, device=None,
                      dtype=torch.float32) -> Scene:
    """Scene from numpy arrays of the same fields (e.g. a JAX package Scene's
    `{f: np.asarray(getattr(scene, f)) for f in _DATA_FIELDS}`) plus its
    `_META_FIELDS`.  Id tables become int32, masks bool, and every other
    field `dtype`.  `device=None` is the card (config.resolve_device)."""
    device = resolve_device(device)

    def conv(f):
        t = (torch.bool if f in _BOOL_FIELDS
             else torch.int32 if f in _INT_FIELDS else dtype)
        return torch.tensor(np.asarray(arrays[f]), dtype=t, device=device)
    data = {f: conv(f) for f in _DATA_FIELDS}
    return Scene(**data, **{f: meta[f] for f in _META_FIELDS})


def params_from_arrays(arrays: dict, device=None,
                       dtype=torch.float32) -> dict:
    """A `partition` params dict from numpy arrays of the same names (e.g. a
    JAX package params dict's `{k: np.asarray(v)}`), each leaf `dtype` on
    `device` (None: the card)."""
    device = resolve_device(device)
    return {k: torch.tensor(np.asarray(v), dtype=dtype, device=device)
            for k, v in arrays.items()}


class _Registry:
    """Deduplicating id assignment for materials/textures during compile."""

    def __init__(self):
        self.items: List = []
        self._index = {}

    def add(self, item) -> int:
        key = id(item)
        if key in self._index:
            return self._index[key]
        idx = len(self.items)
        self.items.append(item)
        self._index[key] = idx
        return idx


def _compile_textures(texs: _Registry):
    """Flatten the (depth<=2: checker-of-constants) texture graph (numpy)."""
    i = 0
    while i < len(texs.items):
        t = texs.items[i]
        if isinstance(t, ob.CheckerTexture):
            texs.add(t.even)
            texs.add(t.odd)
        i += 1
    n = max(len(texs.items), 1)
    tex_type = np.zeros(n, np.int32)
    tex_color = np.zeros((n, 3), np.float64)
    child0 = np.zeros(n, np.int32)
    child1 = np.zeros(n, np.int32)
    scale = np.ones(n, np.float64)
    tex_image = np.zeros(n, np.int32)
    tex_iw = np.ones(n, np.int32)
    tex_ih = np.ones(n, np.int32)
    images: List[np.ndarray] = []
    for i, t in enumerate(texs.items):
        if isinstance(t, ob.ConstantTexture):
            tex_type[i] = TEX_CONSTANT
            tex_color[i] = np.asarray(t.color, np.float64)
        elif isinstance(t, ob.CheckerTexture):
            tex_type[i] = TEX_CHECKER
            child0[i] = texs.add(t.even)   # even when sines >= 0
            child1[i] = texs.add(t.odd)    # odd when sines < 0
        elif isinstance(t, ob.NoiseTexture):
            tex_type[i] = TEX_NOISE
            scale[i] = t.scale
        elif isinstance(t, ob.MarbleTexture):
            tex_type[i] = TEX_MARBLE
            scale[i] = t.scale
        elif isinstance(t, ob.ImageTexture):
            tex_type[i] = TEX_IMAGE
            img = np.asarray(t.data)
            if img.dtype == np.uint8:
                # texture.scm:45-50: floor(byte)/255
                img = img.astype(np.float64) / 255.0
            tex_ih[i], tex_iw[i] = img.shape[0], img.shape[1]
            tex_image[i] = len(images)
            images.append(img.astype(np.float64))
        else:
            raise TypeError(f"unknown texture {t!r}")
    if images:
        hmax = max(im.shape[0] for im in images)
        wmax = max(im.shape[1] for im in images)
        atlas = np.zeros((len(images), hmax, wmax, 3), np.float64)
        for k, im in enumerate(images):
            atlas[k, :im.shape[0], :im.shape[1]] = im
    else:
        atlas = np.zeros((1, 1, 1, 3), np.float64)
    return dict(tex_type=tex_type, tex_color=tex_color, tex_child0=child0,
                tex_child1=child1, tex_scale=scale, tex_image=tex_image,
                tex_iw=tex_iw, tex_ih=tex_ih, images=atlas)


def _mat_record(m: ob.Material, texs: _Registry):
    if isinstance(m, ob.Lambertian):
        return ob.MAT_LAMBERTIAN, texs.add(m.albedo), 0.0, 1.0
    if isinstance(m, ob.Metal):
        # metal fuzz is used as-is; reference never clamps (material.scm:45-57)
        return ob.MAT_METAL, texs.add(m.albedo), float(m.fuzz), 1.0
    if isinstance(m, ob.Dielectric):
        return ob.MAT_DIELECTRIC, 0, 0.0, float(m.ref_idx)
    if isinstance(m, ob.DiffuseLight):
        return ob.MAT_DIFFUSE_LIGHT, texs.add(m.emit), 0.0, 1.0
    if isinstance(m, ob.Isotropic):
        return ob.MAT_ISOTROPIC, texs.add(m.albedo), 0.0, 1.0
    raise TypeError(f"unknown material {m!r}")


def _box_rects(pmin, pmax, material):
    """geometry.scm:444-463 — a box is 6 rects, min-side faces flipped."""
    x0, y0, z0 = pmin
    x1, y1, z1 = pmax
    return [
        ob.xy_rect(x0, x1, y0, y1, z1, material),
        ob.xy_rect(x0, x1, y0, y1, z0, material, flip=True),
        ob.xz_rect(x0, x1, z0, z1, y1, material),
        ob.xz_rect(x0, x1, z0, z1, y0, material, flip=True),
        ob.yz_rect(y0, y1, z0, z1, x1, material),
        ob.yz_rect(y0, y1, z0, z1, x0, material, flip=True),
    ]


def compile_scene(objs: Sequence[ob.Hittable], sky: str = "black",
                  dtype=torch.float32, perlin_seed: int = 0,
                  lights: Optional[Sequence[ob.Hittable]] = None,
                  bvh: Optional[str] = None, bvh_seed: int = 0,
                  device=None) -> Scene:
    """Flatten a hittable list into the SoA Scene on `device` (None: the
    card; "cpu" for the plain PyTorch path, config.resolve_device).

    `sky`: "gradient" (main.scm:91-95) or "black" (main.scm:97-98).
    `lights`: hittables to importance-sample (xz-rects/spheres); default:
    auto-detect primitives with DiffuseLight material.
    `bvh`: None (brute-force sweeps), "median" (geometry.scm:217-260) or
    "sah" (geometry.scm:282-374) — builds a flat threaded BVH over the
    spheres and rects, traversed when RenderConfig.traversal == "bvh".
    """
    mats = _Registry()
    texs = _Registry()

    spheres, rects, media, bezs, kleins = [], [], [], [], []
    auto_lights = []

    def add_obj(obj, outer_xf=ob.Xform.identity(), outer_flip=False):
        core, xf, flip = ob.unwrap(obj)
        xf = xf.compose_outer(outer_xf)
        flip = flip ^ outer_flip
        if isinstance(core, ob.Box):
            for r in _box_rects(np.asarray(core.pmin, np.float64),
                                np.asarray(core.pmax, np.float64),
                                core.material):
                add_obj(r, xf, flip)
        elif isinstance(core, ob.Rect):
            mid = mats.add(core.material)
            rects.append((core, xf, flip ^ core.flip, mid))
            if isinstance(core.material, ob.DiffuseLight):
                auto_lights.append(("rect", core, xf))
        elif isinstance(core, (ob.Sphere, ob.MovingSphere)):
            mid = mats.add(core.material)
            # bake the rigid transform into the sphere's center(s)
            if isinstance(core, ob.Sphere):
                c0 = xf.rot @ np.asarray(core.center, np.float64) + xf.trans
                rec = (c0, c0, 0.0, 1.0, float(core.radius), mid)
            else:
                c0 = xf.rot @ np.asarray(core.center0, np.float64) + xf.trans
                c1 = xf.rot @ np.asarray(core.center1, np.float64) + xf.trans
                rec = (c0, c1, float(core.time0), float(core.time1),
                       float(core.radius), mid)
            spheres.append(rec)
            if isinstance(core.material, ob.DiffuseLight):
                auto_lights.append(("sphere", (rec[0], rec[4]), xf))
        elif isinstance(core, ob.ConstantMedium):
            phase_cls = (ob.Lambertian if core.phase == "lambertian"
                         else ob.Isotropic)
            mid = mats.add(phase_cls(core.albedo))
            b_core, b_xf, _ = ob.unwrap(core.boundary)
            b_xf = b_xf.compose_outer(xf)
            if isinstance(b_core, ob.Box):
                media.append((MED_BOX,
                              np.asarray(b_core.pmin, np.float64),
                              np.asarray(b_core.pmax, np.float64),
                              np.zeros(3), 1.0, b_xf,
                              -1.0 / float(core.density), mid))
            elif isinstance(b_core, ob.Sphere):
                c = b_xf.rot @ np.asarray(b_core.center, np.float64) + b_xf.trans
                media.append((MED_SPHERE, np.zeros(3), np.zeros(3),
                              c, float(b_core.radius), ob.Xform.identity(),
                              -1.0 / float(core.density), mid))
            else:
                raise TypeError("ConstantMedium boundary must be Box or Sphere")
        elif isinstance(core, ob.Bezier):
            mid = mats.add(core.material)
            cp = np.asarray(core.cp, np.float64) @ xf.rot.T + xf.trans
            bezs.append((cp, float(core.width), mid))
        elif isinstance(core, ob.Klein):
            mid = mats.add(core.material)
            c = xf.rot @ np.asarray(core.center, np.float64) + xf.trans
            kleins.append((c, mid))
        elif isinstance(core, (list, tuple)):
            for o in core:
                add_obj(o, xf, flip)
        else:
            raise TypeError(f"unknown hittable {core!r}")

    for o in objs:
        add_obj(o)

    # ---- materials & textures --------------------------------------------
    mrecs = [_mat_record(m, texs) for m in mats.items] or [(0, 0, 0.0, 1.0)]
    tex_fields = _compile_textures(texs)
    mat_type = np.array([r[0] for r in mrecs], np.int32)
    mat_tex = np.array([r[1] for r in mrecs], np.int32)
    mat_fuzz = np.array([r[2] for r in mrecs], np.float64)
    mat_ref = np.array([r[3] for r in mrecs], np.float64)

    # ---- primitive groups (each padded to >=1 row, mask `*_valid`) -------
    def pad(lst, n_fields_builder, empty_builder):
        if lst:
            return n_fields_builder(lst), np.ones(len(lst), bool)
        return empty_builder(), np.zeros(1, bool)

    def build_sph(lst):
        return (np.stack([r[0] for r in lst]), np.stack([r[1] for r in lst]),
                np.array([r[2] for r in lst]), np.array([r[3] for r in lst]),
                np.array([r[4] for r in lst]),
                np.array([r[5] for r in lst], np.int32))
    def empty_sph():
        z3 = np.zeros((1, 3))
        return (z3, z3, np.zeros(1), np.ones(1), np.ones(1),
                np.zeros(1, np.int32))
    (sph_c0, sph_c1, sph_t0, sph_t1, sph_r, sph_mat), sph_valid = pad(
        spheres, build_sph, empty_sph)

    def build_rect(lst):
        axis = np.array([r.axis for (r, _, _, _) in lst], np.int32)
        k = np.array([r.k for (r, _, _, _) in lst])
        a0 = np.array([r.a0 for (r, _, _, _) in lst])
        a1 = np.array([r.a1 for (r, _, _, _) in lst])
        b0 = np.array([r.b0 for (r, _, _, _) in lst])
        b1 = np.array([r.b1 for (r, _, _, _) in lst])
        flip = np.array([-1.0 if fl else 1.0 for (_, _, fl, _) in lst])
        mid = np.array([m for (_, _, _, m) in lst], np.int32)
        rot = np.stack([xf.rot for (_, xf, _, _) in lst])
        trans = np.stack([xf.trans for (_, xf, _, _) in lst])
        return axis, k, a0, a1, b0, b1, flip, mid, rot, trans
    def empty_rect():
        return (np.zeros(1, np.int32), np.zeros(1), np.zeros(1), np.ones(1),
                np.zeros(1), np.ones(1), np.ones(1), np.zeros(1, np.int32),
                np.eye(3)[None], np.zeros((1, 3)))
    (rect_axis, rect_k, rect_a0, rect_a1, rect_b0, rect_b1, rect_flip,
     rect_mat, rect_rot, rect_trans), rect_valid = pad(
        rects, build_rect, empty_rect)

    def build_med(lst):
        return (np.array([m[0] for m in lst], np.int32),
                np.stack([m[1] for m in lst]), np.stack([m[2] for m in lst]),
                np.stack([m[3] for m in lst]), np.array([m[4] for m in lst]),
                np.stack([m[5].rot for m in lst]),
                np.stack([m[5].trans for m in lst]),
                np.array([m[6] for m in lst]),
                np.array([m[7] for m in lst], np.int32))
    def empty_med():
        z3 = np.zeros((1, 3))
        return (np.zeros(1, np.int32), z3, np.ones((1, 3)), z3, np.ones(1),
                np.eye(3)[None], np.zeros((1, 3)), -np.ones(1),
                np.zeros(1, np.int32))
    (med_kind, med_pmin, med_pmax, med_center, med_radius, med_rot,
     med_trans, med_neg_inv_d, med_mat), med_valid = pad(
        media, build_med, empty_med)

    def build_bez(lst):
        return (np.stack([b[0] for b in lst]),
                np.array([b[1] for b in lst]),
                np.array([b[2] for b in lst], np.int32))
    def empty_bez():
        return (np.zeros((1, 4, 3)), np.ones(1), np.zeros(1, np.int32))
    (bez_cp, bez_w, bez_mat), bez_valid = pad(bezs, build_bez, empty_bez)

    def build_kl(lst):
        return (np.stack([k[0] for k in lst]),
                np.array([k[1] for k in lst], np.int32))
    def empty_kl():
        return (np.zeros((1, 3)), np.zeros(1, np.int32))
    (kl_center, kl_mat), kl_valid = pad(kleins, build_kl, empty_kl)

    # ---- lights ------------------------------------------------------------
    light_specs = []
    if lights is not None:
        for lo in lights:
            core, xf, _ = ob.unwrap(lo)
            if isinstance(core, ob.Rect) and core.axis == 1:
                light_specs.append(("rect", core, xf))
            elif isinstance(core, ob.Sphere):
                c = xf.rot @ np.asarray(core.center, np.float64) + xf.trans
                light_specs.append(("sphere", (c, float(core.radius)), xf))
            else:
                raise TypeError("light-sampling targets must be xz-rects or spheres")
    else:
        light_specs = [(k, o, xf) for (k, o, xf) in auto_lights
                       if (k == "sphere" or (k == "rect" and o.axis == 1))]

    n_lights = len(light_specs)
    nl = max(n_lights, 1)
    light_kind = np.zeros(nl, np.int32)
    light_rect = np.zeros((nl, 5))
    light_center = np.zeros((nl, 3))
    light_radius = np.ones(nl)
    light_valid = np.zeros(nl, bool)
    for i, (kind, o, xf) in enumerate(light_specs):
        light_valid[i] = True
        if kind == "rect":
            light_kind[i] = LIGHT_XZ_RECT
            # xz-rect: (a0,a1)=(x0,x1), (b0,b1)=(z0,z1), y=k; light rects
            # carry no transform (none exist in the reference scenes)
            if not (np.allclose(xf.rot, np.eye(3))
                    and np.allclose(xf.trans, 0)):
                raise ValueError("light rects must not be transformed")
            light_rect[i] = (o.a0, o.a1, o.b0, o.b1, o.k)
        else:
            light_kind[i] = LIGHT_SPHERE
            c, r = o
            light_center[i] = c
            light_radius[i] = r

    # ---- sky ----------------------------------------------------------------
    if sky == "gradient":
        sky_a, sky_b = np.ones(3), np.array([0.5, 0.7, 1.0])
    elif sky == "black":
        sky_a, sky_b = np.zeros(3), np.zeros(3)
    else:
        sky_a, sky_b = np.asarray(sky[0], np.float64), np.asarray(sky[1], np.float64)

    # ---- analytic-prim BVH (optional) ---------------------------------------
    # Global prim ids: spheres [0, nS), rects [nS, nS + nR) — one tree over
    # both groups (beziers and the klein keep their own sweeps).
    has_bvh = bvh is not None and bool(spheres or rects)
    if has_bvh:
        parts_min, parts_max = [], []
        if spheres:
            s_pmin, s_pmax = bvh_mod.sphere_bounds(sph_c0, sph_c1, sph_r)
            parts_min.append(s_pmin)
            parts_max.append(s_pmax)
        if rects:
            r_pmin, r_pmax = bvh_mod.rect_bounds(
                rect_axis, rect_k, rect_a0, rect_a1, rect_b0, rect_b1,
                rect_rot, rect_trans)
            parts_min.append(r_pmin)
            parts_max.append(r_pmax)
        b_pmin = np.concatenate(parts_min)
        b_pmax = np.concatenate(parts_max)
        flat = (bvh_mod.build_sah(b_pmin, b_pmax) if bvh == "sah"
                else bvh_mod.build_median(b_pmin, b_pmax, bvh_seed))
        bvh_arrays = (flat.pmin, flat.pmax, flat.hit_link, flat.miss_link,
                      flat.prims)
    else:
        bvh_arrays = (np.zeros((1, 3)), np.zeros((1, 3)),
                      np.full(1, -1, np.int32), np.full(1, -1, np.int32),
                      np.full((1, 4), -1, np.int32))

    arrays = dict(
        sph_c0=sph_c0, sph_c1=sph_c1, sph_t0=sph_t0, sph_t1=sph_t1,
        sph_r=sph_r, sph_mat=sph_mat, sph_valid=sph_valid,
        rect_axis=rect_axis, rect_k=rect_k, rect_a0=rect_a0, rect_a1=rect_a1,
        rect_b0=rect_b0, rect_b1=rect_b1, rect_flip=rect_flip,
        rect_mat=rect_mat, rect_rot=rect_rot, rect_trans=rect_trans,
        rect_valid=rect_valid,
        med_kind=med_kind, med_pmin=med_pmin, med_pmax=med_pmax,
        med_center=med_center, med_radius=med_radius, med_rot=med_rot,
        med_trans=med_trans, med_neg_inv_d=med_neg_inv_d, med_mat=med_mat,
        med_valid=med_valid,
        bez_cp=bez_cp, bez_w=bez_w, bez_mat=bez_mat, bez_valid=bez_valid,
        kl_center=kl_center, kl_mat=kl_mat, kl_valid=kl_valid,
        bvh_pmin=bvh_arrays[0], bvh_pmax=bvh_arrays[1],
        bvh_hit=bvh_arrays[2], bvh_miss=bvh_arrays[3],
        bvh_prims=bvh_arrays[4],
        mat_type=mat_type, mat_tex=mat_tex, mat_fuzz=mat_fuzz,
        mat_ref=mat_ref, **tex_fields,
        sky_a=sky_a, sky_b=sky_b,
        light_kind=light_kind, light_rect=light_rect,
        light_center=light_center, light_radius=light_radius,
        light_valid=light_valid)
    meta = dict(
        has_spheres=bool(spheres), has_rects=bool(rects),
        has_media=bool(media), has_beziers=bool(bezs),
        has_klein=bool(kleins), n_lights=n_lights,
        has_perlin_tex=any(isinstance(t, (ob.NoiseTexture, ob.MarbleTexture))
                           for t in texs.items),
        has_image_tex=any(isinstance(t, ob.ImageTexture) for t in texs.items),
        has_checker_tex=any(isinstance(t, ob.CheckerTexture)
                            for t in texs.items),
        has_moving=bool(spheres) and not np.allclose(
            np.stack([r[0] for r in spheres]),
            np.stack([r[1] for r in spheres])),
        has_rect_xform=bool(rects) and not all(
            np.allclose(xf.rot, np.eye(3)) and np.allclose(xf.trans, 0.0)
            for (_, xf, _, _) in rects),
        has_bvh=has_bvh,
        perlin_seed=perlin_seed,
        img_dims=tuple(
            (int(np.asarray(t.data).shape[0]), int(np.asarray(t.data).shape[1]))
            for t in texs.items if isinstance(t, ob.ImageTexture)),
        img_groups=tuple(sorted(
            group for group, mids in (
                ("sphere", [r[5] for r in spheres]),
                ("rect", [m for (_, _, _, m) in rects]),
                ("medium", [m[7] for m in media]),
                ("bezier", [b[2] for b in bezs]),
                ("klein", [k[1] for k in kleins]))
            if texs.items and any(
                isinstance(texs.items[mrecs[m][1]], ob.ImageTexture)
                for m in set(mids)))),
    )
    return scene_from_arrays(arrays, meta, device=device, dtype=dtype)
