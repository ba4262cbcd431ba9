"""Fused SoA bounce step: ray regen + intersect + shade in one pass.

The port of scheme_raytrace_tpu/integrator/bounce.py.  Every per-lane
quantity is its own [M] tensor (x, y, z separate), and the scene is packed
into one flat "constant buffer" `pk` whose offsets are static, so the
closest-hit sweep merges the winning primitive's material as it goes
instead of gathering it afterwards.

Two implementations of one step, picked by the device of the tensors:
  * `step` — plain PyTorch, op for op the JAX `step` (so an f64 CPU run
    matches the JAX package to round-off), used for CPU tensors and as the
    oracle of the kernel;
  * `step_cuda` — the hand-written CUDA kernel csrc/bounce_step.cu (the
    port of the Pallas megakernel `as_pallas`), used for CUDA tensors.  It
    takes what `pack` gives for a `pool_plan` plan: `pk`, or `(pk, atlas)`
    with the image texel planes; never the sphere attribute atlas.

Coverage (both implementations, every group of the JAX step): rects,
spheres (static and moving, any count), the Kleinian limit-set fractal
(sphere-traced, any count), cubic Bezier ribbons (any count), constant media
in box and sphere boundaries, xz-rect and sphere lights with mixture-PDF
light sampling, constant, checker, hash-Perlin noise and marble and image
albedo, emission, gradient/black sky, lambertian/metal/dielectric.  The
kernels are built per feature set (`kernel_features`): a plan's variant
holds the code of the groups it has and no other.  K1 and its backward run
each lane on a tile of `tile_width(plan)` threads, over which the
closest-hit sweeps split; every width gives the same lanes bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from .. import config as cfg_mod
from ..camera import _basis
from ..core import rng
from ..core import vecmath as vm
from ..scene import build as sb
from ..scene import objects as ob
from ..scene import perlin as perlin_mod
from ..utils import telemetry

_PI = math.pi
_TWO_PI = 2.0 * _PI

# ---------------------------------------------------------------------------
# SoA vec helpers: a "vector" is a (x, y, z) tuple of same-shape tensors
# ---------------------------------------------------------------------------


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def add3(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub3(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def scale3(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def mul3(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def where3(m, a, b):
    return tuple(torch.where(m, x, y) for x, y in zip(a, b))


# jnp.maximum / jnp.clip against a constant, with JAX's tie gradients
_max = vm.maximum
_clip = vm.clip


def unit3(a, eps=1e-12):
    inv = torch.rsqrt(_max(dot3(a, a), eps))
    return scale3(a, inv)


# ---------------------------------------------------------------------------
# Packed-scene layout (static offsets; one flat float vector).  The CUDA
# kernel repeats these offsets; tests/test_torch_bounce.py holds them equal.
# ---------------------------------------------------------------------------

# header fields
H_SKY_A, H_SKY_B = 0, 3
H_CAM_O, H_CAM_LL, H_CAM_H, H_CAM_V, H_CAM_U, H_CAM_VV = 6, 9, 12, 15, 18, 21
H_LENS_R, H_T0, H_DT = 24, 25, 26
HDR_SIZE = 27

# per-rect fields — oriented world-space plane (instancing baked at pack
# time): normal WN, plane constant K, in-plane edge axes A/B with ranges
R_WN, R_K, R_A, R_KA0, R_KA1, R_B, R_KB0, R_KB1, R_VALID = (
    0, 3, 4, 7, 8, 9, 12, 13, 14)
# TEXK = texture kind as float (scene.build TEX_* ids); TEXS = procedural
# texture scale
R_MTYPE, R_ALB0, R_ALB1, R_TEXK, R_FUZZ, R_REF, R_TEXS = (
    15, 16, 19, 22, 23, 24, 25)
RECT_SIZE = 26

# per-sphere fields
S_C0, S_C1, S_T0, S_T1, S_R, S_VALID = 0, 3, 6, 7, 8, 9
S_MTYPE, S_ALB0, S_ALB1, S_TEXK, S_FUZZ, S_REF, S_TEXS = (
    10, 11, 14, 17, 18, 19, 20)
SPH_SIZE = 21

# per-light fields
L_KIND, L_X0, L_X1, L_Z0, L_Z1, L_KY, L_C, L_RAD, L_VALID = (
    0, 1, 2, 3, 4, 5, 6, 9, 10)
LGT_SIZE = 11

# per-medium fields: oriented 3-slab box or sphere boundary; M_NID = -1/rho
M_KIND = 0
M_AX = 1                        # 3 x (axis vec3, lo, hi) = 15 floats
M_C, M_RAD = 16, 19
M_NID, M_VALID = 20, 21
M_MTYPE, M_ALB0, M_ALB1, M_TEXK, M_FUZZ, M_REF, M_TEXS = (
    22, 23, 26, 29, 30, 31, 32)
MED_SIZE = 33

# per-klein fields: center + material
K_C, K_VALID = 0, 3
K_MTYPE, K_ALB0, K_ALB1, K_TEXK, K_FUZZ, K_REF, K_TEXS = (
    4, 5, 8, 11, 12, 13, 14)
KL_SIZE = 15

# per-bezier fields: 4 control points + ribbon width
B_CP, B_W, B_VALID = 0, 12, 13
B_MTYPE, B_ALB0, B_ALB1, B_TEXK, B_FUZZ, B_REF, B_TEXS = (
    14, 15, 18, 21, 22, 23, 24)
BEZ_SIZE = 25


@dataclasses.dataclass(frozen=True)
class BouncePlan:
    """Static shape/flag info for one (scene, config) pair."""
    n_rects: int
    n_spheres: int
    n_lights: int
    has_moving: bool
    light_sampling: bool
    has_perlin: bool
    perlin_seed: int
    nx: int
    ny: int
    total_pix: int
    max_depth: int
    seed: int
    dtype: str
    n_media: int = 0
    n_kleins: int = 0
    n_beziers: int = 0
    bez_seeds: int = 32
    bez_newton: int = 8
    img_dims: tuple = ()
    # large sphere groups: the winner's attributes come from an atlas of the
    # packed sphere block's columns (see pack)
    attr_sweep: bool = False
    size: int = 0

    @property
    def has_image(self) -> bool:
        return bool(self.img_dims)

    @property
    def sph_chunks(self) -> int:
        """128-sphere chunks of the attribute atlas."""
        return -(-self.n_spheres // 128)

    @property
    def attr_rows(self) -> int:
        return SPH_SIZE * self.sph_chunks if self.attr_sweep else 0

    @property
    def atlas_rows(self) -> int:
        """Total atlas rows: image texel planes, then sphere attributes."""
        return self.img_rows + self.attr_rows

    @property
    def has_atlas(self) -> bool:
        return self.has_image or self.attr_sweep

    @property
    def img_chunks(self):
        """Per-image chunk count (128-texel rows per channel)."""
        return tuple(-(-(ih * iw) // 128) for ih, iw in self.img_dims)

    @property
    def img_bases(self):
        """First atlas row of each image (3 channel planes per image)."""
        bases, acc = [], 0
        for nck in self.img_chunks:
            bases.append(acc)
            acc += 3 * nck
        return tuple(bases)

    @property
    def img_rows(self) -> int:
        return 3 * sum(self.img_chunks)

    def __post_init__(self):
        object.__setattr__(
            self, "size",
            HDR_SIZE + self.n_rects * RECT_SIZE
            + self.n_spheres * SPH_SIZE + self.n_lights * LGT_SIZE
            + self.n_media * MED_SIZE + self.n_kleins * KL_SIZE
            + self.n_beziers * BEZ_SIZE)

    @property
    def rect_base(self):
        return HDR_SIZE

    @property
    def sph_base(self):
        return HDR_SIZE + self.n_rects * RECT_SIZE

    @property
    def lgt_base(self):
        return self.sph_base + self.n_spheres * SPH_SIZE

    @property
    def med_base(self):
        return self.lgt_base + self.n_lights * LGT_SIZE

    @property
    def kl_base(self):
        return self.med_base + self.n_media * MED_SIZE

    @property
    def bez_base(self):
        return self.kl_base + self.n_kleins * KL_SIZE


# Sweep and routing constants of the JAX package (TPU-tuned; the port
# re-sweeps them on the GPU once the groups that read them are ported).
# UNROLL_MAX only decides `make_plan`'s attr_sweep, as there: the port's
# sweeps have one form for any count.
UNROLL_MAX = 64
MAX_FUSED_PRIMS = 4096
IMG_ROWS_MAX = 48


def pallas_ok(plan: BouncePlan) -> bool:
    """Fused-kernel eligibility of the JAX package: bounded counts of the
    exotic groups (the JAX routing bound; the port's media, klein and bezier
    loops take any count)."""
    return (plan.n_media <= 16 and plan.n_kleins <= 2
            and plan.n_beziers <= 8)


def supported(scene, config) -> bool:
    """True when the fused SoA bounce covers this (scene, config) — the
    JAX package's routing predicate, unchanged."""
    n_prims = ((int(scene.rect_k.shape[0]) if scene.has_rects else 0)
               + (int(scene.sph_r.shape[0]) if scene.has_spheres else 0))
    if scene.has_image_tex:
        rows = 3 * sum(-(-(ih * iw) // 128) for ih, iw in scene.img_dims)
        if (not set(scene.img_groups) <= {"sphere", "rect"}
                or rows > IMG_ROWS_MAX):
            return False
    return not (config.russian_roulette or config.traversal == "bvh"
                or config.material_sort
                or n_prims > MAX_FUSED_PRIMS)


def make_plan(scene, config) -> BouncePlan:
    return BouncePlan(
        n_rects=int(scene.rect_k.shape[0]) if scene.has_rects else 0,
        n_spheres=int(scene.sph_r.shape[0]) if scene.has_spheres else 0,
        n_lights=scene.n_lights if config.light_sampling else 0,
        has_moving=scene.has_moving,
        light_sampling=config.light_sampling and scene.n_lights > 0,
        has_perlin=scene.has_perlin_tex, perlin_seed=scene.perlin_seed,
        nx=config.nx, ny=config.ny, total_pix=config.n_pixels,
        max_depth=config.max_depth, seed=config.seed, dtype=config.dtype,
        n_media=int(scene.med_kind.shape[0]) if scene.has_media else 0,
        n_kleins=int(scene.kl_center.shape[0]) if scene.has_klein else 0,
        n_beziers=int(scene.bez_w.shape[0]) if scene.has_beziers else 0,
        bez_seeds=config.bezier_seeds, bez_newton=config.bezier_newton,
        img_dims=scene.img_dims if scene.has_image_tex else (),
        attr_sweep=(int(scene.sph_r.shape[0]) if scene.has_spheres else 0)
        > UNROLL_MAX)


def pool_plan(scene, config) -> BouncePlan:
    """The plan every pool of the port runs: `make_plan` without the
    sphere attribute atlas.  The JAX pools drop `attr_sweep` in reverse mode
    and in the strided pools, where their kernels cannot take it; here no
    path needs it (the plain step gathers the winner's `pk` row, the kernels
    load it), so it is never built or passed.  The image texel planes stay:
    for a scene with image textures `pack` returns `(pk, atlas)` with the
    [plan.img_rows, 128] texels, and every step takes that pair."""
    return dataclasses.replace(make_plan(scene, config), attr_sweep=False)


def check_kernel_plan(plan: BouncePlan) -> None:
    """The plan check of the CUDA wrappers: the kernels load the winner's
    `pk` row and read no sphere attribute atlas (`pool_plan`)."""
    if plan.attr_sweep:
        raise ValueError("the bounce kernels take no sphere attribute atlas: "
                         "build the plan with bounce.pool_plan")


def split_pk(plan: BouncePlan, pk):
    """`pack`'s result -> (pk, atlas), atlas None for a plan without one."""
    return pk if plan.has_atlas else (pk, None)


def _sum3(x):
    """Row sum of an [N, 3] tensor in left-to-right order."""
    return x[:, 0] + x[:, 1] + x[:, 2]


def _mat_fields(scene, mid, img_bases=None):
    """(mtype, alb0, alb1, texk, texs) resolved through the tex table.

    For image textures the alb0 triple carries (iw, ih, first_atlas_row)."""
    mid = mid.long()
    tex = scene.mat_tex[mid].long()
    ttype = scene.tex_type[tex]
    ischeck = ttype == sb.TEX_CHECKER
    alb0 = torch.where(ischeck[:, None],
                       scene.tex_color[scene.tex_child0[tex].long()],
                       scene.tex_color[tex])
    if img_bases is not None:
        isimg = ttype == sb.TEX_IMAGE
        bases = torch.as_tensor(img_bases, dtype=alb0.dtype,
                                device=alb0.device)
        meta = torch.stack(
            [scene.tex_iw[tex].to(alb0.dtype),
             scene.tex_ih[tex].to(alb0.dtype),
             bases[scene.tex_image[tex].long()]], dim=1)
        alb0 = torch.where(isimg[:, None], meta, alb0)
    alb1 = scene.tex_color[scene.tex_child1[tex].long()]
    return (scene.mat_type[mid].to(alb0.dtype), alb0, alb1,
            ttype.to(alb0.dtype), scene.tex_scale[tex])


def pack(scene, cam, plan: BouncePlan, dtype):
    """Build the flat scene vector `pk` on the scene's device.

    With an atlas (image textures or the sphere attribute sweep) returns
    (pk, atlas): the [plan.atlas_rows, 128] texel planes, then the sphere
    attribute columns, laid out as in the JAX package."""
    dev = scene.device
    col = lambda x: x.to(dtype)[:, None]
    imgtex = None
    if plan.has_image:
        rows = []
        for k, (ih, iw) in enumerate(plan.img_dims):
            nck = plan.img_chunks[k]
            for c in range(3):
                texels = scene.images[k, :ih, :iw, c].reshape(-1)
                texels = torch.cat(
                    [texels, texels.new_zeros(nck * 128 - ih * iw)])
                rows.append(texels.reshape(nck, 128))
        imgtex = torch.cat(rows, dim=0).to(dtype)
    img_bases = plan.img_bases if plan.has_image else None

    f = lambda x: torch.as_tensor(x).to(dtype).reshape(-1)
    pieces = [f(scene.sky_a), f(scene.sky_b)]
    origin, ll, hor, ver, cu, cv, _ = _basis(cam)
    pieces += [f(origin), f(ll), f(hor), f(ver), f(cu), f(cv),
               f(cam.aperture / 2.0), f(cam.time0),
               f(cam.time1 - cam.time0)]

    if plan.n_rects:
        eye = torch.eye(3, dtype=dtype, device=dev)
        axis = scene.rect_axis.long()
        nsel = eye[axis]
        asel = eye[torch.where(axis == 0, 1, 0)]
        bsel = eye[torch.where(axis == 2, 1, 2)]
        rot = scene.rect_rot.to(dtype)
        trans = scene.rect_trans.to(dtype)
        # world-space plane: p_obj . sel in range, p_obj = R^T (p - T),
        # becomes p . (R sel) in range + T . (R sel)
        n_w = torch.einsum("rij,rj->ri", rot, nsel)
        a_w = torch.einsum("rij,rj->ri", rot, asel)
        b_w = torch.einsum("rij,rj->ri", rot, bsel)
        tn = _sum3(trans * n_w)
        ta = _sum3(trans * a_w)
        tb = _sum3(trans * b_w)
        flip = scene.rect_flip.to(dtype)
        wn = n_w * flip[:, None]
        kk = (scene.rect_k + tn) * flip            # so t = (K - o.wn)/(d.wn)
        mtype, alb0, alb1, texk, texs = _mat_fields(scene, scene.rect_mat,
                                                    img_bases)
        rm = scene.rect_mat.long()
        block = torch.cat([
            wn, col(kk),
            a_w, col(scene.rect_a0 + ta), col(scene.rect_a1 + ta),
            b_w, col(scene.rect_b0 + tb), col(scene.rect_b1 + tb),
            col(scene.rect_valid),
            col(mtype), alb0.to(dtype), alb1.to(dtype), col(texk),
            col(scene.mat_fuzz[rm]), col(scene.mat_ref[rm]), col(texs),
        ], dim=1)
        assert block.shape[1] == RECT_SIZE
        pieces.append(block.reshape(-1))

    sph_attr = None
    if plan.n_spheres:
        mtype, alb0, alb1, texk, texs = _mat_fields(scene, scene.sph_mat,
                                                    img_bases)
        sm = scene.sph_mat.long()
        block = torch.cat([
            scene.sph_c0.to(dtype), scene.sph_c1.to(dtype),
            col(scene.sph_t0), col(scene.sph_t1), col(scene.sph_r),
            col(scene.sph_valid),
            col(mtype), alb0.to(dtype), alb1.to(dtype), col(texk),
            col(scene.mat_fuzz[sm]), col(scene.mat_ref[sm]), col(texs),
        ], dim=1)
        assert block.shape[1] == SPH_SIZE
        pieces.append(block.reshape(-1))
        if plan.attr_sweep:
            # atlas row img_rows + a*sph_chunks + k holds attribute column a
            # of spheres [k*128, (k+1)*128)
            nck = plan.sph_chunks
            cols = torch.cat(
                [block, block.new_zeros(nck * 128 - plan.n_spheres,
                                        SPH_SIZE)], dim=0)
            sph_attr = cols.t().reshape(SPH_SIZE * nck, 128)

    if plan.n_lights:
        block = torch.cat([
            col(scene.light_kind),
            scene.light_rect.to(dtype),             # x0, x1, z0, z1, k
            scene.light_center.to(dtype),
            col(scene.light_radius),
            col(scene.light_valid),
        ], dim=1)
        assert block.shape[1] == LGT_SIZE
        pieces.append(block.reshape(-1))

    if plan.n_media:
        # oriented 3-slab boundary: p_obj[a] in [pmin_a, pmax_a] with
        # p_obj = R^T (p - T) becomes p . R[:,a] in range + T . R[:,a]
        rot = scene.med_rot.to(dtype)
        trans = scene.med_trans.to(dtype)
        ax_blocks = []
        for a in range(3):
            u = rot[:, :, a]
            ut = _sum3(u * trans)
            ax_blocks += [u, col(scene.med_pmin[:, a] + ut),
                          col(scene.med_pmax[:, a] + ut)]
        mtype, alb0, alb1, texk, texs = _mat_fields(scene, scene.med_mat)
        mm = scene.med_mat.long()
        block = torch.cat([
            col(scene.med_kind), *ax_blocks,
            scene.med_center.to(dtype), col(scene.med_radius),
            col(scene.med_neg_inv_d), col(scene.med_valid),
            col(mtype), alb0.to(dtype), alb1.to(dtype), col(texk),
            col(scene.mat_fuzz[mm]), col(scene.mat_ref[mm]), col(texs),
        ], dim=1)
        assert block.shape[1] == MED_SIZE
        pieces.append(block.reshape(-1))

    if plan.n_kleins:
        mtype, alb0, alb1, texk, texs = _mat_fields(scene, scene.kl_mat)
        km = scene.kl_mat.long()
        block = torch.cat([
            scene.kl_center.to(dtype), col(scene.kl_valid),
            col(mtype), alb0.to(dtype), alb1.to(dtype), col(texk),
            col(scene.mat_fuzz[km]), col(scene.mat_ref[km]), col(texs),
        ], dim=1)
        assert block.shape[1] == KL_SIZE
        pieces.append(block.reshape(-1))

    if plan.n_beziers:
        mtype, alb0, alb1, texk, texs = _mat_fields(scene, scene.bez_mat)
        bm = scene.bez_mat.long()
        block = torch.cat([
            scene.bez_cp.reshape(-1, 12).to(dtype), col(scene.bez_w),
            col(scene.bez_valid),
            col(mtype), alb0.to(dtype), alb1.to(dtype), col(texk),
            col(scene.mat_fuzz[bm]), col(scene.mat_ref[bm]), col(texs),
        ], dim=1)
        assert block.shape[1] == BEZ_SIZE
        pieces.append(block.reshape(-1))

    pk = torch.cat([p.to(device=dev) for p in pieces])
    assert pk.shape[0] == plan.size, (pk.shape, plan.size)
    if plan.has_atlas:
        parts = ([imgtex] if imgtex is not None else []) \
            + ([sph_attr] if sph_attr is not None else [])
        atlas = torch.cat(parts, dim=0)
        assert atlas.shape == (plan.atlas_rows, 128), atlas.shape
        return pk, atlas
    return pk


# ---------------------------------------------------------------------------
# The plain step (rects, spheres, lights, media, textures), op for op the
# JAX `step`
# ---------------------------------------------------------------------------


def _v(pk, base):
    return (pk[base], pk[base + 1], pk[base + 2])


def _camera_ray(plan, pk, u, px, py):
    """SoA get_rays_u (camera.scm:80-92) from the packed camera basis."""
    s = (px + u[0]) * (1.0 / plan.nx)          # main.scm:456-457
    t = (py + u[1]) * (1.0 / plan.ny)
    r = torch.sqrt(u[2])
    phi = _TWO_PI * u[3]
    rdx = pk[H_LENS_R] * r * torch.cos(phi)
    rdy = pk[H_LENS_R] * r * torch.sin(phi)
    cu, cv = _v(pk, H_CAM_U), _v(pk, H_CAM_VV)
    off = add3(scale3(cu, rdx), scale3(cv, rdy))
    origin = _v(pk, H_CAM_O)
    o = add3(origin, off)
    ll, hor, ver = _v(pk, H_CAM_LL), _v(pk, H_CAM_H), _v(pk, H_CAM_V)
    d = tuple(ll[i] + s * hor[i] + t * ver[i] - origin[i] - off[i]
              for i in range(3))
    time = pk[H_T0] + u[4] * pk[H_DT]
    return o, unit3(d), time


# The kind of a closest-hit winner, carried in the record of a plan with
# image textures: it says which surface-coordinate convention the winner has.
KIND_NONE, KIND_RECT, KIND_SPHERE = 0, 1, 2


def _merge_rec(pk, best, ok, t, wn, base, a0_off, a1_off, m_off, tk_off,
               fz_off, rf_off, ts_off, extra=None):
    """Fold one primitive's candidate hit into the running best record.

    The strict `<` keeps the first of equal-t primitives (pack order).
    `extra` maps further keys of `best` to the candidate's values (the
    winner's kind and what its surface coordinates need, carried by plans
    with image textures only); keys it leaves out keep the record's."""
    closer = ok & (t < best["t"])
    more = {k: torch.where(closer, v, best[k])
            for k, v in (extra or {}).items()}
    return {
        **best, **more,
        "hit": best["hit"] | closer,
        "t": torch.where(closer, t, best["t"]),
        "wn": where3(closer, wn, best["wn"]),
        "mtype": torch.where(closer, pk[base + m_off], best["mtype"]),
        "alb0": where3(closer, _v(pk, base + a0_off), best["alb0"]),
        "alb1": where3(closer, _v(pk, base + a1_off), best["alb1"]),
        "texk": torch.where(closer, pk[base + tk_off], best["texk"]),
        "texs": torch.where(closer, pk[base + ts_off], best["texs"]),
        "fuzz": torch.where(closer, pk[base + fz_off], best["fuzz"]),
        "ref": torch.where(closer, pk[base + rf_off], best["ref"]),
    }


def _sphere_hit(plan, sph, o, d, time, t_min, big):
    """The JAX sphere_probe's candidate: (ok, t, centre) of the spheres
    whose S_* attributes are `sph[k]`, each broadcast against the lanes
    ([n, 1] columns for every sphere against every lane, or [m] gathered
    rows for one sphere per lane).  t0 before t1, strict bounds."""
    c0 = (sph[S_C0], sph[S_C0 + 1], sph[S_C0 + 2])
    if plan.has_moving:
        span = sph[S_T1] - sph[S_T0]
        frac = (time - sph[S_T0]) / torch.where(span == 0.0, 1.0, span)
        c = tuple(c0[i] + frac * (sph[S_C1 + i] - c0[i]) for i in range(3))
    else:
        c = c0
    rr = sph[S_R]
    oc = sub3(o, c)
    bq = dot3(oc, d)                               # geometry.scm:149-153
    cq = dot3(oc, oc) - rr * rr
    disc = bq * bq - cq
    okd = disc > 0.0
    sq = torch.sqrt(torch.where(okd, disc, 1.0))
    t0 = -bq - sq
    t1 = -bq + sq
    in0 = okd & (t0 > t_min) & (t0 < big)
    in1 = okd & (t1 > t_min) & (t1 < big)
    t = torch.where(in0, t0, torch.where(in1, t1, big))
    return (in0 | in1) & (sph[S_VALID] > 0.5), t, c


def _sweep_spheres(plan, pk_t, best, o, d, time, t_min, t_max):
    """Fold the sphere group into the running best record: what the JAX
    step's unrolled sphere_probe merges, its _prim_loop and its slim sweep
    all give, bitwise, for any sphere count.

    The candidate t of every sphere against every lane is one [n, m]
    tensor; its first-index argmin is the sweep's winner (the strict `<`
    keeps the first of equal-t spheres), and one gather of the winner's row
    of the `pk` sphere block carries its 21 attributes.  The winner is then
    probed again from the gathered row, under autograd: the same t, and a
    gradient that reaches the winner only."""
    n = plan.n_spheres
    block = pk_t[plan.sph_base:plan.sph_base + n * SPH_SIZE].reshape(
        n, SPH_SIZE)
    with torch.no_grad():
        cols = block.detach().t()[:, :, None]                # [21, n, 1]
        ok, t, _ = _sphere_hit(
            plan, cols, tuple(x.detach() for x in o),
            tuple(x.detach() for x in d), time.detach(), t_min, t_max)
        idx = torch.argmin(torch.where(ok, t, math.inf), dim=0)
    win = block[idx].unbind(1)                               # 21 x [m]
    ok, t, c = _sphere_hit(plan, win, o, d, time, t_min, t_max)
    closer = ok & (t < best["t"])
    # normal (p - c)/r: sign(r) keeps the hollow-dielectric flip
    inv_r = 1.0 / torch.where(closer, win[S_R], 1.0)
    wn = tuple((o[i] + t * d[i] - c[i]) * inv_r for i in range(3))
    v3 = lambda k: (win[k], win[k + 1], win[k + 2])
    more = {}
    if plan.has_image:
        more = {"kind": torch.where(closer, KIND_SPHERE, best["kind"]),
                "sgn": torch.where(closer, torch.sign(win[S_R].detach()),
                                   best["sgn"])}
    return {
        **best, **more,
        "hit": best["hit"] | closer,
        "t": torch.where(closer, t, best["t"]),
        "wn": where3(closer, wn, best["wn"]),
        "mtype": torch.where(closer, win[S_MTYPE], best["mtype"]),
        "alb0": where3(closer, v3(S_ALB0), best["alb0"]),
        "alb1": where3(closer, v3(S_ALB1), best["alb1"]),
        "texk": torch.where(closer, win[S_TEXK], best["texk"]),
        "texs": torch.where(closer, win[S_TEXS], best["texs"]),
        "fuzz": torch.where(closer, win[S_FUZZ], best["fuzz"]),
        "ref": torch.where(closer, win[S_REF], best["ref"]),
    }


# --- the Kleinian limit set (geometry.scm:590-661; the JAX step's
# _klein_dist, _klein_dist_grad, _klein_march and klein_probe) -------------

# Inversion-sphere positions, klein-local (geometry.scm:591-599)
_KLEIN_SPHERES = ((300.0, 300.0, 0.0), (300.0, -300.0, 0.0),
                  (-300.0, 300.0, 0.0), (-300.0, -300.0, 0.0),
                  (0.0, 0.0, 424.26), (0.0, 0.0, -424.26))
# The march's bounds, the JAX step's numbers: the acceptance set {DE < eps}
# lies inside |p - c| < 724.26 (every inversion ball B(s_i, 300) has
# |s_i| = 424.26; outside them the DE is 0.7 (|p - c| - 125)), so a ray that
# never enters the ball of radius KLEIN_PRECULL_R can never accept, and a ray
# receding outside KLEIN_RECEDE_R never comes back.
KLEIN_PRECULL_R = 726.0
KLEIN_RECEDE_R = 900.0


def _klein_inversion(px, py, pz, active):
    """One iteration's inversion: for each lane, the first of the six
    spheres whose interior holds the point, among the `active` lanes.  The
    JAX step's masked sequential select, with every sphere's offset and d2
    computed at once: a sphere after the selected one only ever sees the
    inverted point through a mask that is false, so the first sphere with
    d2 < r2 at the lane's point is the one the select picks, with the same
    values.  Returns (sel, dx, dy, dz, d2, sx, sy, sz) of that sphere for
    every lane (the first sphere's where none holds it)."""
    s = px.new_tensor(_KLEIN_SPHERES)                        # [6, 3]
    dx, dy, dz = px - s[:, 0:1], py - s[:, 1:2], pz - s[:, 2:3]
    d2 = dx * dx + dy * dy + dz * dz
    inside = (d2 < cfg_mod.KLEIN_SPHERE_R * cfg_mod.KLEIN_SPHERE_R) & active
    idx = inside.to(torch.uint8).argmax(0)                   # the first one
    pick = lambda x: x.gather(0, idx[None])[0]
    return (inside.any(0), pick(dx), pick(dy), pick(dz), pick(d2),
            s[idx, 0], s[idx, 1], s[idx, 2])


def _klein_dist(c, px, py, pz, stats=None):
    """The distance estimate (geometry.scm:602-624): up to KLEIN_ITERATIONS
    inversions, a lane leaving the loop when its point escapes every
    inversion sphere (it never changes again).  On the CPU the loop ends
    when no lane is active; on the card, where that test would be a host
    sync each iteration, it runs all of them, with the same values.
    `stats` (a dict), if given, counts the inversions."""
    px, py, pz = px - c[0], py - c[1], pz - c[2]
    r2 = cfg_mod.KLEIN_SPHERE_R * cfg_mod.KLEIN_SPHERE_R
    tiny = torch.finfo(px.dtype).tiny
    dr = torch.ones_like(px)
    active = torch.ones_like(px, dtype=torch.bool)
    for _ in range(cfg_mod.KLEIN_ITERATIONS):
        sel, dx, dy, dz, d2, sx, sy, sz = _klein_inversion(px, py, pz, active)
        if stats is not None:
            stats["inversions"] += int(sel.sum())
        if not (px.is_cuda or bool(sel.any())):
            break
        scale = px.new_tensor(r2) / _max(d2, tiny)
        px = torch.where(sel, dx * scale + sx, px)
        py = torch.where(sel, dy * scale + sy, py)
        pz = torch.where(sel, dz * scale + sz, pz)
        dr = torch.where(sel, dr * scale, dr)
        active = sel
    ln = torch.sqrt(px * px + py * py + pz * pz)
    return cfg_mod.KLEIN_DE_SCALE * (ln - cfg_mod.KLEIN_R) / torch.abs(dr)


def _klein_dist_grad(c, px, py, pz):
    """The distance estimate and its exact spatial gradient g in one
    inversion loop: the three unit tangents d(P)/d(x0), d(P)/d(y0),
    d(P)/d(z0) ride beside the primal (dx' = scale (dx - x w) with
    w = 2 (x.dx) / |x|^2, and ddr' = scale (ddr - w dr)), 17 carried values.
    Differentiable: autograd through it gives the second derivatives."""
    px, py, pz = px - c[0], py - c[1], pz - c[2]
    r2 = cfg_mod.KLEIN_SPHERE_R * cfg_mod.KLEIN_SPHERE_R
    tiny = torch.finfo(px.dtype).tiny
    one, zero = torch.ones_like(px), torch.zeros_like(px)
    dr = one
    tan = [[one, zero, zero, zero], [zero, one, zero, zero],
           [zero, zero, one, zero]]          # (tx, ty, tz, dd) per axis
    active = torch.ones_like(px, dtype=torch.bool)
    for _ in range(cfg_mod.KLEIN_ITERATIONS):
        sel, dx, dy, dz, d2, sx, sy, sz = _klein_inversion(
            px.detach(), py.detach(), pz.detach(), active)
        if not bool(sel.any()):
            break
        # the same offsets, from the differentiable point
        dx, dy, dz = px - sx, py - sy, pz - sz
        d2 = dx * dx + dy * dy + dz * dz
        inv_d2 = 1.0 / _max(d2, tiny)
        scale = r2 * inv_d2
        for j in range(3):
            tx, ty, tz, dd = tan[j]
            w = 2.0 * (dx * tx + dy * ty + dz * tz) * inv_d2
            tan[j] = [torch.where(sel, scale * (tx - dx * w), tx),
                      torch.where(sel, scale * (ty - dy * w), ty),
                      torch.where(sel, scale * (tz - dz * w), tz),
                      torch.where(sel, scale * (dd - w * dr), dd)]
        px = torch.where(sel, dx * scale + sx, px)
        py = torch.where(sel, dy * scale + sy, py)
        pz = torch.where(sel, dz * scale + sz, pz)
        dr = torch.where(sel, dr * scale, dr)
        active = sel
    ln = torch.sqrt(_max(px * px + py * py + pz * pz, tiny))
    adr = torch.abs(dr)
    de = cfg_mod.KLEIN_DE_SCALE * (ln - cfg_mod.KLEIN_R) / adr
    # d(de)/d(x0_j) = K/|dr| * ((P . t_j)/|P| - (|P| - R)*ddr_j/dr)
    k = adr.new_tensor(cfg_mod.KLEIN_DE_SCALE) / adr
    rat = (ln - cfg_mod.KLEIN_R) / dr
    g = tuple(k * ((px * tx + py * ty + pz * tz) / ln - rat * dd)
              for tx, ty, tz, dd in tan)
    return de, g


def _klein_march(c, o, d, t_min, t_max, stats=None):
    """The sphere trace (geometry.scm:646-661), with the JAX step's exact
    retirements; no gradient.  t_max is a lane tensor, the closest solid hit
    so far: an accept at t >= t_max loses the strict closest-hit merge, so
    the bound is exact.  A lane starts retired when its ray never enters
    the ball of radius KLEIN_PRECULL_R about c on (t_min, t_max) (d is
    unit); it retires on an accept, backward-stuck (a DE <= 0 point at
    parameter <= t_min: no later step clears t_min), past t_max, or receding
    outside KLEIN_RECEDE_R.  Each step runs on the lanes still marching.
    Returns (hit, the parameter where each lane stopped).  `stats` (a dict),
    if given, counts the lanes that march, their steps and inversions, the
    backward-stuck retirements, and the lanes still marching at the
    KLEIN_MAX_STEPS cap."""
    ox, oy, oz = o[0] - c[0], o[1] - c[1], o[2] - c[2]
    bq = ox * d[0] + oy * d[1] + oz * d[2]
    cq = ox * ox + oy * oy + oz * oz - KLEIN_PRECULL_R * KLEIN_PRECULL_R
    disc = bq * bq - cq
    sq = torch.sqrt(_max(disc, 0.0))
    miss = (disc <= 0.0) | (-bq + sq <= t_min) | (-bq - sq >= t_max)
    ray_len = torch.zeros_like(o[0])
    hit = torch.zeros_like(miss)
    live = (~miss).nonzero()[:, 0]
    if stats is not None:
        stats["marching"] += live.numel()
    for _ in range(cfg_mod.KLEIN_MAX_STEPS):
        if live.numel() == 0:
            break
        if stats is not None:
            stats["steps"] += live.numel()
        lo, ld = [x[live] for x in o], [x[live] for x in d]
        length, tm = ray_len[live], t_max[live]
        dist = _klein_dist(c, lo[0] + ld[0] * length, lo[1] + ld[1] * length,
                           lo[2] + ld[2] * length, stats)
        new_len = length + dist
        accept = ((dist < cfg_mod.KLEIN_SURF_EPS) & (new_len > t_min)
                  & (new_len < tm))
        stuck = (dist <= 0.0) & (length <= t_min)
        if stats is not None:
            stats["stuck"] += int((stuck & ~accept).sum())
        ray_len[live] = new_len
        hit[live] = accept
        px = lo[0] + ld[0] * new_len - c[0]
        py = lo[1] + ld[1] * new_len - c[1]
        pz = lo[2] + ld[2] * new_len - c[2]
        receding = (px * ld[0] + py * ld[1] + pz * ld[2]) > 0.0
        outside = ((px * px + py * py + pz * pz)
                   > KLEIN_RECEDE_R * KLEIN_RECEDE_R)
        live = live[~(accept | stuck | (new_len >= tm)
                      | (receding & outside))]
    if stats is not None:
        stats["capped"] += live.numel()
    return hit, ray_len


def _klein_hit(pk, b, o, d, t_min, best_t):
    """The JAX klein_probe's candidate (ok, t, wn) of the klein at packed
    base b: the march bounded by the closest hit so far runs without
    gradient; the hit's t is attached by the implicit-function correction
    t = t_raw - (corr - corr.detach()), corr = (DE - eps) / (g . d) at the
    root (g . d kept off zero at +-1e-6), and the normal is unit(g), g the
    DE's exact gradient there."""
    c = _v(pk, b + K_C)
    with torch.no_grad():
        hitk, t_raw = _klein_march(tuple(x.detach() for x in c),
                                   tuple(x.detach() for x in o),
                                   tuple(x.detach() for x in d), t_min,
                                   best_t.detach())
    p_raw = tuple(o[i] + t_raw * d[i] for i in range(3))
    dist, g = _klein_dist_grad(c, *p_raw)
    ddt = g[0] * d[0] + g[1] * d[1] + g[2] * d[2]
    denom = torch.where(torch.abs(ddt) > 1e-6, ddt,
                        torch.where(ddt >= 0.0, ddt.new_tensor(1e-6),
                                    ddt.new_tensor(-1e-6)))
    corr = torch.where(hitk, (dist - cfg_mod.KLEIN_SURF_EPS) / denom, 0.0)
    t = t_raw - (corr - corr.detach())
    return hitk & (pk[b + K_VALID] > 0.5), t, unit3(g)


def _intersect(plan, pk, pk_t, o, d, time, t_min, t_max):
    """Closest-hit sweep in pack order, material merged in: the rects,
    unrolled (for any count: the JAX step's chunked loop above UNROLL_MAX
    gives the unrolled merge's values), then the spheres, then the kleins
    (each march bounded by the closest hit so far), then the bezier
    ribbons.  pk is the unbound scene vector, pk_t the tensor itself."""
    z = torch.zeros_like(o[0])
    best = {
        "hit": torch.zeros_like(o[0], dtype=torch.bool),
        "t": torch.full_like(o[0], t_max),
        "wn": (z, z, z), "mtype": z, "alb0": (z, z, z), "alb1": (z, z, z),
        "texk": z, "texs": z, "fuzz": z, "ref": z,
    }
    if plan.has_image:
        # the winner's kind, its rect index and its radius's sign: what
        # `_surface_uv` reads, once, after the sweep
        best["kind"] = torch.zeros_like(o[0], dtype=torch.int64)
        best["ridx"] = torch.zeros_like(o[0], dtype=torch.int64)
        best["sgn"] = z
    for r in range(plan.n_rects):
        b = plan.rect_base + r * RECT_SIZE
        wn_s = _v(pk, b + R_WN)
        dn = dot3(d, wn_s)
        dn_ok = dn != 0.0                          # rays in the rect plane
        dn = torch.where(dn_ok, dn, 1.0)
        t = (pk[b + R_K] - dot3(o, wn_s)) / dn     # geometry.scm:378-379
        av = _v(pk, b + R_A)
        bv = _v(pk, b + R_B)
        pa = dot3(o, av) + t * dot3(d, av)
        pb = dot3(o, bv) + t * dot3(d, bv)
        ok = (dn_ok & (t >= t_min) & (t <= t_max) & (pk[b + R_VALID] > 0.5)
              & (pa >= pk[b + R_KA0]) & (pa <= pk[b + R_KA1])
              & (pb >= pk[b + R_KB0]) & (pb <= pk[b + R_KB1]))
        wn = tuple(w.expand_as(z) for w in wn_s)
        best = _merge_rec(pk, best, ok, t, wn, b, R_ALB0, R_ALB1, R_MTYPE,
                          R_TEXK, R_FUZZ, R_REF, R_TEXS,
                          {"kind": KIND_RECT, "ridx": r} if plan.has_image
                          else None)
    if plan.n_spheres:
        best = _sweep_spheres(plan, pk_t, best, o, d, time, t_min, t_max)
    for k in range(plan.n_kleins):
        b = plan.kl_base + k * KL_SIZE
        ok, t, wn = _klein_hit(pk, b, o, d, t_min, best["t"])
        # a klein's surface coordinates are (0, 0), as a ribbon's
        best = _merge_rec(pk, best, ok, t, wn, b, K_ALB0, K_ALB1, K_MTYPE,
                          K_TEXK, K_FUZZ, K_REF, K_TEXS,
                          {"kind": KIND_NONE} if plan.has_image else None)
    for j in range(plan.n_beziers):
        b = plan.bez_base + j * BEZ_SIZE
        okc, t_curve = _bezier_hit(plan, pk, b, o, d, t_min, t_max)
        wn = (-d[0], -d[1], -d[2])               # B11: normal = -ray dir
        # a ribbon's surface coordinates are (0, 0), as a medium's
        best = _merge_rec(pk, best, okc, t_curve, wn, b, B_ALB0, B_ALB1,
                          B_MTYPE, B_TEXK, B_FUZZ, B_REF, B_TEXS,
                          {"kind": KIND_NONE} if plan.has_image else None)
    return best


def _bezier_power(p0, p1, p2, p3):
    """Bernstein control values -> power-basis coefficients."""
    return (p0, 3.0 * (p1 - p0), 3.0 * (p0 - 2.0 * p1 + p2),
            -p0 + 3.0 * p1 - 3.0 * p2 + p3)


def _bezier_g_derivs(ax, ay, s):
    """g(s) = |c(s)|^2 of the curve's ray-space projection c = (cx, cy), its
    first two derivatives and 2 |c'|^2, in the Horner form of the JAX step."""
    cx = ax[0] + s * (ax[1] + s * (ax[2] + s * ax[3]))
    cy = ay[0] + s * (ay[1] + s * (ay[2] + s * ay[3]))
    cx1 = ax[1] + s * (2.0 * ax[2] + s * (3.0 * ax[3]))
    cy1 = ay[1] + s * (2.0 * ay[2] + s * (3.0 * ay[3]))
    cx2 = 2.0 * ax[2] + s * (6.0 * ax[3])
    cy2 = 2.0 * ay[2] + s * (6.0 * ay[3])
    g = cx * cx + cy * cy
    dg = 2.0 * (cx * cx1 + cy * cy1)
    speed2 = 2.0 * (cx1 * cx1 + cy1 * cy1)
    d2g = speed2 + 2.0 * (cx * cx2 + cy * cy2)
    return g, dg, d2g, speed2


def _bezier_candidates(plan, pk, b, o, d, t_min, big):
    """Per seed of the ribbon at packed base b, as [K, m] tensors: the
    converged root s (no gradient) and the candidate distance, zc(s) where
    the seed's root is accepted and `big` elsewhere.

    The march of all seeds runs at once and carries no gradient.  The
    gradient is the root's: s - (corr - corr.detach()) with
    corr = g' / max(g'', 0.05 |c'|^2 + 1e-12) at the converged s, so zc(s)
    differentiates as the implicit function does."""
    dt = d[0].dtype
    pick = torch.abs(d[0]) > 0.9
    a_vec = (torch.where(pick, 0.0, 1.0).to(dt),
             torch.where(pick, 1.0, 0.0).to(dt), torch.zeros_like(d[0]))
    v_f = unit3(cross3(d, a_vec))
    u_f = cross3(v_f, d)
    cxk, cyk, czk = [], [], []
    for k in range(4):
        cp = _v(pk, b + B_CP + 3 * k)
        rel = tuple(cp[i] - o[i] for i in range(3))
        cxk.append(dot3(rel, u_f))
        cyk.append(dot3(rel, v_f))
        czk.append(dot3(rel, d))
    ax, ay, az = (_bezier_power(*cxk), _bezier_power(*cyk),
                  _bezier_power(*czk))
    half_w = pk[b + B_W] * 0.5
    hw2 = half_w * half_w
    valid = pk[b + B_VALID] > 0.5
    K = plan.bez_seeds
    with torch.no_grad():
        ax_s, ay_s = ([c.detach() for c in a] for a in (ax, ay))
        s = ((torch.arange(K, dtype=dt, device=d[0].device) + 0.5)
             * (1.0 / K))[:, None] + torch.zeros_like(d[0])
        for _ in range(plan.bez_newton):
            _, dg, d2g, _ = _bezier_g_derivs(ax_s, ay_s, s)
            curved = d2g > 1e-12
            stepn = torch.where(curved, dg / torch.where(curved, d2g, 1e-12),
                                0.0)
            s = _clip(s - stepn, 0.0, 1.0)
    root = s
    # implicit-function gradients at the root (ops/bezier.py:95-119): the
    # ROOT is differentiated, not the Newton tape; the curvature floor bounds
    # the grazing-hit estimator
    _, dg, d2g, speed2 = _bezier_g_derivs(ax, ay, s)
    interior = (s > 0.0) & (s < 1.0)
    d2g_safe = torch.maximum(d2g, 0.05 * speed2 + 1e-12)
    corr = torch.where(interior, dg / d2g_safe, 0.0)
    s = s - (corr - corr.detach())
    g, _, _, _ = _bezier_g_derivs(ax, ay, s)
    zc = az[0] + s * (az[1] + s * (az[2] + s * az[3]))
    ok = ((g < hw2) & (zc > 1e-4) & (zc > t_min) & (zc <= big)
          & valid)                               # bezier.scm:161-166
    return root, torch.where(ok, zc, big)


def _bezier_hit(plan, pk, b, o, d, t_min, big):
    """The JAX bezier_probe's candidate (okc, t) of the ribbon at packed base
    b (bezier.scm:161-166 redesigned: ops/bezier.py): Newton on g'(s) = 0
    from `plan.bez_seeds` fixed seeds in ray space, the closest accepted root.

    The minimum over the seeds' candidates is folded in seed order with
    torch.minimum, as the JAX fori_loop folds it: several seeds reach one
    root, and every equal pair splits the cotangent in that order."""
    _, cand = _bezier_candidates(plan, pk, b, o, d, t_min, big)
    t_curve = torch.full_like(d[0], big)
    for k in range(plan.bez_seeds):
        t_curve = torch.minimum(t_curve, cand[k])
    return t_curve < big, t_curve


def _onb_local(w, x, y, zc):
    """onb.scm:8-16 + local: world vector from local (x, y, zc) about w."""
    pick_y = torch.abs(w[0]) > 0.9
    zero = torch.zeros_like(w[0])
    a = (torch.where(pick_y, 0.0, 1.0).to(w[0].dtype),
         torch.where(pick_y, 1.0, 0.0).to(w[0].dtype), zero)
    v = unit3(cross3(w, a))
    u = cross3(v, w)
    return tuple(x * u[i] + y * v[i] + zc * w[i] for i in range(3))


def _cosine_dir(u1, u2, w):
    """Cosine-weighted direction about w (util.scm:37-44, B4 fixed)."""
    phi = _TWO_PI * u1
    sr2 = torch.sqrt(u2)
    zc = torch.sqrt(_max(1.0 - u2, 0.0))
    return unit3(_onb_local(w, torch.cos(phi) * sr2, torch.sin(phi) * sr2,
                            zc))


def _cosine_value(n, d):
    return _max(dot3(n, d), 0.0) * (1.0 / _PI)


def _lights_sample(plan, pk, u_pick, u_a, u_b, u_s1, u_s2, p):
    """SoA pdfs.lights_sample_u: direction toward one chosen light."""
    z = torch.zeros_like(p[0])
    out = (z, z, torch.ones_like(p[0]))
    nl = plan.n_lights
    scaled = u_pick * nl
    for l in range(nl):
        b = plan.lgt_base + l * LGT_SIZE
        sel = scaled >= l
        if l != nl - 1:
            sel = sel & (scaled < l + 1)
        is_rect = pk[b + L_KIND] < 0.5              # LIGHT_XZ_RECT == 0
        px = pk[b + L_X0] + u_a * (pk[b + L_X1] - pk[b + L_X0])
        pz = pk[b + L_Z0] + u_b * (pk[b + L_Z1] - pk[b + L_Z0])
        target = (px, pk[b + L_KY].expand_as(z), pz)
        rect_dir = unit3(sub3(target, p), eps=1e-12)

        c = _v(pk, b + L_C)
        oc = sub3(c, p)
        dist_sq = _max(dot3(oc, oc), 1e-12)
        radius = pk[b + L_RAD]
        inner = 1.0 - radius * radius / dist_sq
        outside = inner > 0.0
        ctm = torch.where(outside,
                          torch.sqrt(torch.where(outside, inner, 1.0)), 0.0)
        zc = 1.0 + u_s2 * (ctm - 1.0)
        phi = _TWO_PI * u_s1
        zin = 1.0 - zc * zc
        z_ok = zin > 0.0
        sz = torch.where(z_ok, torch.sqrt(torch.where(z_ok, zin, 1.0)), 0.0)
        sph_dir = unit3(_onb_local(unit3(oc), torch.cos(phi) * sz,
                                   torch.sin(phi) * sz, zc))
        out = where3(sel, where3(is_rect, rect_dir, sph_dir), out)
    return out


def _lights_value(plan, pk, p, d):
    """SoA pdfs.lights_value: mean hittable-PDF value over the lights."""
    total = torch.zeros_like(p[0])
    for l in range(plan.n_lights):
        b = plan.lgt_base + l * LGT_SIZE
        is_rect = pk[b + L_KIND] < 0.5
        # xz-rect (RTROYL 12.1; guards mirror pdfs._rect_value_one)
        dy_ok = torch.abs(d[1]) > 1e-9
        t_raw = (pk[b + L_KY] - p[1]) / torch.where(dy_ok, d[1], 1.0)
        hx = p[0] + t_raw * d[0]
        hz = p[2] + t_raw * d[2]
        inside = (dy_ok & (t_raw > 1e-3) & (t_raw < 1e8)
                  & (hx >= pk[b + L_X0]) & (hx <= pk[b + L_X1])
                  & (hz >= pk[b + L_Z0]) & (hz <= pk[b + L_Z1]))
        t = torch.where(inside, t_raw, 1.0)
        area = (pk[b + L_X1] - pk[b + L_X0]) * (pk[b + L_Z1] - pk[b + L_Z0])
        denom = torch.where(inside,
                            _max(torch.abs(d[1]) * area, 1e-12),
                            1.0)
        rect_v = torch.where(inside, t * t / denom, 0.0)
        # sphere (RTROYL 12.2)
        c = _v(pk, b + L_C)
        oc = sub3(c, p)
        dist_sq = dot3(oc, oc)
        radius = pk[b + L_RAD]
        outside = dist_sq > radius * radius
        ratio = _clip(radius * radius / _max(dist_sq, 1e-12), 0.0, 1.0)
        ctm = torch.sqrt(torch.where(outside, 1.0 - ratio, 1.0))
        solid = _TWO_PI * (1.0 - ctm)
        cos_dir = dot3(unit3(d), unit3(oc))
        hitting = outside & (cos_dir >= ctm)
        sph_v = torch.where(hitting, 1.0 / _max(solid, 1e-12), 0.0)
        total = total + torch.where(is_rect, rect_v, sph_v)
    return total * (1.0 / plan.n_lights)


def _media_scatter(plan, pk, gitem, depth, o, d, rec):
    """Constant-medium scatter events (geometry.scm:545-578), op for op the
    JAX `_media_scatter`.

    Probes each medium's boundary interval (oriented 3-slab box or sphere),
    clips it to the closest solid hit, and scatters at the exponential
    distance nid * log(xi) drawn from the GROUP_MEDIUM columns of the
    (seed, item, depth) stream.  A scatter overrides the solid record, in
    pack order with the strict `<`: normal (1, 0, 0), the phase material
    merged in."""
    dt = o[0].dtype
    big = o[0].new_tensor(cfg_mod.BIG)
    tiny = torch.finfo(dt).tiny
    t_clip = torch.where(rec["hit"], rec["t"], big)
    u_med = rng.hash_uniforms_tuple(plan.seed, gitem, depth, plan.n_media,
                                    dt, group_base=rng.GROUP_MEDIUM)
    one = torch.ones_like(o[0])
    zero = torch.zeros_like(o[0])
    for mi in range(plan.n_media):
        b = plan.med_base + mi * MED_SIZE
        is_box = pk[b + M_KIND] < 0.5
        en = torch.full_like(o[0], -cfg_mod.BIG)
        ex = torch.full_like(o[0], cfg_mod.BIG)
        for a in range(3):
            ab = b + M_AX + a * 5
            u_ax = _v(pk, ab)
            pa = dot3(o, u_ax)
            da = dot3(d, u_ax)
            # parallel-ray guard: keeps the backward free of NaNs
            da_ok = torch.abs(da) > 1e-12
            inv = 1.0 / torch.where(da_ok, da, 1.0)
            ta = (pk[ab + 3] - pa) * inv
            tb = (pk[ab + 4] - pa) * inv
            inside = (pa >= pk[ab + 3]) & (pa <= pk[ab + 4])
            lo_t = torch.where(da_ok, torch.minimum(ta, tb),
                               torch.where(inside, -big, big))
            hi_t = torch.where(da_ok, torch.maximum(ta, tb),
                               torch.where(inside, big, -big))
            en = torch.maximum(en, lo_t)
            ex = torch.minimum(ex, hi_t)
        box_ok = en < ex
        oc = sub3(o, _v(pk, b + M_C))
        bq = dot3(oc, d)
        rr = pk[b + M_RAD]
        cq = dot3(oc, oc) - rr * rr
        disc = bq * bq - cq
        sph_ok = disc > 0.0
        sq = torch.sqrt(torch.where(sph_ok, disc, 1.0))
        entry = torch.where(is_box, en, -bq - sq)
        exit_ = torch.where(is_box, ex, -bq + sq)
        mok = (((is_box & box_ok) | (~is_box & sph_ok))
               & (pk[b + M_VALID] > 0.5))
        t1 = _max(_max(entry, cfg_mod.SHADOW_EPS), 0.0)
        t2 = torch.minimum(exit_, t_clip)             # geometry.scm:556-557
        mok = mok & (t1 < t2)
        xi = _max(u_med[mi], tiny)                    # log(0) guard
        hit_dist = pk[b + M_NID] * torch.log(xi)      # geometry.scm:562-564
        mok = mok & (hit_dist < (t2 - t1))
        rec = _merge_rec(pk, rec, mok, t1 + hit_dist, (one, zero, zero), b,
                         M_ALB0, M_ALB1, M_MTYPE, M_TEXK, M_FUZZ, M_REF,
                         M_TEXS,
                         {"kind": KIND_NONE} if plan.has_image else None)
    return rec


def _surface_uv(plan, pk_t, rec, o, d):
    """The winner's surface coordinates (u, v), computed once after the
    sweep: a rect's from its in-plane edge ranges (ops/rect.py), a sphere's
    from the outward unit normal wn * sign(r) (ops/sphere.py sphere_uv), and
    (0, 0) for a medium or a miss.  The JAX step carries them through every
    merge, with a polynomial arctangent where this takes torch.atan2 (up to
    4e-8 rad apart).  They end in the texel lookup's integer cast, so they
    carry no gradient."""
    with torch.no_grad():
        u = v = torch.zeros_like(o[0])
        t = rec["t"]
        if plan.n_rects:
            block = pk_t[plan.rect_base:plan.rect_base
                         + plan.n_rects * RECT_SIZE].reshape(-1, RECT_SIZE)
            win = block[rec["ridx"]].unbind(1)
            av = (win[R_A], win[R_A + 1], win[R_A + 2])
            bv = (win[R_B], win[R_B + 1], win[R_B + 2])
            pa = dot3(o, av) + t * dot3(d, av)
            pb = dot3(o, bv) + t * dot3(d, bv)
            is_rect = rec["kind"] == KIND_RECT
            u = torch.where(is_rect, (pa - win[R_KA0])
                            / (win[R_KA1] - win[R_KA0]), u)
            v = torch.where(is_rect, (pb - win[R_KB0])
                            / (win[R_KB1] - win[R_KB0]), v)
        if plan.n_spheres:
            nux, nuy, nuz = (w * rec["sgn"] for w in rec["wn"])
            phi = torch.atan2(nuz, nux)
            theta = torch.atan2(nuy, torch.sqrt(_max(1.0 - nuy * nuy, 1e-12)))
            is_sph = rec["kind"] == KIND_SPHERE
            u = torch.where(is_sph, 1.0 - (phi + _PI) / _TWO_PI, u)
            v = torch.where(is_sph, (theta + _PI / 2.0) / _PI, v)
    return u, v


def _texel(plan, atlas, rec, uv):
    """texture.scm:36-50: the clamped nearest texel of (u, v), v flipped,
    as (r, g, b) lane tensors.  An image-textured winner carries (iw, ih,
    first atlas row) in its alb0 slots (`_mat_fields`); its texel lies at
    flat index j * iw + i of channel plane ch, i.e. at
    atlas.reshape(-1)[(base + ch * nck) * 128 + j * iw + i]: one indexed load
    a channel.  Other lanes read texel 0 (their alb0 holds a colour)."""
    is_img = rec["texk"] == float(sb.TEX_IMAGE)
    iw_f, ih_f, cb_f = (x.detach() for x in rec["alb0"])
    i64 = torch.int64
    ii = torch.minimum(_max(uv[0] * iw_f, 0.0), _max(iw_f - 1.0, 0.0)).to(i64)
    jj = torch.minimum(_max((1.0 - uv[1]) * ih_f - 0.001, 0.0),
                       _max(ih_f - 1.0, 0.0)).to(i64)
    flat = torch.where(is_img, jj * iw_f.to(i64) + ii, 0)
    nck = torch.where(is_img, ((iw_f * ih_f).to(i64) + 127) // 128, 0)
    cb = torch.where(is_img, cb_f, 0.0).to(i64)
    texels = atlas.reshape(-1)
    return tuple(texels[((cb + ch * nck) * 128 + flat).clamp(
        0, texels.shape[0] - 1)] for ch in range(3))


def hit_record(plan: BouncePlan, pk, gitem, px, py, fresh, depth, o, d,
               time):
    """The first half of `step`: regenerate the fresh lanes' camera rays
    (main.scm:452-469), sweep for the closest hit (geometry.scm:33-50) and
    let the media scatter before it.  pk is the scene vector alone.  Returns
    (o, d, time, rec), rec the winner's record: hit, t, wn, mtype, alb0,
    alb1, texk, texs, fuzz, ref."""
    pk_t = pk
    pk = pk.unbind(0)                  # 0-d tensors keep pk's own dtype
    u_cam = rng.hash_uniforms_tuple(plan.seed, gitem, rng.CAMERA_DEPTH, 5,
                                    px.dtype)
    o_f, d_f, time_f = _camera_ray(plan, pk, u_cam, px, py)
    o = where3(fresh, o_f, o)
    d = where3(fresh, d_f, d)
    time = torch.where(fresh, time_f, time)
    rec = _intersect(plan, pk, pk_t, o, d, time, cfg_mod.SHADOW_EPS,
                     cfg_mod.BIG)
    if plan.n_media:
        rec = _media_scatter(plan, pk, gitem, depth, o, d, rec)
    return o, d, time, rec


def step(plan: BouncePlan, pk, gitem, px, py, fresh, alive, depth,
         o, d, time, rad, tp):
    """One fused pool iteration in plain PyTorch: regen fresh lanes, trace,
    shade.

    All lane arguments are [M] tensors; o/d/rad/tp are (x, y, z) tuples;
    gitem and depth are int32, fresh and alive bool.  Returns (o', d',
    time', rad', tp', scattering); the pool handles termination, the work
    queue and the framebuffer.  With `plan.has_atlas`, pk is `pack`'s
    (pk, atlas) pair: the image texel planes come first in the atlas, and
    its sphere attribute rows are not read (see `_sweep_spheres`).
    """
    pk, atlas = split_pk(plan, pk)
    dt = px.dtype
    # --- regenerate fresh lanes, closest hit, media -------------------------
    o, d, time, rec = hit_record(plan, pk, gitem, px, py, fresh, depth, o, d,
                                 time)
    pk_t = pk
    pk = pk.unbind(0)
    zero = torch.zeros_like(px)
    rad = where3(fresh, (zero, zero, zero), rad)
    one = torch.ones_like(px)
    tp = where3(fresh, (one, one, one), tp)
    hit = rec["hit"]
    t_eff = torch.where(hit, rec["t"], 0.0)       # miss: p = o (sanitized)
    p = tuple(o[i] + t_eff * d[i] for i in range(3))
    wn = where3(hit, rec["wn"], (zero, one, zero))

    # --- sky on miss (main.scm:91-98) ---------------------------------------
    sky_t = 0.5 * (d[1] + 1.0)                     # d is unit
    sky_a, sky_b = _v(pk, H_SKY_A), _v(pk, H_SKY_B)
    sky = tuple((1.0 - sky_t) * sky_a[i] + sky_t * sky_b[i] for i in range(3))
    missed = alive & ~hit
    rad = tuple(rad[i] + torch.where(missed, tp[i] * sky[i], 0.0)
                for i in range(3))

    # --- texture (texture.scm:12-50) ----------------------------------------
    texk = rec["texk"]
    sines = (torch.sin(10.0 * p[0]) * torch.sin(10.0 * p[1])
             * torch.sin(10.0 * p[2]))
    use1 = (texk == float(sb.TEX_CHECKER)) & (sines < 0.0)
    alb = where3(use1, rec["alb1"], rec["alb0"])
    if plan.has_perlin:
        ts = rec["texs"]
        gray_n = perlin_mod.noise_xyz(plan.perlin_seed, p[0] * ts, p[1] * ts,
                                      p[2] * ts)
        gray_m = 0.5 * (1.0 + torch.sin(
            ts * p[2] + 10.0 * perlin_mod.turb_xyz(plan.perlin_seed, *p)))
        alb = where3(texk == float(sb.TEX_NOISE), (gray_n,) * 3, alb)
        alb = where3(texk == float(sb.TEX_MARBLE), (gray_m,) * 3, alb)
    if plan.has_image:
        texel = _texel(plan, atlas, rec, _surface_uv(plan, pk_t, rec, o, d))
        alb = where3(texk == float(sb.TEX_IMAGE), texel, alb)

    # --- emission (material.scm:103-111) ------------------------------------
    mtype = rec["mtype"]
    is_light = mtype == float(ob.MAT_DIFFUSE_LIGHT)
    front = dot3(wn, d) < 0.0
    hit_live = alive & hit
    emit_m = hit_live & is_light & front
    rad = tuple(rad[i] + torch.where(emit_m, tp[i] * alb[i], 0.0)
                for i in range(3))

    # --- shade uniforms ------------------------------------------------------
    u = rng.hash_uniforms_tuple(plan.seed, gitem, depth, 12, dt)

    # --- lambertian (material.scm:24-39; mixture pdf per pdf.scm intent) ---
    if plan.light_sampling:
        use_light = u[2] < 0.5
        d_cos = _cosine_dir(u[0], u[1], wn)
        d_light = _lights_sample(plan, pk, u[3], u[4], u[5], u[6], u[7], p)
        lam_dir = where3(use_light, d_light, d_cos)
        pdf = 0.5 * _cosine_value(wn, lam_dir) + 0.5 * _lights_value(
            plan, pk, p, lam_dir)
        s_pdf = _cosine_value(wn, lam_dir)
        ratio = s_pdf / _max(pdf, 1e-12)
        lam_mult = scale3(alb, ratio)
        lam_ok = pdf > 0.0
    else:
        lam_dir = _cosine_dir(u[0], u[1], wn)
        lam_mult = alb
        lam_ok = torch.ones_like(hit)

    # --- unit ball draw (metal fuzz; util.scm:9-15 analytic) ----------------
    bz = 2.0 * u[9] - 1.0
    bphi = _TWO_PI * u[10]
    br = torch.pow(u[11], 1.0 / 3.0)             # the JAX step's cbrt form
    bs = torch.sqrt(_max(1.0 - bz * bz, 0.0))
    ball = (br * bs * torch.cos(bphi), br * bs * torch.sin(bphi), br * bz)

    # --- metal (material.scm:45-57) ------------------------------------------
    refl = sub3(d, scale3(wn, 2.0 * dot3(d, wn)))
    fuzzed = add3(refl, scale3(ball, rec["fuzz"]))
    metal_ok = dot3(fuzzed, wn) > 0.0
    metal_dir = unit3(fuzzed)

    # --- dielectric (material.scm:76-101) ------------------------------------
    ref_idx = rec["ref"]
    dd = dot3(d, wn)
    exiting = dd > 0.0
    own = where3(exiting, scale3(wn, -1.0), wn)
    ni_over_nt = torch.where(exiting, ref_idx,
                             1.0 / torch.where(ref_idx == 0.0, 1.0, ref_idx))
    cosine = torch.where(exiting, dd * ref_idx, -dd)
    dtn = dot3(d, own)                              # d is unit
    disc = 1.0 - ni_over_nt * ni_over_nt * (1.0 - dtn * dtn)
    refr_ok = disc > 0.0
    safe = torch.sqrt(torch.where(refr_ok, disc, 1.0))
    refr = tuple(ni_over_nt * (d[i] - own[i] * dtn) - own[i] * safe
                 for i in range(3))
    r0 = (1.0 - ref_idx) / (1.0 + torch.where(ref_idx == -1.0, 1.0, ref_idx))
    r0 = r0 * r0
    schlick = r0 + (1.0 - r0) * torch.pow(_max(1.0 - cosine, 0.0), 5.0)
    reflect_prob = torch.where(refr_ok, schlick, 1.0)
    take_refl = u[8] < reflect_prob
    diel_dir = unit3(where3(take_refl, refl, refr))

    # --- combine (B3-fixed full protocol) -----------------------------------
    is_lam = mtype == float(ob.MAT_LAMBERTIAN)
    is_metal = mtype == float(ob.MAT_METAL)
    is_diel = mtype == float(ob.MAT_DIELECTRIC)
    direction = where3(is_lam, lam_dir,
                       where3(is_metal, metal_dir, diel_dir))
    mult = where3(is_diel, (one, one, one),
                  where3(is_lam, lam_mult, alb))
    sc_ok = (is_lam & lam_ok) | (is_metal & metal_ok) | is_diel
    scattering = hit_live & sc_ok & (depth < plan.max_depth)

    tp = where3(scattering, mul3(tp, mult), tp)
    o = where3(scattering, p, o)
    d = where3(scattering, direction, d)
    return o, d, time, rad, tp, scattering


# ---------------------------------------------------------------------------
# The CUDA kernel (csrc/bounce_step.cu): the port of the Pallas `as_pallas`
# ---------------------------------------------------------------------------

def kernel_features(plan: BouncePlan) -> tuple:
    """The feature set of the plan's kernel variants: the groups of
    csrc/bounce_common.cuh's compile-time flags that the plan has (spheres,
    moving spheres, Perlin textures, image texels, media, beziers, kleins).
    Counts are not part of it: one variant serves any count."""
    return tuple(name for name, present in (
        ("spheres", plan.n_spheres),
        ("moving", plan.n_spheres and plan.has_moving),
        ("perlin", plan.has_perlin), ("image", plan.img_rows),
        ("media", plan.n_media), ("bezier", plan.n_beziers),
        ("klein", plan.n_kleins)) if present)


def _kernel(plan):
    """The plan's variant of the bounce_step library, built at first use;
    argtypes declared."""
    from ..utils import cuda_build
    lib = cuda_build.load("bounce_step", kernel_features(plan))
    fn = lib.srt_bounce_step
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                        ctypes.c_int, ctypes.c_int] + SCENE_ARGTYPES
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def scene_args(plan: BouncePlan):
    """The plan's statics as the four bounce kernels take them, in their C
    order (csrc/bounce_common.cuh SRT_SCENE_PARAMS): the groups' counts and
    pk offsets, the image size, the bounce cap, the media, the Perlin flag,
    the texel atlas's rows, the kleins, the beziers with their seeds and
    Newton steps, the two seeds, and the hit interval."""
    return (plan.n_rects, plan.rect_base, plan.n_spheres, plan.sph_base,
            int(plan.has_moving), plan.n_lights, plan.lgt_base,
            int(plan.light_sampling), plan.nx, plan.ny, plan.max_depth,
            plan.n_media, plan.med_base, int(plan.has_perlin), plan.img_rows,
            plan.n_kleins, plan.kl_base,
            plan.n_beziers, plan.bez_base, plan.bez_seeds, plan.bez_newton,
            plan.seed & 0xFFFFFFFF, plan.perlin_seed & 0xFFFFFFFF,
            cfg_mod.SHADOW_EPS, cfg_mod.BIG)


# The ctypes of `scene_args`.
SCENE_ARGTYPES = ([ctypes.c_int] * 21 + [ctypes.c_uint32] * 2
                  + [ctypes.c_double] * 2)

# Threads a block of K1 and K2 (csrc/bounce_common.cuh kThreads), the
# widths of the tile of threads that carries one lane there (kMaxTile = 8),
# and the sweep length (rects and spheres) from which tile_width splits it
# over two threads a lane.
THREADS = 256
TILE_WIDTHS = (1, 2, 4, 8)
TILE_SWEEP_MIN = 16


def tile_width(plan: BouncePlan, bwd: bool = False) -> int:
    """Threads a lane of the bounce kernel (K1) and the packed kernel (K3)
    or, with `bwd`, of the backward (K2) for this plan: the width of the
    tile over which the closest-hit sweeps split (csrc/bounce_common.cuh
    Tile).  Every width gives the same lanes bit for bit; this is the
    fastest of the widths 1, 2, 4 and 8 that the H100 measured
    (chip_smoke.py's kernel-tile phase, PERF.md), for K1 and K3 alike.
    Every thread of a tile runs the lane's shading, so a width pays only
    where the split chain is long: the bezier probe's seeds (4 in K1 and K3,
    2 in K2) and a sweep of TILE_SWEEP_MIN or more rects and spheres (2).  A
    klein march cannot be split, and a tile only repeats it."""
    if plan.n_kleins:
        return 1
    if plan.n_beziers:
        return 2 if bwd else 4
    return 2 if plan.n_rects + plan.n_spheres >= TILE_SWEEP_MIN else 1


def kernel_blocks(m: int, w: int) -> int:
    """The blocks of the launch of K1, K2, K3 and K4 for m lanes at w
    threads a lane (csrc/bounce_common.cuh lane_blocks): ceil(m w /
    THREADS).  K2 writes one row of partials a block."""
    return -(-(m * w) // THREADS)


# An H100 SM: 65,536 registers, allocated to a warp in units of 256 (a
# thread's count rounded up to 8), and at most 2,048 threads.  The card has
# 132 SMs.
SM_REGISTERS = 65536
SM_THREADS = 2048
SMS = 132


def resident_blocks(registers: int) -> int:
    """Blocks of THREADS threads an SM keeps resident for a kernel of
    `registers` a thread (ptxas's count; the kernels use no more than a few
    hundred bytes of shared memory, which never binds)."""
    per_warp = -(-registers * 32 // 256) * 256
    warps = SM_REGISTERS // per_warp
    return min(warps // (THREADS // 32), SM_THREADS // THREADS)


def launch_waves(m: int, w: int, registers: int, sms: int = SMS) -> int:
    """Waves of the launch of m lanes at w threads a lane: its blocks over
    the blocks the card keeps resident at once."""
    return -(-kernel_blocks(m, w) // (resident_blocks(registers) * sms))


def check_tile(w) -> int:
    """A tile width the kernels take, else ValueError."""
    if w not in TILE_WIDTHS:
        raise ValueError(f"tile width must be one of {TILE_WIDTHS}, got {w}")
    return w


def _check_lane(name, x, dtype, m, device, fn="step_cuda"):
    if x.dtype != dtype or x.shape != (m,) or x.device != device:
        raise ValueError(f"{fn}: {name} must be a [{m}] {dtype} tensor on "
                         f"{device}, got {tuple(x.shape)} {x.dtype} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def _check_pk(plan, pk, dtype, device, fn):
    """Split `pack`'s result for a kernel wrapper and check it: pk
    [plan.size] and, for a plan with image textures, the [plan.img_rows,
    128] texel atlas, contiguous in `dtype` on `device`.  Returns (pk,
    atlas), atlas None without images (the kernel then gets a null
    pointer)."""
    pk, atlas = split_pk(plan, pk)
    _check_lane("pk", pk, dtype, plan.size, device, fn)
    if atlas is not None:
        shape = (plan.img_rows, 128)
        if (atlas.dtype != dtype or atlas.shape != shape
                or atlas.device != device or not atlas.is_contiguous()):
            raise ValueError(
                f"{fn}: the atlas must be a contiguous {list(shape)} {dtype} "
                f"tensor on {device}, got {tuple(atlas.shape)} {atlas.dtype} "
                f"on {atlas.device}")
    return pk, atlas


def tensor_ptr(x):
    """A tensor's device pointer, None (a null pointer) for no tensor."""
    return None if x is None else x.data_ptr()


def step_cuda(plan: BouncePlan, pk, gitem, px, py, fresh, alive, depth,
              o, d, time, rad, tp, tile=None):
    """`step` through the CUDA kernel: same signature, same results to
    floating-point tolerance (the kernel contracts mul+add into FMAs,
    outside the hit point and the sphere probe, and takes cbrt for the fuzz
    radius where `step` keeps the JAX pow form).  `tile` is the threads a
    lane (TILE_WIDTHS), `tile_width(plan)` when None; every width gives the
    same outputs bit for bit.

    Every tensor must lie on one CUDA device, contiguous: pk [plan.size]
    (or `pack`'s (pk, atlas) pair for a plan with image textures) and the
    float lanes in float32 or float64, gitem and depth int32, fresh and
    alive bool, all lanes [M].  Outputs are new tensors (torch.empty);
    the inputs are left unchanged.  Launches on the current stream without
    synchronising and raises if the launch is refused; a launch adds one
    to the process counter `launches.K1` (utils/telemetry).
    """
    check_kernel_plan(plan)
    dev = px.device
    if dev.type != "cuda":
        raise ValueError(f"step_cuda takes CUDA tensors, got {dev}")
    w = check_tile(tile_width(plan) if tile is None else tile)
    dt = px.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"step_cuda: float32 or float64 lanes, got {dt}")
    m = px.shape[0]
    floats = dict(px=px, py=py, ox=o[0], oy=o[1], oz=o[2], dx=d[0], dy=d[1],
                  dz=d[2], time=time, rx=rad[0], ry=rad[1], rz=rad[2],
                  tx=tp[0], ty=tp[1], tz=tp[2])
    for name, x in floats.items():
        _check_lane(name, x, dt, m, dev)
    for name, x in (("gitem", gitem), ("depth", depth)):
        _check_lane(name, x, torch.int32, m, dev)
    for name, x in (("fresh", fresh), ("alive", alive)):
        _check_lane(name, x, torch.bool, m, dev)
    pk, atlas = _check_pk(plan, pk, dt, dev, "step_cuda")

    outs = [torch.empty_like(px) for _ in range(13)]
    scattering = torch.empty(m, dtype=torch.bool, device=dev)
    # the order of srt_bounce_step's pointer array: pk, 19 lanes in, 14 out,
    # the atlas
    tensors = (pk, gitem, px, py, fresh, alive, depth, *o, *d, time, *rad,
               *tp, *outs, scattering, atlas)
    ptrs = (ctypes.c_void_p * len(tensors))(*[tensor_ptr(t) for t in tensors])
    fn = _kernel(plan)
    with torch.cuda.device(dev):
        err = fn(int(dt == torch.float64), ptrs, m, w, *scene_args(plan),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"bounce_step kernel launch failed: CUDA error {err}")
    telemetry.count("launches.K1")
    return ((outs[0], outs[1], outs[2]), (outs[3], outs[4], outs[5]), outs[6],
            (outs[7], outs[8], outs[9]), (outs[10], outs[11], outs[12]),
            scattering)


# ---------------------------------------------------------------------------
# Reverse mode: the port of `as_pallas_vjp` (K1 forward, K2 backward)
# ---------------------------------------------------------------------------

def flat_lanes(o, d, time, rad, tp):
    """(o, d, time, rad, tp) -> the 13 lane tensors, in the kernels' order."""
    return (*o, *d, time, *rad, *tp)


def split_lanes(x):
    """Inverse of flat_lanes: 13 lane tensors -> (o, d, time, rad, tp)."""
    return (tuple(x[0:3]), tuple(x[3:6]), x[6], tuple(x[7:10]),
            tuple(x[10:13]))


def step_vjp(plan: BouncePlan, pk, gitem, px, py, fresh, alive, depth,
             o, d, time, rad, tp, ct_o, ct_d, ct_time, ct_rad, ct_tp):
    """The plain VJP of `step`: torch.autograd.grad of its five float
    outputs against the cotangents (ct_o, ct_d, ct_time, ct_rad, ct_tp).

    Returns (dpk, do, dd, dtime, drad, dtp); dpk has `pk`'s form, so for a
    plan with an atlas it is the pair (dpk, datlas).  It is the oracle of
    the bounce_step_bwd kernel; nothing on the CUDA path calls it."""
    n_pk = 2 if plan.has_atlas else 1
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_()
                  for x in (*(pk if plan.has_atlas else (pk,)),
                            *flat_lanes(o, d, time, rad, tp))]
        out = step(plan, tuple(leaves[:2]) if plan.has_atlas else leaves[0],
                   gitem, px, py, fresh, alive, depth,
                   *split_lanes(leaves[n_pk:]))
        grads = torch.autograd.grad(
            flat_lanes(*out[:5]), leaves,
            flat_lanes(ct_o, ct_d, ct_time, ct_rad, ct_tp), allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    return (tuple(grads[:2]) if plan.has_atlas else grads[0],
            *split_lanes(grads[n_pk:]))


def _kernel_bwd(plan):
    """The plan's variant of the bounce_step_bwd library, built at first
    use; argtypes declared."""
    from ..utils import cuda_build
    lib = cuda_build.load("bounce_step_bwd", kernel_features(plan))
    fn = lib.srt_bounce_step_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                        ctypes.c_int, ctypes.c_int, ctypes.c_int]
                       + SCENE_ARGTYPES + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def bwd_partials(plan: BouncePlan, m, w, dtype, device):
    """K2's partials of the pk and atlas cotangents for m lanes at w threads
    a lane: one row a block of its launch (kernel_blocks), P slots and then
    the atlas's img_rows * 128 texels; the kernel writes every entry."""
    return torch.empty(kernel_blocks(m, w), plan.size + plan.img_rows * 128,
                       dtype=dtype, device=device)


def step_cuda_bwd(plan: BouncePlan, pk, gitem, px, py, fresh, alive, depth,
                  o, d, time, rad, tp, ct_o, ct_d, ct_time, ct_rad, ct_tp,
                  tile=None):
    """`step_vjp` through the CUDA kernel csrc/bounce_step_bwd.cu (the port
    of the Pallas `as_pallas_bwd`): it replays the step from its inputs and
    runs the adjoint, lane by lane.

    Takes the step's inputs as `step_cuda` does and the 13 cotangent lanes
    in the float lanes' dtype, all contiguous on one CUDA device.  `tile`
    is the threads a lane (TILE_WIDTHS), `tile_width(plan, bwd=True)` when
    None: every width gives the same lane cotangents bit for bit, and dpk
    summed in another order.  Returns (dpk, do, dd, dtime, drad, dtp) as new
    tensors; dpk is the sum over blocks of the kernel's (kernel_blocks(m,
    tile), P) partials, taken in a fixed order, so two identical calls give
    bitwise-equal results.  A winning
    sphere takes cotangent in its centres, radius and, in a moving scene,
    its times; dtime is then nonzero.  A winning bezier ribbon takes cotangent
    in its twelve control-point slots (the root's implicit derivative); its
    width takes none.  For a plan with image textures pk is
    `pack`'s (pk, atlas) pair and dpk the pair (dpk, datlas): a partials row
    is then P slots followed by the atlas's img_rows * 128 texels, which take
    the albedo cotangent of the lanes that read them, summed the same way.

    A launch adds one to the process counter `launches.K2`
    (utils/telemetry); the call is the traced span `k2.launch`, which for
    CUDA tensors autograd opens on its own thread."""
    with telemetry.span("k2.launch"):
        check_kernel_plan(plan)
        dev = px.device
        if dev.type != "cuda":
            raise ValueError(f"step_cuda_bwd takes CUDA tensors, got {dev}")
        w = check_tile(tile_width(plan, bwd=True) if tile is None else tile)
        dt = px.dtype
        if dt not in (torch.float32, torch.float64):
            raise TypeError(
                f"step_cuda_bwd: float32 or float64 lanes, got {dt}")
        m = px.shape[0]
        lanes = flat_lanes(o, d, time, rad, tp)
        cts = flat_lanes(ct_o, ct_d, ct_time, ct_rad, ct_tp)
        names = ("ox", "oy", "oz", "dx", "dy", "dz", "time", "rx", "ry",
                 "rz", "tx", "ty", "tz")
        fn = "step_cuda_bwd"
        for name, x in (("px", px), ("py", py), *zip(names, lanes),
                        *zip(["ct_" + n for n in names], cts)):
            _check_lane(name, x, dt, m, dev, fn)
        for name, x in (("gitem", gitem), ("depth", depth)):
            _check_lane(name, x, torch.int32, m, dev, fn)
        for name, x in (("fresh", fresh), ("alive", alive)):
            _check_lane(name, x, torch.bool, m, dev, fn)
        pk, atlas = _check_pk(plan, pk, dt, dev, fn)

        partials = bwd_partials(plan, m, w, dt, dev)
        outs = [torch.empty_like(px) for _ in range(13)]
        # the order of srt_bounce_step_bwd's pointer array: pk, 19 lanes in,
        # 13 cotangents, the partials, 13 lane cotangents out, the atlas
        tensors = (pk, gitem, px, py, fresh, alive, depth, *lanes, *cts,
                   partials, *outs, atlas)
        ptrs = (ctypes.c_void_p * len(tensors))(
            *[tensor_ptr(t) for t in tensors])
        kernel = _kernel_bwd(plan)
        with torch.cuda.device(dev):
            err = kernel(int(dt == torch.float64), ptrs, m, plan.size, w,
                         *scene_args(plan),
                         torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(
                f"bounce_step_bwd kernel launch failed: CUDA error {err}")
        telemetry.count("launches.K2")
        dpk = partials.sum(dim=0)
        if atlas is not None:
            dpk = (dpk[:plan.size], dpk[plan.size:].reshape(atlas.shape))
        return (dpk, *split_lanes(outs))


class BounceStep(torch.autograd.Function):
    """`step` with a hand-written backward: the `as_pallas_vjp` contract.

    The residuals are the step's inputs, nothing else; the backward replays
    the step.  Cotangents reach pk, the atlas (the image texels; None for a
    plan without one), o, d, time, rad and tp; px, py, gitem, fresh, alive
    and depth get None, and `scattering` is not differentiable.  `pair` is
    the (forward, backward) implementation: (step_cuda, step_cuda_bwd) on
    the card (`step_cuda_vjp`); the CPU tests drive the same plumbing with
    (step, step_vjp)."""

    @staticmethod
    def forward(ctx, pair, plan, pk, atlas, gitem, px, py, fresh, alive,
                depth, *lanes):
        out = pair[0](plan, (pk, atlas) if plan.has_atlas else pk, gitem, px,
                      py, fresh, alive, depth, *split_lanes(lanes))
        ctx.pair, ctx.plan = pair, plan
        ctx.save_for_backward(pk, atlas, gitem, px, py, fresh, alive, depth,
                              *lanes)
        ctx.mark_non_differentiable(out[5])
        return (*flat_lanes(*out[:5]), out[5])

    @staticmethod
    def backward(ctx, *cts):
        (pk, atlas, gitem, px, py, fresh, alive, depth,
         *lanes) = ctx.saved_tensors
        plan = ctx.plan
        # autograd hands some cotangents over as strided views (the pool's
        # torch.stack of the radiance lanes): the kernel takes dense lanes
        cts = [c.contiguous() for c in cts[:13]]
        dpk, *grads = ctx.pair[1](
            plan, (pk, atlas) if plan.has_atlas else pk, gitem, px, py,
            fresh, alive, depth, *split_lanes(lanes), *split_lanes(cts))
        dpk, datlas = split_pk(plan, dpk)
        return (None, None, dpk, datlas, None, None, None, None, None, None,
                *flat_lanes(*grads))


def step_with_vjp(pair, plan: BouncePlan, pk, gitem, px, py, fresh, alive,
                  depth, o, d, time, rad, tp):
    """`step`'s signature and results, differentiated by `pair`'s
    backward (BounceStep)."""
    out = BounceStep.apply(pair, plan, *split_pk(plan, pk), gitem, px, py,
                           fresh, alive, depth,
                           *flat_lanes(o, d, time, rad, tp))
    return (*split_lanes(out[:13]), out[13])


def step_cuda_vjp(plan: BouncePlan, pk, gitem, px, py, fresh, alive, depth,
                  o, d, time, rad, tp):
    """`step` on the card for reverse mode: forward through the
    bounce_step kernel (K1), backward through bounce_step_bwd (K2)."""
    return step_with_vjp((step_cuda, step_cuda_bwd), plan, pk, gitem, px,
                         py, fresh, alive, depth, o, d, time, rad, tp)


# ---------------------------------------------------------------------------
# The packed pool state: the port of `as_pallas_packed` (K3)
# ---------------------------------------------------------------------------

# Rows of the packed pool state, a [N_PACKED, m] float32 tensor (the JAX
# (N_PACKED * m / 128, 128) buffer, row group for row group): item, fresh,
# depth, o (3), d (3), time, rad (3), tp (3).  Rows 0 (item) and 2 (depth)
# hold int32 bits, read with .view(torch.int32) and never touched by float
# arithmetic.
N_PACKED = 16

def wrap_i32(x):
    """int64 tensor -> int32 with two's-complement wraparound."""
    return (((x + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31).to(torch.int32)


def strided_item(item, sample_base, n_pix, pix0, total_pix, nx, dtype):
    """The strided queue's work item -> (gitem, px, py, local pixel).

    item (int64) renders frame pixel pix0 + item % n_pix of pass
    item // n_pix; its RNG key is the global (pass, pixel) id
    (sample_base + pass) * total_pix + pixel, wrapped to int32 as in JAX."""
    pixl = item % n_pix
    gpix = pix0 + pixl
    gitem = wrap_i32((sample_base + item // n_pix) * total_pix + gpix)
    return gitem, (gpix % nx).to(dtype), (gpix // nx).to(dtype), pixl


def initial_packed_state(m, device):
    """The packed state of a fresh pool: lane L holds item L, fresh."""
    state = torch.zeros(N_PACKED, m, dtype=torch.float32, device=device)
    state.view(torch.int32)[0] = torch.arange(m, dtype=torch.int32,
                                              device=device)
    state[1] = 1.0
    return state


def step_packed(plan: BouncePlan, pk, sample_base, state, m, n_work, n_pix,
                pix0, total_pix):
    """One strided-pool iteration on the packed state, in plain PyTorch:
    the computation of the JAX `as_pallas_packed` (bounce.py:1923-1970),
    built on `step`.

    state: [N_PACKED, m] float32; sample_base: int or integer tensor.
    Lanes with item >= n_work are drained (alive = false).  A lane whose
    path terminates takes the item m further on, with fresh = 1 and its
    finished radiance left in the rad rows.  Returns the new state (a new
    tensor; the input is unchanged)."""
    st_i = state.view(torch.int32)
    item = st_i[0]
    depth = st_i[2]
    fresh = state[1] != 0.0
    alive = item < n_work
    base = torch.as_tensor(sample_base, device=state.device).to(torch.int64)
    gitem, px, py, _ = strided_item(item.to(torch.int64), base, n_pix, pix0,
                                    total_pix, plan.nx, torch.float32)
    lanes = split_lanes(state[3:])
    o, d, time, rad, tp, scattering = step(plan, pk, gitem, px, py,
                                           fresh & alive, alive, depth,
                                           *lanes)
    terminated = alive & ~scattering
    out = torch.empty_like(state)
    out_i = out.view(torch.int32)
    out_i[0] = torch.where(terminated, item + m, item)
    out[1] = terminated.to(torch.float32)
    out_i[2] = torch.where(scattering, depth + 1, 0)
    out[3:] = torch.stack(flat_lanes(o, d, time, rad, tp))
    return out


def _kernel_packed(plan):
    """The plan's variant of the bounce_packed library, built at first use;
    argtypes declared."""
    from ..utils import cuda_build
    lib = cuda_build.load("bounce_packed", kernel_features(plan))
    fn = lib.srt_bounce_packed
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_int] * 6
                       + SCENE_ARGTYPES + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def check_packed(fn, plan: BouncePlan, pk, sample_base, state, m):
    """The checks of the packed kernels' wrappers; returns pk, the atlas
    (None without images) and sample_base as a [1] int32 tensor on the
    state's device."""
    check_kernel_plan(plan)
    dev = state.device
    if dev.type != "cuda":
        raise ValueError(f"{fn} takes CUDA tensors, got {dev}")
    if (state.dtype != torch.float32 or state.shape != (N_PACKED, m)
            or not state.is_contiguous()):
        raise ValueError(f"{fn}: state must be a contiguous [{N_PACKED}, {m}]"
                         f" float32 tensor, got {tuple(state.shape)} "
                         f"{state.dtype}")
    pk, atlas = _check_pk(plan, pk, torch.float32, dev, fn)
    base = torch.as_tensor(sample_base, device=dev)
    if base.is_floating_point() or base.numel() != 1:
        raise ValueError(f"{fn}: sample_base must be one integer")
    return pk, atlas, base.to(torch.int32).reshape(1)


def queue_args(plan: BouncePlan, m, n_work, n_pix, pix0, total_pix):
    """The queue and scene arguments the packed kernels share, in their C
    order."""
    return (m, n_work, n_pix, pix0, total_pix, *scene_args(plan))


def step_packed_cuda(plan: BouncePlan, pk, sample_base, state, m, n_work,
                     n_pix, pix0, total_pix, tile=None):
    """`step_packed` through the CUDA kernel csrc/bounce_packed.cu (the port
    of the Pallas `as_pallas_packed`): same signature and results to the
    kernel's rounding (it contracts mul+add into FMAs, as K1 does).  `tile`
    is the threads a lane (TILE_WIDTHS), `tile_width(plan)` when None;
    every width gives the same state bit for bit.

    state: a contiguous [N_PACKED, m] float32 tensor on a CUDA device; pk
    [plan.size] float32 on it (or `pack`'s (pk, atlas) pair); sample_base an
    int or an integer tensor (a CUDA tensor is read by the kernel, with no
    host sync).  Returns the new
    state as a new tensor; launches on the current stream without
    synchronising and raises if the launch is refused; a launch adds one
    to the process counter `launches.K3` (utils/telemetry)."""
    fn = "step_packed_cuda"
    w = check_tile(tile_width(plan) if tile is None else tile)
    pk, atlas, base = check_packed(fn, plan, pk, sample_base, state, m)
    out = torch.empty_like(state)
    ptrs = (ctypes.c_void_p * 5)(pk.data_ptr(), base.data_ptr(),
                                 state.data_ptr(), out.data_ptr(),
                                 tensor_ptr(atlas))
    kernel = _kernel_packed(plan)
    dev = state.device
    with torch.cuda.device(dev):
        err = kernel(ptrs, w, *queue_args(plan, m, n_work, n_pix, pix0,
                                          total_pix),
                     torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"bounce_packed kernel launch failed: CUDA error "
                           f"{err}")
    telemetry.count("launches.K3")
    return out
