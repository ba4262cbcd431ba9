"""Masked material shading: scatter + emit for a whole ray batch at once.

The port of scheme_raytrace_tpu/integrator/shade.py.  Every material
implements the full protocol: specular materials are delta distributions
whose s_pdf/pdf ratio is 1, so `throughput *= albedo` (the reference's B3
fix).  All branches are computed masked and select-combined; `shade_sorted`
(RenderConfig.material_sort) ranks the lanes by material type first and
is bit-identical, since `shade` is elementwise over lanes.

Randomness arrives as an explicit [N, N_U] uniform matrix, the counter
hash keyed per (work item, bounce) (core/rng.hash_uniforms); the key-based
`shade_uniforms` of the JAX module belongs to the differentiable wavefront
path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import vecmath as vm
from ..ops import sampling, texture
from ..scene import objects as ob
from . import pdfs

# --- uniform-matrix column layout -------------------------------------------
U_COS_R1, U_COS_R2 = 0, 1             # lambertian cosine draw
U_MIX_PICK = 2                         # mixture cosine-vs-light pick
U_LIGHT_PICK = 3                       # which light
U_RECT_A, U_RECT_B = 4, 5              # rect light point
U_SPH_R1, U_SPH_R2 = 6, 7              # sphere solid-angle draw
U_DIEL = 8                             # dielectric reflect/refract branch
U_BALL_R1, U_BALL_R2, U_BALL_R3 = 9, 10, 11   # unit-ball draw (fuzz/isotropic
                                               # — exclusive per material, shared)
N_U = 12


class Scatter(NamedTuple):
    alive: torch.Tensor       # [N] continues bouncing
    direction: torch.Tensor   # [N,3] unit next direction
    mult: torch.Tensor        # [N,3] throughput multiplier
    emitted: torch.Tensor     # [N,3]


def shade(u, scene, config, d, rec):
    """One bounce of material evaluation for rays d hitting at `rec`.

    u: [N, N_U] uniform draws; d: [N,3] unit incoming directions;
    rec: HitRec.  Valid only where rec.hit — the caller masks.
    """
    n_rays = d.shape[0]
    mat = rec.mat.long()
    mtype = scene.mat_type[mat]
    albedo = texture.value(scene, scene.mat_tex[mat], rec.u, rec.v, rec.p)
    normal = rec.normal

    # --- emission (material.scm:103-111): front face only -----------------
    is_light = mtype == ob.MAT_DIFFUSE_LIGHT
    front = vm.dot(normal, d) < 0.0
    emitted = torch.where((is_light & front)[:, None], albedo,
                          torch.zeros_like(albedo))

    # --- lambertian (material.scm:24-39) -----------------------------------
    # cosine importance sampling => attenuation * s_pdf/pdf == attenuation;
    # with light sampling the mixture pdf splits them (main.scm:113-118)
    if config.light_sampling and scene.n_lights > 0:
        lam_dir, pdf = pdfs.mixture_sample_and_value_u(u, scene, normal,
                                                       rec.p)
        s_pdf = pdfs.cosine_value(normal, lam_dir)     # material.scm:33-36
        ratio = s_pdf / torch.clamp(pdf, min=1e-12)
        lam_mult = albedo * ratio[:, None]
        lam_ok = pdf > 0.0
    else:
        lam_dir = pdfs.cosine_sample_u(u[:, U_COS_R1], u[:, U_COS_R2], normal)
        lam_mult = albedo
        lam_ok = torch.ones(n_rays, dtype=torch.bool, device=d.device)

    # --- unit-ball draw (metal fuzz / isotropic phase — exclusive) ---------
    ball = sampling.in_unit_sphere_u(u[:, U_BALL_R1], u[:, U_BALL_R2],
                                     u[:, U_BALL_R3])

    # --- isotropic phase (geometry.scm:546 commented alternative) ----------
    iso_dir = vm.unit(ball, eps=1e-12)

    # --- metal (material.scm:45-57) ----------------------------------------
    refl = vm.reflect(d, normal)
    fuzzed = refl + scene.mat_fuzz[mat][:, None] * ball
    metal_ok = vm.dot(fuzzed, normal) > 0.0
    metal_dir = vm.unit(fuzzed, eps=1e-12)

    # --- dielectric (material.scm:76-101) -----------------------------------
    ref_idx = scene.mat_ref[mat]
    dd = vm.dot(d, normal)
    exiting = dd > 0.0
    outward_n = vm.where3(exiting, -normal, normal)
    ni_over_nt = torch.where(exiting, ref_idx, 1.0 / ref_idx)
    cosine = torch.where(exiting, dd * ref_idx, -dd)     # |d| == 1
    refr_ok, refracted = vm.refract(d, outward_n, ni_over_nt)
    reflect_prob = torch.where(refr_ok, vm.schlick(cosine, ref_idx), 1.0)
    take_refl = u[:, U_DIEL] < reflect_prob
    diel_dir = vm.unit(vm.where3(take_refl, refl, refracted), eps=1e-12)

    # --- combine ------------------------------------------------------------
    is_lam = mtype == ob.MAT_LAMBERTIAN
    is_metal = mtype == ob.MAT_METAL
    is_diel = mtype == ob.MAT_DIELECTRIC
    is_iso = mtype == ob.MAT_ISOTROPIC

    direction = vm.where3(is_lam, lam_dir,
                          vm.where3(is_metal, metal_dir,
                                    vm.where3(is_diel, diel_dir, iso_dir)))
    mult = torch.where(is_diel[:, None], torch.ones_like(albedo),
                       torch.where(is_lam[:, None], lam_mult, albedo))
    alive = (is_lam & lam_ok) | (is_metal & metal_ok) | is_diel | is_iso
    return Scatter(alive, direction, mult, emitted)


def shade_sorted(u, scene, config, d, rec):
    """Material-sorted dispatch (SURVEY §2.4: each 'expert' a material).

    Lanes are ranked by the hit material's type (a stable sort), gathered
    into material-major order, shaded by `shade`, and gathered back.
    `shade` is elementwise over lanes, so the permutation commutes with it
    exactly: the result is bit-identical to `shade`'s.
    """
    mtype = scene.mat_type[rec.mat.long()]
    order = torch.argsort(mtype, stable=True)
    inv = torch.argsort(order, stable=True)
    sc = shade(u[order], scene, config, d[order],
               _map_rec(rec, lambda x: x[order]))
    return Scatter(*(x[inv] for x in sc))


def _map_rec(rec, fn):
    """`rec` with `fn` applied to every field (the JAX tree.map)."""
    return type(rec)(*(fn(x) for x in rec))
