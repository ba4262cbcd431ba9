"""Importance-sampling PDFs (pdf.scm + the machinery it left unfinished).

The port of the uniform-draw forms of scheme_raytrace_tpu/integrator/
pdfs.py: the cosine PDF, the hittable PDFs of xz-rect and sphere lights
(pdf.scm's missing g:pdf-value / g:random, bug B5, with the standard RTROYL
formulas) and the 50/50 mixture.  Several lights follow the hittable-list
PDF: `value` averages over lights, `sample` picks one uniformly.  Each
sampler also has the reference's key-based form, which draws its columns
from a threefry key (core/rng.uniform, bitwise jax.random.uniform).
"""

from __future__ import annotations

import math

import torch

from ..core import rng
from ..core import vecmath as vm
from ..ops import onb, sampling
from ..scene import build as sb

_PI = math.pi


def cosine_value(n, direction):
    """pdf.scm:18-26 — max(cos, 0)/pi about normal n."""
    cosine = vm.dot(vm.unit(direction), n)
    return vm.maximum(cosine, 0.0) / _PI


def cosine_sample_u(r1, r2, n):
    """pdf.scm:24-26 — cosine-weighted direction about n (B4 fixed)."""
    u, v, w = onb.from_w(n)
    local_dir = sampling.cosine_direction_u(r1, r2)
    return vm.unit(onb.local(u, v, w, local_dir))


def cosine_sample(key, n):
    r = rng.uniform(key, n.shape[:-1] + (2,), n.dtype)
    return cosine_sample_u(r[..., 0], r[..., 1], n)


def _rect_value_one(rect, origin, direction):
    """Hittable-PDF value of one xz-rect light (RTROYL §12.1 for B5).

    rect = (x0, x1, z0, z1, k).  pdf = t^2 / (|cos| * area) where the ray
    from `origin` along unit `direction` hits the rect plane inside bounds.
    Every value that reaches arithmetic is re-selected to a benign constant
    on masked lanes (miss lanes reach here too).
    """
    x0, x1, z0, z1, k = (rect[i] for i in range(5))
    dy = direction[..., 1]
    dy_ok = torch.abs(dy) > 1e-9
    t_raw = (k - origin[..., 1]) / torch.where(dy_ok, dy, 1.0)
    px = origin[..., 0] + t_raw * direction[..., 0]
    pz = origin[..., 2] + t_raw * direction[..., 2]
    inside = (dy_ok & (t_raw > 1e-3) & (t_raw < 1e8) & (px >= x0)
              & (px <= x1) & (pz >= z0) & (pz <= z1))
    t = torch.where(inside, t_raw, 1.0)
    area = (x1 - x0) * (z1 - z0)
    dist_sq = t * t                      # |direction| == 1
    cosine = torch.abs(dy)
    denom = torch.where(inside, vm.maximum(cosine * area, 1e-12), 1.0)
    return torch.where(inside, dist_sq / denom, 0.0)


def _sphere_value_one(center, radius, origin, direction):
    """Hittable-PDF value of one sphere light: 1 / solid angle (RTROYL §12.2),
    nonzero only where `direction` points into the sphere's cone."""
    oc = center - origin
    dist_sq = vm.sq_len(oc)
    outside = dist_sq > radius * radius
    ratio = vm.clip(radius * radius / vm.maximum(dist_sq, 1e-12), 0.0, 1.0)
    # double-where: inside the sphere 1 - ratio hits 0 and sqrt' blows up
    cos_theta_max = torch.sqrt(torch.where(outside, 1.0 - ratio, 1.0))
    solid_angle = 2.0 * _PI * (1.0 - cos_theta_max)
    # the direction must meet the sphere: cos(angle to centre) >= cos_theta_max
    cos_dir = vm.dot(vm.unit(direction), vm.unit(oc))
    hitting = outside & (cos_dir >= cos_theta_max)
    return torch.where(hitting, 1.0 / vm.maximum(solid_angle, 1e-12),
                       0.0)


def lights_value(scene, origin, direction):
    """Average hittable-PDF value over the scene's lights (hittable-list PDF)."""
    vals = []
    for i in range(scene.n_lights):
        is_rect = scene.light_kind[i] == sb.LIGHT_XZ_RECT
        rv = _rect_value_one(scene.light_rect[i], origin, direction)
        sv = _sphere_value_one(scene.light_center[i], scene.light_radius[i],
                               origin, direction)
        vals.append(torch.where(is_rect, rv, sv))
    return sum(vals) / scene.n_lights


def lights_sample_u(r_pick, r_a, r_b, r_s1, r_s2, scene, origin):
    """Sample a direction toward one uniformly-chosen light (unit vector).

    r_pick selects the light; (r_a, r_b) parameterize the rect point;
    (r_s1, r_s2) drive the sphere solid-angle draw.
    """
    pick = torch.clamp((r_pick * scene.n_lights).to(torch.int32),
                       max=scene.n_lights - 1).long()
    kind = scene.light_kind[pick]
    rect = vm.take(scene.light_rect, pick)              # [N,5]
    # rect sample: uniform point on the rect (RTROYL `random` for xz-rect)
    px = rect[:, 0] + r_a * (rect[:, 1] - rect[:, 0])
    pz = rect[:, 2] + r_b * (rect[:, 3] - rect[:, 2])
    target = torch.stack([px, rect[:, 4], pz], dim=-1)
    # eps guard: lanes on the light itself (masked later) may give
    # target == origin
    rect_dir = vm.unit(target - origin, eps=1e-6)

    # sphere sample: random-to-sphere (util.scm:46-54) in an ONB toward centre
    center = vm.take(scene.light_center, pick)
    radius = vm.take(scene.light_radius, pick)
    oc = center - origin
    dist_sq = vm.maximum(vm.sq_len(oc), 1e-12)
    u, v, w = onb.from_w(oc)
    local_dir = sampling.to_sphere_u(r_s1, r_s2, radius, dist_sq)
    sph_dir = vm.unit(onb.local(u, v, w, local_dir))

    return vm.where3(kind == sb.LIGHT_XZ_RECT, rect_dir, sph_dir)


def lights_sample(key, scene, origin):
    r = rng.uniform(key, (origin.shape[0], 5), origin.dtype)
    return lights_sample_u(r[:, 0], r[:, 1], r[:, 2], r[:, 3], r[:, 4],
                           scene, origin)


def mixture_sample_and_value_u(u, scene, n, p):
    """make-mixture-pdf (pdf.scm:34-41): 50/50 cosine-about-n / lights.

    u: [N, >=8] uniform matrix (shade.py column layout: cols 0-7).
    Returns (direction [N,3] unit, pdf_value [N]).
    """
    use_light = u[:, 2] < 0.5
    d_cos = cosine_sample_u(u[:, 0], u[:, 1], n)
    d_light = lights_sample_u(u[:, 3], u[:, 4], u[:, 5], u[:, 6], u[:, 7],
                              scene, p)
    direction = vm.where3(use_light, d_light, d_cos)
    pdf = (0.5 * cosine_value(n, direction)
           + 0.5 * lights_value(scene, p, direction))
    return direction, pdf


def mixture_sample_and_value(key, scene, n, p):
    u = rng.uniform(key, (n.shape[0], 8), n.dtype)
    return mixture_sample_and_value_u(u, scene, n, p)
