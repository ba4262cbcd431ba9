"""Flat threaded BVH traversal over MIXED analytic prims (spheres + rects).

The port of scheme_raytrace_tpu/ops/traverse.py: every ray carries a node
cursor; one step slab-tests the cursor node (clipped to the ray's best t,
the closest-so-far pruning of the reference's recursive node hit,
geometry.scm:244-257, :352-368), intersects the leaf's prim slots, then
follows the hit or miss link.  Stackless, fixed state, no recursion.

Leaf slots hold GLOBAL prim ids (spheres [0, nS), rects [nS, nS + nR);
scene/build.py packs the tree that way), so one tree spans both groups;
per slot both prim tests run masked by the id's kind.  The loop checks on
the host every DRAIN_EVERY steps whether a ray still walks.
"""

from __future__ import annotations

import math

import torch

from ..core import vecmath as vm
from . import rect as rect_mod
from . import sphere as sphere_mod

# The walk checks on the host whether any ray still walks every DRAIN_EVERY
# steps: once every cursor is -1 a step changes nothing, so the steps run
# past the last live cursor are no-ops.
DRAIN_EVERY = 8


def safe_inv(d):
    """1/d with exact-zero components sent to +-1e30 (0 * inf = NaN would
    poison the slab min/max of rays parallel to an axis)."""
    big = d.new_tensor(1e30)
    return torch.where(torch.abs(d) > 1e-30,
                       1.0 / torch.where(d == 0, 1.0, d),
                       torch.where(d >= 0, big, -big))


def walk(step, cursor, *carry):
    """Run `step(cursor, *carry) -> (cursor, *carry)` until every cursor is
    -1, checking on the host every DRAIN_EVERY steps (the lax.while_loop of
    the JAX traversals)."""
    while bool((cursor >= 0).any()):
        for _ in range(DRAIN_EVERY):
            cursor, *carry = step(cursor, *carry)
    return carry


def _sphere_table(scene):
    """[S, 9] rows (c0, c1 - c0, t0, span, r), span = t1 - t0 with 0 sent
    to 1: what a slot's centre at ray time and its quadratic read, so a
    traversal step gathers them with one launch (the same values as
    gathering each field and subtracting after)."""
    span = scene.sph_t1 - scene.sph_t0
    return torch.cat([scene.sph_c0, scene.sph_c1 - scene.sph_c0,
                      scene.sph_t0[:, None],
                      torch.where(span == 0.0, 1.0, span)[:, None],
                      scene.sph_r[:, None]], dim=1)


def intersect_bvh_mixed(o, d, time, scene, t_min, t_max):
    """Closest sphere-or-rect hit via the flat threaded BVH.

    Returns the standard group tuple (hit, t, normal, mat, u, v).  A step
    reads each node's box, links and slots, and each slot's sphere, with
    one gather apiece (tables built once a call); the values are the JAX
    step's."""
    n = o.shape[0]
    dt, dev = o.dtype, o.device
    nS = int(scene.sph_r.shape[0]) if scene.has_spheres else 0
    has_rects = scene.has_rects
    inv_d = safe_inv(d)
    boxes = torch.stack([scene.bvh_pmin, scene.bvh_pmax], dim=1)  # [B,2,3]
    links = torch.stack([scene.bvh_miss, scene.bvh_hit], dim=1).long()
    slots = scene.bvh_prims.long()
    sph = _sphere_table(scene) if nS else None
    o_b, inv_b = o[:, None, :], inv_d[:, None, :]

    def sphere_slot_t(pj, ok_mask, bt):
        """Per [N, L] slot the sphere's nearest root in (t_min, best t)."""
        row = sph[torch.clamp(pj, max=nS - 1)]             # [N,L,9]
        c = row[..., 0:3]
        if scene.has_moving:                    # geometry.scm:188-193
            frac = (time[:, None] - row[..., 6]) / row[..., 7]
            c = c + frac[..., None] * row[..., 3:6]
        ok, t0, t1 = sphere_mod._quadratic(o_b - c, d[:, None, :],
                                           row[..., 8], ok_mask)
        t0 = torch.where(ok & (t0 > t_min) & (t0 < bt), t0, math.inf)
        t1 = torch.where(ok & (t1 > t_min) & (t1 < bt), t1, math.inf)
        return torch.minimum(t0, t1)

    def rect_slot_t(pj, ok_mask, bt):
        """Per [N, L] slot the rect's hit t in [t_min, best t)."""
        rj = torch.clamp(pj - nS, 0, scene.rect_k.shape[0] - 1)
        if scene.has_rect_xform:
            rot = scene.rect_rot[rj]                        # [N,L,3,3]
            o_l = torch.einsum("nlji,nlj->nli", rot,
                               o_b - scene.rect_trans[rj])
            d_l = torch.einsum("nlji,nj->nli", rot, d)
        else:
            o_l = o_b.expand(rj.shape + (3,))
            d_l = d[:, None, :].expand(rj.shape + (3,))
        n_sel, a_sel, b_sel = rect_mod.selectors(scene.rect_axis[rj], dt)
        dn = vm.dot(d_l, n_sel)
        dn_ok = dn != 0.0
        dn = torch.where(dn_ok, dn, 1.0)
        t = (scene.rect_k[rj] - vm.dot(o_l, n_sel)) / dn
        pa = vm.dot(o_l, a_sel) + t * vm.dot(d_l, a_sel)
        pb = vm.dot(o_l, b_sel) + t * vm.dot(d_l, b_sel)
        ok = (ok_mask & dn_ok
              & (t >= t_min) & (t < bt)
              & scene.rect_valid[rj]
              & (pa >= scene.rect_a0[rj]) & (pa <= scene.rect_a1[rj])
              & (pb >= scene.rect_b0[rj]) & (pb <= scene.rect_b1[rj]))
        return torch.where(ok, t, math.inf)

    def step(cursor, best_t, best_g):
        node = torch.clamp(cursor, min=0)
        active = cursor >= 0
        # the node's slab test, clipped to the ray's best t so far
        ab = (boxes[node] - o_b) * inv_b                    # [N,2,3]
        lo, hi = torch.aminmax(ab, dim=1)
        entry = torch.clamp(torch.amax(lo, -1), min=t_min)
        exit_ = torch.minimum(torch.amin(hi, -1), best_t)
        box_hit = active & (entry < exit_)
        # the leaf's prim slots [N, L] (-1 pads; inner nodes have none)
        prims = slots[node]
        slot_ok = box_hit[:, None] & (prims >= 0)
        pj = torch.clamp(prims, min=0)
        bt = best_t[:, None]
        if has_rects:
            is_rect = pj >= nS
            t_slot = torch.full(pj.shape, math.inf, dtype=dt, device=dev)
            if nS:
                t_slot = torch.minimum(t_slot, sphere_slot_t(
                    pj, slot_ok & ~is_rect, bt))
            t_slot = torch.minimum(t_slot, rect_slot_t(pj, slot_ok & is_rect,
                                                       bt))
        else:
            t_slot = sphere_slot_t(pj, slot_ok, bt)
        t_new, k = torch.min(t_slot, dim=1)
        g_new = torch.gather(pj, 1, k[:, None])[:, 0]
        closer = t_new < best_t
        best_t = torch.where(closer, t_new, best_t)
        best_g = torch.where(closer, g_new, best_g)
        # follow the hit link where the box was hit, else the miss link
        nxt = links[node, box_hit.long()]
        return torch.where(active, nxt, cursor), best_t, best_g

    cursor = torch.zeros(n, dtype=torch.int64, device=dev)
    best_t = torch.full((n,), t_max, dtype=dt, device=dev)
    best_g = torch.zeros(n, dtype=torch.int64, device=dev)
    best_t, g = walk(step, cursor, best_t, best_g)

    hit = best_t < t_max
    tb = torch.where(hit, best_t, t_max)
    p = o + tb[:, None] * d
    is_rect = (g >= nS) if has_rects else torch.zeros_like(hit)

    # resolve the attributes per winning prim kind
    normal = p.new_tensor([0.0, 1.0, 0.0]).expand(p.shape)
    mat = torch.zeros(n, dtype=torch.int64, device=dev)
    u = torch.zeros(n, dtype=dt, device=dev)
    v = torch.zeros(n, dtype=dt, device=dev)
    if nS:
        sj = torch.clamp(g, max=nS - 1)
        cj = sphere_mod._center_at(scene, sj, time)
        rjr = scene.sph_r[sj]
        n_s = (p - cj) / rjr[:, None]
        us, vs = sphere_mod.sphere_uv(n_s * torch.sign(rjr)[:, None])
        sel = ~is_rect
        normal = torch.where(sel[:, None], n_s, normal)
        mat = torch.where(sel, scene.sph_mat[sj].long(), mat)
        u = torch.where(sel, us, u)
        v = torch.where(sel, vs, v)
    if has_rects:
        rj = torch.clamp(g - nS, 0, scene.rect_k.shape[0] - 1)
        n_sel, a_sel, b_sel = rect_mod.selectors(scene.rect_axis[rj], dt)
        n_obj = n_sel * scene.rect_flip[rj][:, None]
        if scene.has_rect_xform:
            n_r = torch.einsum("nij,nj->ni", scene.rect_rot[rj], n_obj)
            p_l = torch.einsum("nji,nj->ni", scene.rect_rot[rj],
                               p - scene.rect_trans[rj])
        else:
            n_r = n_obj
            p_l = p
        pa = vm.dot(p_l, a_sel)
        pb = vm.dot(p_l, b_sel)
        ur = (pa - scene.rect_a0[rj]) / (scene.rect_a1[rj]
                                         - scene.rect_a0[rj])
        vr = (pb - scene.rect_b0[rj]) / (scene.rect_b1[rj]
                                         - scene.rect_b0[rj])
        normal = torch.where(is_rect[:, None], n_r, normal)
        mat = torch.where(is_rect, scene.rect_mat[rj].long(), mat)
        u = torch.where(is_rect, ur, u)
        v = torch.where(is_rect, vr, v)
    return hit, tb, normal, mat, u, v
