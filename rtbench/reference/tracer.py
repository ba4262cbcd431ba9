"""The plain reference path tracer: one path a lane, bounce by bounce.

What the benchmark holds the program to.  Every path is keyed by its
global work item (sample_base + pass) * total_pix + pixel, wrapped to
int32, and draws its numbers from the PCG4D stream (rng.py) at that item
and its depth, so the reference traces the very paths the renderer is
asked for, and a pixel's passes add in pass order from 0.0.  One bounce:
the closest hit over the rects, then the spheres, then the kleins, then
the ribbons (the first of equal distances wins); the gradient sky on a
miss; the front face of a light emits; a Lambertian surface scatters by
the cosine density, or with light sampling by the even mixture of it and
the lights' solid-angle density (Shirley, "Ray Tracing: The Rest of Your
Life", ch. 9-12); a path ends on a miss, a light, or at `max_depth`
scatters.  A ribbon is hit where
the curve's ray-space distance has a root of g'(s) = 0 within half its
width (Newton from `bezier_seeds` fixed seeds, `bezier_newton` steps); the
gradient of a hit's distance is the implicit function's at the root.

A klein (the Kleinian limit set, geometry.scm:580-664) is sphere-traced:
from the ray's origin, at most 100 steps, each advancing by the distance
estimate (DE) at the current point: up to 10 inversions of the point in
the first of six spheres of radius 300 that holds it, then
DE = 0.7 (|p| - 125) / |dr| (:590-624); the hit is the advanced length
where the DE was under 0.001 and that length lies past t_min and short of
the closest hit so far (:635-661, the object list passing its closest
distance on as t_max).  Where this departs from geometry.scm, and why:
  * the normal is the unit exact gradient of the DE (autograd of the DE
    below), not central differences of step 0.01 (:626-632): a
    differentiable normal, as the program and the JAX package have;
  * the hit's t is differentiated as one Newton step of DE(o + t d) - 0.001
    from the accepted length, whose derivative at a root is the implicit
    function's; its value is the accepted length;
  * a ray that never enters the ball of radius 726 about the centre on
    (t_min, t_max) is not marched, and a lane stops once its point lies
    outside that ball and moves away from the centre: every point with a
    DE under 0.001 lies inside |p - c| < 424.26 + 300 = 724.26, and
    outside it the DE is 0.7 (|p - c| - 125) > 0, so such a ray never
    accepts (exact);
  * the inversion loop ends once no lane's point lies in a sphere: such a
    point never changes again (exact).
No other retirement: a lane whose point sits inside the solid at a length
under t_min, or has passed t_max, marches on to the step cap as in
geometry.scm.

Plain PyTorch, any device and float type, differentiable in the scene's
float arrays (RefScene.leaves).  Lanes that end drop out of the wavefront.
"""

from __future__ import annotations

import math

import torch

from . import rng
from .scene import MAT_DIFFUSE_LIGHT, MAT_LAMBERTIAN, TEX_CHECKER

BIG = 999999999999.0       # "no hit" distance
T_MIN = 0.001              # every ray's near bound
TWO_PI = 2.0 * math.pi


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def where3(m, a, b):
    return tuple(torch.where(m, x, y) for x, y in zip(a, b))


def vmax(x, c):
    return torch.maximum(x, x.new_tensor(c))


def clip(x, lo, hi):
    return torch.minimum(vmax(x, lo), x.new_tensor(hi))


def unit3(a, eps=1e-12):
    inv = torch.rsqrt(vmax(dot3(a, a), eps))
    return tuple(x * inv for x in a)


class _Take(torch.autograd.Function):
    """table[idx] for a small [T, F] table; the backward sums each row's
    cotangents by a one-hot product (no float atomics, repeatable)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        onehot = (torch.arange(ctx.rows, device=idx.device)[:, None]
                  == idx[None, :]).to(g.dtype)
        return onehot @ g, None


def take(table, idx):
    """Rows `idx` of `table` ([T, ...]) as [N, ...]."""
    flat = table.reshape(table.shape[0], -1)
    return _Take.apply(flat, idx).reshape(idx.shape + table.shape[1:])


def camera_basis(cam: dict, dtype, device):
    """(origin, lower_left, horizontal, vertical, u, v) of the pinhole or
    thin-lens camera (its `aspect` is the frame's width over its height),
    in the working precision."""
    f = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    lookfrom, lookat, vup = f(cam["lookfrom"]), f(cam["lookat"]), f(cam["vup"])
    half_h = torch.tan(f(cam["vfov"]) * (math.pi / 180.0) / 2.0)
    half_w = f(cam["aspect"]) * half_h
    unit = lambda a: a / torch.sqrt(torch.sum(a * a))
    w = unit(lookfrom - lookat)
    u = unit(torch.linalg.cross(vup, w))
    v = torch.linalg.cross(w, u)
    fd = f(cam["focus_dist"])
    ll = lookfrom - half_w * fd * u - half_h * fd * v - fd * w
    return dict(origin=lookfrom, ll=ll, hor=2.0 * half_w * fd * u,
                ver=2.0 * half_h * fd * v, u=u, v=v,
                lens_r=f(cam["aperture"]) / 2.0, t0=f(cam["time0"]),
                dt=f(cam["time1"]) - f(cam["time0"]))


def camera_rays(basis, nx, ny, uc, px, py):
    s = (px + uc[0]) * (1.0 / nx)
    t = (py + uc[1]) * (1.0 / ny)
    r = torch.sqrt(uc[2])
    phi = TWO_PI * uc[3]
    rdx = basis["lens_r"] * r * torch.cos(phi)
    rdy = basis["lens_r"] * r * torch.sin(phi)
    cu, cv, org = basis["u"], basis["v"], basis["origin"]
    off = tuple(cu[i] * rdx + cv[i] * rdy for i in range(3))
    o = tuple(org[i] + off[i] for i in range(3))
    ll, hor, ver = basis["ll"], basis["hor"], basis["ver"]
    d = tuple(ll[i] + s * hor[i] + t * ver[i] - org[i] - off[i]
              for i in range(3))
    return o, unit3(d)


class Prims:
    """Per-primitive world-space fields derived from the scene's leaves
    (differentiably): rect planes, sphere centres, ribbon control points,
    klein centres, and every primitive's albedo pair from its material's
    texture."""

    def __init__(self, sc, dtype, work=None):
        L = {k: v.to(dtype) for k, v in sc.leaves.items()}
        self.L, self.sc = L, sc
        dev = L["tex_color"].device
        tex = torch.as_tensor(sc.mat_tex, device=dev)
        ttype = torch.as_tensor(sc.tex_type, device=dev)
        c0 = torch.as_tensor(sc.tex_child0, device=dev)
        c1 = torch.as_tensor(sc.tex_child1, device=dev)
        is_chk = ttype[tex] == TEX_CHECKER
        tc = L["tex_color"]
        # per material: (albedo even/constant, albedo odd, type, checker)
        self.m_alb0 = torch.where(is_chk[:, None], tc[c0[tex]], tc[tex])
        self.m_alb1 = tc[c1[tex]]
        self.m_type = torch.as_tensor(sc.mat_type, device=dev)
        self.m_chk = is_chk
        if sc.n_rects:
            axis = torch.as_tensor(sc.rect_axis, device=dev)
            eye = torch.eye(3, dtype=dtype, device=dev)
            nsel = eye[axis]
            asel = eye[torch.where(axis == 0, 1, 0)]
            bsel = eye[torch.where(axis == 2, 1, 2)]
            rot, trans = L["rect_rot"], L["rect_trans"]
            mv = lambda sel: (rot * sel[:, None, :]).sum(-1)   # rot @ sel
            s3 = lambda x: x[:, 0] + x[:, 1] + x[:, 2]
            n_w, a_w, b_w = mv(nsel), mv(asel), mv(bsel)
            tn, ta, tb = s3(trans * n_w), s3(trans * a_w), s3(trans * b_w)
            flip = L["rect_flip"]
            self.r_wn = n_w * flip[:, None]
            self.r_k = (L["rect_k"] + tn) * flip
            self.r_a, self.r_b = a_w, b_w
            self.r_ka = (L["rect_a0"] + ta, L["rect_a1"] + ta)
            self.r_kb = (L["rect_b0"] + tb, L["rect_b1"] + tb)
            self.r_mat = torch.as_tensor(sc.rect_mat, device=dev)
        if sc.n_spheres:
            self.s_c, self.s_r = L["sph_c0"], L["sph_r"]
            self.s_mat = torch.as_tensor(sc.sph_mat, device=dev)
        if sc.n_beziers:
            self.b_cp, self.b_w = L["bez_cp"], L["bez_w"]
            self.b_mat = torch.as_tensor(sc.bez_mat, device=dev)
        if sc.n_kleins:
            self.k_c = L["kl_center"]
            self.k_mat = torch.as_tensor(sc.kl_mat, device=dev)
        # the kleins' march work (klein_march): lane-steps, inversions and
        # accepted hits, added into the caller's dict if it gives one
        self.klein_work = dict(steps=0, inversions=0, hits=0) \
            if work is None else work


def _rects(P, o, d, best):
    """Closest rect of every lane; the winner's distance again with
    gradient."""
    with torch.no_grad():
        oo = [x.detach()[:, None] for x in o]
        dd = [x.detach()[:, None] for x in d]
        wn = P.r_wn.detach().t()
        dn = dot3(dd, wn)
        dn_ok = dn != 0.0
        dn = torch.where(dn_ok, dn, 1.0)
        t = (P.r_k.detach() - dot3(oo, wn)) / dn
        av, bv = P.r_a.detach().t(), P.r_b.detach().t()
        pa = dot3(oo, av) + t * dot3(dd, av)
        pb = dot3(oo, bv) + t * dot3(dd, bv)
        ok = (dn_ok & (t >= T_MIN) & (t <= BIG)
              & (pa >= P.r_ka[0].detach()) & (pa <= P.r_ka[1].detach())
              & (pb >= P.r_kb[0].detach()) & (pb <= P.r_kb[1].detach()))
        tt = torch.where(ok, t, math.inf)
        idx = torch.argmin(tt, dim=1)
        hit = tt.gather(1, idx[:, None])[:, 0] < BIG
    wn = take(P.r_wn, idx).unbind(1)
    t = (take(P.r_k, idx) - dot3(o, wn)) / torch.where(hit, dot3(d, wn), 1.0)
    closer = hit & (t < best["t"])
    return _merge(P, best, closer, t, wn, take(P.r_mat, idx))


def _spheres(P, o, d, best):
    with torch.no_grad():
        ok, t, _ = _sphere_hit([x.detach()[:, None] for x in o],
                               [x.detach()[:, None] for x in d],
                               P.s_c.detach().t(), P.s_r.detach())
        idx = torch.argmin(torch.where(ok, t, math.inf), dim=1)
    c = take(P.s_c, idx).unbind(1)
    r = take(P.s_r, idx)
    ok, t, c = _sphere_hit(o, d, c, r)
    closer = ok & (t < best["t"])
    inv_r = 1.0 / torch.where(closer, r, 1.0)
    wn = tuple((o[i] + t * d[i] - c[i]) * inv_r for i in range(3))
    return _merge(P, best, closer, t, wn, take(P.s_mat, idx))


def _sphere_hit(o, d, c, r):
    oc = tuple(o[i] - c[i] for i in range(3))
    bq = dot3(oc, d)
    cq = dot3(oc, oc) - r * r
    disc = bq * bq - cq
    okd = disc > 0.0
    sq = torch.sqrt(torch.where(okd, disc, 1.0))
    t0, t1 = -bq - sq, -bq + sq
    in0 = okd & (t0 > T_MIN) & (t0 < BIG)
    in1 = okd & (t1 > T_MIN) & (t1 < BIG)
    return in0 | in1, torch.where(in0, t0, torch.where(in1, t1, BIG)), c


def _g_derivs(ax, ay, s):
    cx = ax[0] + s * (ax[1] + s * (ax[2] + s * ax[3]))
    cy = ay[0] + s * (ay[1] + s * (ay[2] + s * ay[3]))
    cx1 = ax[1] + s * (2.0 * ax[2] + s * (3.0 * ax[3]))
    cy1 = ay[1] + s * (2.0 * ay[2] + s * (3.0 * ay[3]))
    cx2 = 2.0 * ax[2] + s * (6.0 * ax[3])
    cy2 = 2.0 * ay[2] + s * (6.0 * ay[3])
    g = cx * cx + cy * cy
    dg = 2.0 * (cx * cx1 + cy * cy1)
    speed2 = 2.0 * (cx1 * cx1 + cy1 * cy1)
    return g, dg, speed2 + 2.0 * (cx * cx2 + cy * cy2), speed2


def _power(p0, p1, p2, p3):
    return (p0, 3.0 * (p1 - p0), 3.0 * (p0 - 2.0 * p1 + p2),
            -p0 + 3.0 * p1 - 3.0 * p2 + p3)


def _ribbon(cfg, cp, width, o, d):
    """(hit, distance) of one ribbon (control points cp [4, 3])."""
    pick = torch.abs(d[0]) > 0.9
    dt = d[0].dtype
    a_vec = (torch.where(pick, 0.0, 1.0).to(dt),
             torch.where(pick, 1.0, 0.0).to(dt), torch.zeros_like(d[0]))
    v_f = unit3(cross3(d, a_vec))
    u_f = cross3(v_f, d)
    cx, cy, cz = [], [], []
    for k in range(4):
        rel = tuple(cp[k, i] - o[i] for i in range(3))
        cx.append(dot3(rel, u_f))
        cy.append(dot3(rel, v_f))
        cz.append(dot3(rel, d))
    ax, ay, az = _power(*cx), _power(*cy), _power(*cz)
    hw = width * 0.5
    n = cfg["bezier_seeds"]
    with torch.no_grad():
        axs, ays = [c.detach() for c in ax], [c.detach() for c in ay]
        s = ((torch.arange(n, dtype=dt, device=d[0].device) + 0.5)
             * (1.0 / n))[:, None] + torch.zeros_like(d[0])
        for _ in range(cfg["bezier_newton"]):
            _, dg, d2g, _ = _g_derivs(axs, ays, s)
            curved = d2g > 1e-12
            step = torch.where(curved, dg / torch.where(curved, d2g, 1e-12),
                               0.0)
            s = clip(s - step, 0.0, 1.0)
    _, dg, d2g, speed2 = _g_derivs(ax, ay, s)
    interior = (s > 0.0) & (s < 1.0)
    corr = torch.where(interior, dg / torch.maximum(d2g, 0.05 * speed2
                                                    + 1e-12), 0.0)
    s = s - (corr - corr.detach())
    g, _, _, _ = _g_derivs(ax, ay, s)
    zc = az[0] + s * (az[1] + s * (az[2] + s * az[3]))
    ok = (g < hw * hw) & (zc > 1e-4) & (zc > T_MIN) & (zc <= BIG)
    cand = torch.where(ok, zc, BIG)
    t = torch.full_like(d[0], BIG)
    for k in range(n):                      # in seed order: ties split
        t = torch.minimum(t, cand[k])
    return t < BIG, t


def _beziers(P, cfg, o, d, best):
    for j in range(P.sc.n_beziers):
        ok, t = _ribbon(cfg, P.b_cp[j], P.b_w[j], o, d)
        closer = ok & (t < best["t"])
        best = _merge(P, best, closer, t, tuple(-x for x in d),
                      P.b_mat[j].expand_as(t))
    return best


# --- the Kleinian limit set (geometry.scm:580-664) -------------------------

KLEIN_SPHERES = ((300.0, 300.0, 0.0), (300.0, -300.0, 0.0),
                 (-300.0, 300.0, 0.0), (-300.0, -300.0, 0.0),
                 (0.0, 0.0, 424.26), (0.0, 0.0, -424.26))   # :590-598
KLEIN_SPHERE_R, KLEIN_R, KLEIN_DE_SCALE = 300.0, 125.0, 0.7  # :590, :600, :607
KLEIN_ITERATIONS, KLEIN_MAX_STEPS = 10, 100                  # :610, :635
KLEIN_EPS = 0.001                                            # :656
KLEIN_BALL_R = 726.0       # past 424.26 + 300: no point there has DE < eps


def klein_de(q, work=None):
    """The distance estimate at klein-local points q ([N, 3], q = p - c):
    up to KLEIN_ITERATIONS times, the point inverted in the first sphere
    (in KLEIN_SPHERES' order) whose interior holds it, p <- (p - s) r^2 /
    |p - s|^2 + s, and dr scaled by the same r^2 / |p - s|^2; then
    0.7 (|p| - 125) / |dr|.  Differentiable in q (the sphere is picked
    without gradient, and the inversion in it computed again with it);
    `work` counts the inversions."""
    sph = q.new_tensor(KLEIN_SPHERES)                      # [6, 3]
    r2 = KLEIN_SPHERE_R * KLEIN_SPHERE_R
    p, dr = q, torch.ones_like(q[:, 0])
    inside_any = torch.ones_like(dr, dtype=torch.bool)
    for _ in range(KLEIN_ITERATIONS):
        with torch.no_grad():
            diff = p.detach()[:, None, :] - sph            # [N, 6, 3]
            d2 = dot3(diff.unbind(-1), diff.unbind(-1))    # [N, 6]
            inside = (d2 < r2) & inside_any[:, None]
            inside_any = inside.any(1)
            if work is not None:
                work["inversions"] += int(inside_any.sum())
            if not bool(inside_any.any()):
                break
            s = sph[inside.to(torch.int8).argmax(1)]       # the first one
        dk = p - s
        d2k = dot3(dk.unbind(1), dk.unbind(1))
        # a true division: a Python number over a tensor is its reciprocal
        # times the number in torch, another rounding
        scale = d2k.new_tensor(r2) / torch.where(inside_any, d2k, 1.0)
        p = torch.where(inside_any[:, None], dk * scale[:, None] + s, p)
        dr = torch.where(inside_any, dr * scale, dr)
    x, y, z = p.unbind(1)
    return KLEIN_DE_SCALE * (torch.sqrt(x * x + y * y + z * z) - KLEIN_R) \
        / torch.abs(dr)


def klein_march(c, o, d, t_max, work):
    """(hit, length) of the sphere trace of the klein centred at c ([3])
    along rays o + t d ([N] each; d unit), accepting short of t_max ([N]);
    no gradient.  Runs only the lanes still marching; `work` counts their
    steps, inversions and accepts."""
    n = o[0].shape[0]
    oc = tuple(o[i] - c[i] for i in range(3))
    b = dot3(oc, d)
    disc = b * b - (dot3(oc, oc) - KLEIN_BALL_R * KLEIN_BALL_R)
    sq = torch.sqrt(vmax(disc, 0.0))
    enters = (disc > 0.0) & (-b + sq > T_MIN) & (-b - sq < t_max)
    live = enters.nonzero()[:, 0]
    length = torch.zeros_like(o[0])
    hit = torch.zeros(n, dtype=torch.bool, device=o[0].device)
    for _ in range(KLEIN_MAX_STEPS):
        if live.numel() == 0:
            break
        work["steps"] += live.numel()
        lo, ld, at = [x[live] for x in o], [x[live] for x in d], length[live]
        pos = torch.stack([lo[i] + ld[i] * at - c[i] for i in range(3)], 1)
        dist = klein_de(pos, work)
        new = at + dist
        accept = (dist < KLEIN_EPS) & (new > T_MIN) & (new < t_max[live])
        work["hits"] += int(accept.sum())
        length[live] = new
        hit[live] = accept
        q = tuple(lo[i] + ld[i] * new - c[i] for i in range(3))
        away = (dot3(q, ld) > 0.0) & (dot3(q, q)
                                      > KLEIN_BALL_R * KLEIN_BALL_R)
        live = live[~(accept | away)]
    return hit, length


def _klein_t_normal(c, o, d, t_raw, idx):
    """The hit distance and unit normal of lanes idx, accepted at t_raw:
    t = t_raw - (s - s.detach()), s = (DE - eps) / (grad DE . d) at the
    point o + t_raw d (one Newton step, its value dropped), and the normal
    grad DE / |grad DE|, the gradient by autograd of klein_de (with its
    own graph where the caller's gradients are on)."""
    outer = torch.is_grad_enabled()
    oi, di = [x[idx] for x in o], [x[idx] for x in d]
    tr = t_raw[idx]
    with torch.enable_grad():
        q = torch.stack([oi[i] + di[i] * tr - c[i] for i in range(3)], 1)
        if not q.requires_grad:
            q = q.detach().requires_grad_()
        de = klein_de(q)
        (g,) = torch.autograd.grad(de.sum(), q, create_graph=outer)
    gd = dot3(g.unbind(1), di)
    gd = torch.where(torch.abs(gd) > 1e-6, gd,
                     torch.where(gd >= 0.0, 1e-6, -1e-6).to(gd.dtype))
    s = (de - KLEIN_EPS) / gd
    t = tr - (s - s.detach())
    wn = unit3(g.unbind(1))
    if not outer:
        t, wn = t.detach(), tuple(x.detach() for x in wn)
    return t, wn


def _kleins(P, o, d, best):
    n = o[0].shape[0]
    for j in range(P.sc.n_kleins):
        c = P.k_c[j]
        with torch.no_grad():
            hit, t_raw = klein_march(c.detach(), [x.detach() for x in o],
                                     [x.detach() for x in d],
                                     best["t"].detach(), P.klein_work)
        idx = hit.nonzero()[:, 0]
        if idx.numel() == 0:
            continue
        ts, ns = _klein_t_normal(c, o, d, t_raw, idx)
        z = torch.zeros_like(o[0])
        t = torch.full_like(o[0], BIG).index_put((idx,), ts)
        wn = tuple(z.index_put((idx,), x) for x in ns)
        best = _merge(P, best, hit, t, wn, P.k_mat[j].expand(n))
    return best


def _merge(P, best, closer, t, wn, mat):
    out = dict(best)
    out["hit"] = best["hit"] | closer
    out["t"] = torch.where(closer, t, best["t"])
    out["wn"] = where3(closer, wn, best["wn"])
    out["mat"] = torch.where(closer, mat, best["mat"])
    return out


def _lights_sample(P, u_pick, u_a, u_b, p):
    lr = P.L["light_rect"]
    nl = lr.shape[0]
    scaled = u_pick * nl
    out = None
    for l in range(nl):
        x0, x1, z0, z1, ky = lr[l].unbind(0)
        px = x0 + u_a * (x1 - x0)
        pz = z0 + u_b * (z1 - z0)
        d = unit3((px - p[0], ky - p[1], pz - p[2]))
        if out is None:
            out = d
        else:
            sel = scaled >= l
            if l != nl - 1:
                sel = sel & (scaled < l + 1)
            out = where3(sel, d, out)
    return out


def _lights_value(P, p, d):
    lr = P.L["light_rect"]
    total = torch.zeros_like(p[0])
    for l in range(lr.shape[0]):
        x0, x1, z0, z1, ky = lr[l].unbind(0)
        dy_ok = torch.abs(d[1]) > 1e-9
        t_raw = (ky - p[1]) / torch.where(dy_ok, d[1], 1.0)
        hx = p[0] + t_raw * d[0]
        hz = p[2] + t_raw * d[2]
        inside = (dy_ok & (t_raw > 1e-3) & (t_raw < 1e8) & (hx >= x0)
                  & (hx <= x1) & (hz >= z0) & (hz <= z1))
        t = torch.where(inside, t_raw, 1.0)
        area = (x1 - x0) * (z1 - z0)
        denom = torch.where(inside, vmax(torch.abs(d[1]) * area, 1e-12), 1.0)
        total = total + torch.where(inside, t * t / denom, 0.0)
    return total * (1.0 / lr.shape[0])


def _onb(w, x, y, zc):
    pick = torch.abs(w[0]) > 0.9
    dt = w[0].dtype
    a = (torch.where(pick, 0.0, 1.0).to(dt), torch.where(pick, 1.0, 0.0).to(dt),
         torch.zeros_like(w[0]))
    v = unit3(cross3(w, a))
    u = cross3(v, w)
    return tuple(x * u[i] + y * v[i] + zc * w[i] for i in range(3))


def _cos_value(n, d):
    return vmax(dot3(n, d), 0.0) * (1.0 / math.pi)


def bounce(P, cfg, seed, gitem, depth, o, d, rad, tp):
    """One bounce of the live lanes: returns (rad, tp, o, d, scattering)."""
    z = torch.zeros_like(o[0])
    best = {"hit": torch.zeros_like(o[0], dtype=torch.bool),
            "t": torch.full_like(o[0], BIG), "wn": (z, z, z),
            "mat": torch.zeros_like(gitem, dtype=torch.int64)}
    if P.sc.n_rects:
        best = _rects(P, o, d, best)
    if P.sc.n_spheres:
        best = _spheres(P, o, d, best)
    if P.sc.n_kleins:
        best = _kleins(P, o, d, best)
    if P.sc.n_beziers:
        best = _beziers(P, cfg, o, d, best)
    hit, mat = best["hit"], best["mat"]
    one = torch.ones_like(z)
    t_eff = torch.where(hit, best["t"], 0.0)
    p = tuple(o[i] + t_eff * d[i] for i in range(3))
    wn = where3(hit, best["wn"], (z, one, z))
    sky_t = 0.5 * (d[1] + 1.0)
    sa, sb = P.L["sky_a"], P.L["sky_b"]
    sky = tuple((1.0 - sky_t) * sa[i] + sky_t * sb[i] for i in range(3))
    rad = tuple(rad[i] + torch.where(~hit, tp[i] * sky[i], 0.0)
                for i in range(3))

    alb0 = take(P.m_alb0, mat).unbind(1)
    alb1 = take(P.m_alb1, mat).unbind(1)
    sines = torch.sin(10.0 * p[0]) * torch.sin(10.0 * p[1]) * torch.sin(
        10.0 * p[2])
    alb = where3(P.m_chk[mat] & (sines < 0.0), alb1, alb0)
    mtype = P.m_type[mat]
    emit = hit & (mtype == MAT_DIFFUSE_LIGHT) & (dot3(wn, d) < 0.0)
    rad = tuple(rad[i] + torch.where(emit, tp[i] * alb[i], 0.0)
                for i in range(3))

    u = rng.uniforms(seed, gitem, depth, 8 if cfg["light_sampling"] else 2,
                     o[0].dtype)
    phi = TWO_PI * u[0]
    sr2 = torch.sqrt(u[1])
    d_cos = unit3(_onb(wn, torch.cos(phi) * sr2, torch.sin(phi) * sr2,
                       torch.sqrt(vmax(1.0 - u[1], 0.0))))
    if cfg["light_sampling"] and P.sc.n_lights:
        d_light = _lights_sample(P, u[3], u[4], u[5], p)
        lam_dir = where3(u[2] < 0.5, d_light, d_cos)
        s_pdf = _cos_value(wn, lam_dir)
        pdf = 0.5 * s_pdf + 0.5 * _lights_value(P, p, lam_dir)
        ratio = s_pdf / vmax(pdf, 1e-12)
        mult = tuple(a * ratio for a in alb)
        lam_ok = pdf > 0.0
    else:
        lam_dir, mult, lam_ok = d_cos, alb, torch.ones_like(hit)
    scattering = (hit & (mtype == MAT_LAMBERTIAN) & lam_ok
                  & (depth < cfg["max_depth"]))
    tp = where3(scattering, tuple(tp[i] * mult[i] for i in range(3)), tp)
    o = where3(scattering, p, o)
    d = where3(scattering, lam_dir, d)
    return rad, tp, o, d, scattering


def trace(P, cfg, seed, basis, nx, ny, gitem, px, py):
    """Trace one path a lane to its end: (radiance (r, g, b), segments a
    lane).  gitem holds the work items (int64, their low 32 bits count),
    px / py the pixel's column and row in the working precision."""
    dt = px.dtype
    uc = rng.uniforms(seed, gitem, rng.CAMERA_DEPTH, 5, dt)
    o, d = camera_rays(basis, nx, ny, uc, px, py)
    lane = torch.arange(px.shape[0], device=px.device)
    rad = (torch.zeros_like(px),) * 3
    tp = (torch.ones_like(px),) * 3
    lanes, rads, segs = [], [], []
    depth = 0
    while lane.numel():
        rad, tp, o, d, sc = bounce(P, cfg, seed, gitem, depth, o, d, rad, tp)
        done = (~sc).nonzero()[:, 0]
        lanes.append(lane[done])
        rads.append(torch.stack([r[done] for r in rad], 1))
        segs.append(torch.full_like(done, depth + 1))
        keep = sc.nonzero()[:, 0]
        lane, gitem = lane[keep], gitem[keep]
        o, d, rad, tp = ([x[keep] for x in v] for v in (o, d, rad, tp))
        depth += 1
    lanes = torch.cat(lanes)
    out = torch.zeros(px.shape[0], 3, dtype=dt, device=px.device)
    out = out.index_put((lanes,), torch.cat(rads))
    seg = torch.zeros_like(lanes).index_put((lanes,), torch.cat(segs))
    return out, seg
