"""PyTorch port, the general path's modules against the JAX package (CPU).

Each function of the port's `core/vecmath`, `ops/` (`sampling`, `onb`,
`aabb`, `texture`, `sphere`, `rect`, `medium`, `bezier`, `klein`) and
`integrator/pdfs` gets the same numpy-seeded inputs as its JAX counterpart,
on scenes compiled by the JAX package and carried over as arrays
(`scene_from_arrays`).

Tolerances.  f64: every output within 1e-12 of the JAX one, relative to
max(1, |value|), and the same hit decisions, materials and branches.  f32:
the hit decisions and integer outputs equal on all but at most 1% of the
lanes (a lane near an edge or a threshold may go the other way), and the
float outputs of the agreeing lanes within 1e-4 relative to max(1, |value|).
Two forms differ from JAX's by design and are held at these tolerances:
`schlick`'s fifth power is three products and `in_unit_sphere_u`'s cube
root is exp(log(r)/3) (torch has no cbrt, and PyTorch's vectorised and
scalar CPU `pow` differ in the last bit, which would make a lane's value
depend on its position in the batch).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scheme_raytrace_tpu import scenes as j_scenes
from scheme_raytrace_tpu.core import vecmath as j_vm
from scheme_raytrace_tpu.integrator import pdfs as j_pdfs
from scheme_raytrace_tpu.ops import aabb as j_aabb
from scheme_raytrace_tpu.ops import bezier as j_bezier
from scheme_raytrace_tpu.ops import klein as j_klein
from scheme_raytrace_tpu.ops import medium as j_medium
from scheme_raytrace_tpu.ops import onb as j_onb
from scheme_raytrace_tpu.ops import rect as j_rect
from scheme_raytrace_tpu.ops import sampling as j_sampling
from scheme_raytrace_tpu.ops import sphere as j_sphere
from scheme_raytrace_tpu.ops import texture as j_texture
from scheme_raytrace_tpu.scene import build as j_build
from scheme_raytrace_tpu.scene import objects as j_ob
from scheme_raytrace_torch.core import vecmath as t_vm
from scheme_raytrace_torch.integrator import pdfs as t_pdfs
from scheme_raytrace_torch.ops import aabb as t_aabb
from scheme_raytrace_torch.ops import bezier as t_bezier
from scheme_raytrace_torch.ops import klein as t_klein
from scheme_raytrace_torch.ops import medium as t_medium
from scheme_raytrace_torch.ops import onb as t_onb
from scheme_raytrace_torch.ops import rect as t_rect
from scheme_raytrace_torch.ops import sampling as t_sampling
from scheme_raytrace_torch.ops import sphere as t_sphere
from scheme_raytrace_torch.ops import texture as t_texture
from scheme_raytrace_torch.scene import build as t_build

N = 512                      # lanes
T_MIN, T_MAX = 0.001, 999999999999.0
PRECS = ("f64", "f32")
MAX_FLIP_FRAC = 0.01


@contextlib.contextmanager
def x64(prec):
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", prec == "f64")
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _dtypes(prec):
    return ((jnp.float64, torch.float64) if prec == "f64"
            else (jnp.float32, torch.float32))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _check(want, got, prec, flips=None, tols=(1e-12, 1e-4)):
    """Outputs (tuples or single arrays) of JAX and the port: bools and ints
    equal, floats within the module docstring's tolerance, on the lanes
    that `flips` (the lanes whose decisions differ, f32 only) leaves."""
    want = want if isinstance(want, (tuple, list)) else (want,)
    got = got if isinstance(got, (tuple, list)) else (got,)
    assert len(want) == len(got)
    if flips is None:
        flips = np.zeros(np.shape(_np(want[0]))[:1], bool)
    if prec == "f64":
        assert not flips.any()
    assert flips.mean() <= MAX_FLIP_FRAC, flips.mean()
    keep = ~flips
    tol = tols[prec != "f64"]
    for w, g in zip(want, got):
        w, g = _np(w), _np(g)
        assert w.shape == g.shape, (w.shape, g.shape)
        w, g = w[keep], g[keep]
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            bound = tol * np.maximum(1.0, np.abs(w))
            same = (g == w) | (np.isnan(g) & np.isnan(w))
            with np.errstate(invalid="ignore"):         # inf - inf
                bad = ~same & ~(np.abs(g - w) <= bound)
            assert not bad.any(), (np.abs(g - w)[bad].max(), bad.sum())


def _flips(want, got, prec):
    """Lanes whose hit flag or material differs (f32 only)."""
    if prec == "f64":
        return None
    return ((_np(want[0]) != _np(got[0])) | (_np(want[3]) != _np(got[3])))


def _rays(seed, box, aim, n=N):
    """Origins uniform in `box`, unit directions at points of `aim`, times
    in [0, 1)."""
    r = np.random.default_rng(seed)
    lo, hi = (np.asarray(b, float) for b in box)
    o = lo + (hi - lo) * r.random((n, 3))
    alo, ahi = (np.asarray(b, float) for b in aim)
    d = alo + (ahi - alo) * r.random((n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d, r.random(n)


def _pair(prec, *arrays):
    """numpy arrays -> (JAX arrays, torch tensors) in the precision."""
    jd, td = _dtypes(prec)
    return ([jnp.asarray(a, jd) for a in arrays],
            [torch.tensor(a, dtype=td) for a in arrays])


def _scene(spec_or_objs, prec, sky=None, bvh=None):
    """A JAX scene and the port's twin from its arrays (call under x64)."""
    if isinstance(spec_or_objs, j_scenes.SceneSpec):
        objs, sky = spec_or_objs.objects, sky or spec_or_objs.sky
    else:
        objs = spec_or_objs
    jd, td = _dtypes(prec)
    js = j_build.compile_scene(objs, sky=sky or "gradient", dtype=jd, bvh=bvh)
    arrays = {f: np.asarray(getattr(js, f)) for f in j_build._DATA_FIELDS}
    meta = {f: getattr(js, f) for f in j_build._META_FIELDS}
    return js, t_build.scene_from_arrays(arrays, meta, dtype=td, device="cpu")


def _moving_objs():
    return [j_ob.Sphere((0, -100.5, -1), 100,
                        j_ob.Lambertian((0.6, 0.6, 0.2))),
            j_ob.MovingSphere((0, 0, -1), (0, 0.4, -1), 0.0, 1.0, 0.5,
                              j_ob.Lambertian((0.2, 0.3, 0.7)))]


def _many_rects_objs():
    """Cornell and six more rotated boxes: 54 rects, above rect.LOOP_MAX."""
    objs = list(j_scenes.cornell_box().objects)
    white = j_ob.Lambertian((0.73, 0.73, 0.73))
    for k in range(6):
        objs.append(j_ob.Translate(j_ob.RotateY(
            j_ob.Box((0, 0, 0), (60, 60 + 20 * k, 60), white), 10.0 * k),
            (60 + 70 * k, 0, 400 - 40 * k)))
    return objs


def _two_lights_objs():
    """Cornell with a sphere light beside its xz-rect light."""
    return list(j_scenes.cornell_box().objects) + [
        j_ob.Sphere((400, 300, 300), 40, j_ob.DiffuseLight((5.0, 5.0, 5.0)))]


CORNELL_BOX = ((1, 1, -800), (554, 554, 554))
CORNELL_AIM = ((0, 0, 0), (555, 555, 555))

# name -> (scene builder, ray box, aim box)
SPHERE_CASES = {
    "test": (lambda: j_scenes.test_scene(), ((-3, 0.1, -3), (3, 2, 2)),
             ((-2, -0.6, -2), (2, 0.6, 0))),
    "moving": (_moving_objs, ((-2, 0, 1), (2, 1, 3)),
               ((-1, -0.6, -2), (1, 1, 0))),
    "random": (lambda: j_scenes.random_scene(seed=0),
               ((-12, 0.5, -12), (12, 4, 12)), ((-8, 0, -8), (8, 1.5, 8))),
}
RECT_CASES = {
    "cornell": (lambda: j_scenes.cornell_box(), CORNELL_BOX, CORNELL_AIM),
    "many_rects": (_many_rects_objs, CORNELL_BOX, CORNELL_AIM),
}


# ---------------------------------------------------------------------------
# 1. core/vecmath
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec", PRECS)
def test_vecmath(prec):
    r = np.random.default_rng(0)
    a, b = r.normal(size=(N, 3)), r.normal(size=(N, 3))
    n = b / np.linalg.norm(b, axis=1, keepdims=True)
    eta = r.uniform(0.5, 2.0, N)
    cos = r.uniform(-0.2, 1.2, N)
    mask = r.random(N) < 0.5
    with x64(prec):
        (ja, jn, jeta, jcos), (ta, tn, teta, tcos) = _pair(prec, a, n, eta,
                                                           cos)
        want = (j_vm.dot(ja, jn), j_vm.reflect(ja, jn),
                *j_vm.refract(ja, jn, jeta), j_vm.schlick(jcos, jeta),
                j_vm.where3(jnp.asarray(mask), ja, jn), j_vm.unit(ja),
                j_vm.cross(ja, jn))
    got = (t_vm.dot(ta, tn), t_vm.reflect(ta, tn), *t_vm.refract(ta, tn, teta),
           t_vm.schlick(tcos, teta), t_vm.where3(torch.tensor(mask), ta, tn),
           t_vm.unit(ta), t_vm.cross(ta, tn))
    assert _np(want[2]).any() and not _np(want[2]).all()   # both branches
    _check(want, got, prec)


# ---------------------------------------------------------------------------
# 2-3. ops/sampling, ops/onb
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec", PRECS)
def test_sampling_u(prec):
    r = np.random.default_rng(1)
    u1, u2, u3 = r.random(N), r.random(N), r.random(N)
    u1[:4] = 0.0                                   # the draws' lower edge
    radius = r.uniform(0.1, 3.0, N)
    dist_sq = r.uniform(0.01, 20.0, N)             # some points inside
    with x64(prec):
        (j1, j2, j3, jr, jd), (t1, t2, t3, tr, td) = _pair(
            prec, u1, u2, u3, radius, dist_sq)
        want = (j_sampling.in_unit_sphere_u(j1, j2, j3),
                j_sampling.in_unit_disk_u(j1, j2),
                j_sampling.cosine_direction_u(j1, j2),
                j_sampling.hemisphere_direction_u(j1, j2),
                j_sampling.to_sphere_u(j1, j2, jr, jd))
    got = (t_sampling.in_unit_sphere_u(t1, t2, t3),
           t_sampling.in_unit_disk_u(t1, t2),
           t_sampling.cosine_direction_u(t1, t2),
           t_sampling.hemisphere_direction_u(t1, t2),
           t_sampling.to_sphere_u(t1, t2, tr, td))
    _check(want, got, prec)


@pytest.mark.parametrize("prec", PRECS)
def test_onb(prec):
    r = np.random.default_rng(2)
    w = r.normal(size=(N, 3))
    w[:8] = [1, 0, 0]                              # the |w.x| > 0.9 pivot
    local = r.normal(size=(N, 3))
    with x64(prec):
        (jw, jl), (tw, tl) = _pair(prec, w, local)
        ju, jv, jw2 = j_onb.from_w(jw)
        want = (ju, jv, jw2, j_onb.local(ju, jv, jw2, jl))
    tu, tv, tw2 = t_onb.from_w(tw)
    _check(want, (tu, tv, tw2, t_onb.local(tu, tv, tw2, tl)), prec)


# ---------------------------------------------------------------------------
# 4. ops/aabb (device slab tests and the host box algebra)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec", PRECS)
def test_aabb(prec):
    o, d, _ = _rays(3, ((-4, -4, -4), (4, 4, 4)), ((-1, -1, -1), (1, 1, 1)))
    r = np.random.default_rng(3)
    c = r.uniform(-2, 2, (N, 3))
    pmin, pmax = c - r.uniform(0.1, 1, (N, 3)), c + r.uniform(0.1, 1, (N, 3))
    with x64(prec):
        (jo, jd, jlo, jhi), (to, td, tlo, thi) = _pair(prec, o, d, pmin, pmax)
        want = (j_aabb.slab_hit(jo, jd, jlo, jhi, 0.5, 6.0),
                *j_aabb.slab_interval(jo, jd, jlo, jhi))
    got = (t_aabb.slab_hit(to, td, tlo, thi, 0.5, 6.0),
           *t_aabb.slab_interval(to, td, tlo, thi))
    assert _np(want[0]).any() and not _np(want[0]).all()
    _check(want, got, prec)
    # host-side algebra: the same numpy
    for fn in ("surrounding_box", "union_all", "surface_area"):
        args = {"surrounding_box": (pmin, pmax, pmin[::-1], pmax[::-1]),
                "union_all": (pmin, pmax), "surface_area": (pmin, pmax)}[fn]
        for w, g in zip(np.atleast_1d(getattr(j_aabb, fn)(*args)),
                        np.atleast_1d(getattr(t_aabb, fn)(*args))):
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# 5. ops/texture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec", PRECS)
def test_texture_value(prec):
    """Every texture kind of `textured_scene` (checker, marble, image,
    noise) at random points, uvs and ids."""
    r = np.random.default_rng(4)
    with x64(prec):
        js, ts = _scene(j_scenes.textured_scene(), prec)
        n_tex = int(js.tex_type.shape[0])
        tex = r.integers(0, n_tex, N).astype(np.int32)
        (ju, jv, jp), (tu, tv, tp) = _pair(prec, r.random(N), r.random(N),
                                           r.uniform(-3, 3, (N, 3)))
        want = j_texture.value(js, jnp.asarray(tex), ju, jv, jp)
    got = t_texture.value(ts, torch.tensor(tex), tu, tv, tp)
    assert {0, 1, 2, 3, 4} <= set(np.asarray(js.tex_type)[tex].tolist())
    _check(want, got, prec)


# ---------------------------------------------------------------------------
# 6-9. ops/sphere, ops/rect, ops/medium, ops/bezier
# ---------------------------------------------------------------------------

def _group(j_fn, t_fn, spec_fn, box, aim, prec, seed, sky=None, bvh=None,
           extra=(), tols=(1e-12, 1e-4)):
    o, d, tm = _rays(seed, box, aim)
    with x64(prec):
        js, ts = _scene(spec_fn(), prec, sky=sky, bvh=bvh)
        (jo, jd, jt, *je), (to, td, tt, *te) = _pair(prec, o, d, tm, *extra)
        want = j_fn(jo, jd, jt, js, T_MIN, T_MAX, *je)
    got = t_fn(to, td, tt, ts, T_MIN, T_MAX, *te)
    assert _np(want[0]).any(), "no lane hits"
    _check(want, got, prec, _flips(want, got, prec), tols)
    return js, ts, want, got


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("name", sorted(SPHERE_CASES))
def test_sphere_intersect(name, prec):
    """The unrolled loop (test_scene's 5 spheres, the moving scene) and the
    [N, S] sweep (random_scene's 227 spheres, most of them moving)."""
    spec_fn, box, aim = SPHERE_CASES[name]
    js, ts, *_ = _group(j_sphere.intersect, t_sphere.intersect, spec_fn, box,
                        aim, prec, seed=5)
    assert (int(js.sph_r.shape[0]) > j_sphere.LOOP_MAX) == (name == "random")
    assert t_sphere.LOOP_MAX == j_sphere.LOOP_MAX


@pytest.mark.parametrize("prec", PRECS)
def test_sphere_uv_and_center(prec):
    r = np.random.default_rng(6)
    n = r.normal(size=(N, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[:4] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [0, 0, -1]]   # poles, seam
    with x64(prec):
        js, ts = _scene(j_scenes.random_scene(seed=0), prec)
        j = r.integers(0, int(js.sph_r.shape[0]), N)
        (jn, jt), (tn, tt) = _pair(prec, n, r.random(N))
        want = (*j_sphere.sphere_uv(jn),
                j_sphere._center_at(js, jnp.asarray(j), jt),
                j_sphere._center_at_slots(js, jnp.asarray(j).reshape(-1, 4),
                                          jt[:N // 4]))
    tj = torch.tensor(j)
    got = (*t_sphere.sphere_uv(tn), t_sphere._center_at(ts, tj, tt),
           t_sphere._center_at_slots(ts, tj.reshape(-1, 4), tt[:N // 4]))
    _check(want[:3], got[:3], prec)
    _check(want[3], got[3], prec)


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("name", sorted(RECT_CASES))
def test_rect_intersect(name, prec):
    """The unrolled loop (Cornell's 18 rects, two of its boxes rotated) and
    the [N, R] sweep (54 rects)."""
    spec_fn, box, aim = RECT_CASES[name]
    js, *_ = _group(j_rect.intersect, t_rect.intersect, spec_fn, box, aim,
                    prec, seed=7)
    assert (int(js.rect_k.shape[0]) > j_rect.LOOP_MAX) == (name != "cornell")
    assert t_rect.LOOP_MAX == j_rect.LOOP_MAX


@pytest.mark.parametrize("prec", PRECS)
def test_medium_intersect(prec):
    """cornell_smoke's two box media, with the per-ray t_max of a solid hit
    (half the lanes) and the exponential draws; plus one sphere medium."""
    r = np.random.default_rng(8)
    objs = list(j_scenes.cornell_smoke().objects) + [j_ob.ConstantMedium(
        j_ob.Sphere((400, 150, 150), 80, None), 0.02, (0.5, 0.5, 0.5))]
    t_clip = np.where(r.random(N) < 0.5, r.uniform(100, 1500, N), T_MAX)
    xi = r.random((N, 3))
    xi[:4] = 0.0                                    # the log(0) guard
    o, d, tm = _rays(9, CORNELL_BOX, CORNELL_AIM)
    with x64(prec):
        js, ts = _scene(objs, prec, sky="black")
        (jo, jd, jt, jc, jx), (to, td, tt, tc, tx) = _pair(
            prec, o, d, tm, t_clip, xi)
        want = j_medium.intersect(jo, jd, jt, js, T_MIN, jc, jx)
    got = t_medium.intersect(to, td, tt, ts, T_MIN, tc, tx)
    assert _np(want[0]).sum() > 10
    _check(want, got, prec, _flips(want, got, prec))


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("name", ["bezier", "cornell_bezier"])
def test_bezier_intersect(name, prec):
    spec = j_scenes.SCENES[name]()
    if name == "bezier":
        box, aim = ((-2, -1, 2), (2, 2, 4)), ((-1.5, -1, -1), (1.5, 1, 1))
    else:
        box, aim = CORNELL_BOX, ((100, 0, 100), (455, 120, 455))

    def j_fn(o, d, t, s, t_min, t_max):
        return j_bezier.intersect(o, d, t, s, t_min, t_max, n_seeds=16,
                                  n_newton=6)

    def t_fn(o, d, t, s, t_min, t_max):
        return t_bezier.intersect(o, d, t, s, t_min, t_max, n_seeds=16,
                                  n_newton=6)
    _group(j_fn, t_fn, lambda: spec, box, aim, prec, seed=10)


def test_bezier_curve_helpers():
    r = np.random.default_rng(11)
    cp, s = r.normal(size=(N, 4, 3)), r.random(N)
    for fn in ("eval_bezier", "tangent"):
        with x64("f64"):
            want = getattr(j_bezier, fn)(jnp.asarray(cp), jnp.asarray(s))
        got = getattr(t_bezier, fn)(torch.tensor(cp), torch.tensor(s))
        _check(want, got, "f64")


# ---------------------------------------------------------------------------
# 10. ops/klein
# ---------------------------------------------------------------------------

KLEIN_BOX = ((-700, -700, 600), (700, 700, 900))
KLEIN_AIM = ((-300, -300, -300), (300, 300, 300))


@pytest.mark.parametrize("prec", PRECS)
def test_klein_dist_normal_march(prec):
    """dist_func and get_normal at points around the fractal, and one
    instance's 100-step march (hits and t)."""
    r = np.random.default_rng(12)
    p = r.uniform(-600, 600, (N, 3))
    center = np.array([10.0, -5.0, 3.0])
    o, d, _ = _rays(13, KLEIN_BOX, KLEIN_AIM, n=128)
    with x64(prec):
        (jp, jc, jo, jd), (tp, tc, to, td) = _pair(prec, p, center, o, d)
        want = (j_klein.dist_func(jc, jp), j_klein.get_normal(jc, jp))
        march = j_klein._march_one(jo, jd, jc, T_MIN, T_MAX)
    got = (t_klein.dist_func(tc, tp), t_klein.get_normal(tc, tp))
    got_march = t_klein._march_one(to, td, tc, T_MIN, T_MAX)
    _check(want, got, prec)
    assert _np(march[0]).sum() > 10
    _check(march, got_march, prec, None if prec == "f64" else
           _np(march[0]) != _np(got_march[0]))


@pytest.mark.parametrize("prec", PRECS)
def test_klein_intersect(prec):
    """cornell_klein: the march, the closest instance, and the
    implicit-function t correction (zero in the primal) with its normal.
    The normal is held within 1e-11 in f64 and 1e-3 in f32: it is the DE's
    gradient at the hit, through up to ten inversions whose scale factors
    multiply the round-off, and JAX's jvp and torch.func.jvp sum the
    tangents in another order (measured: 1.6e-12 on 6 of 512 lanes in f64,
    2.7e-4 on 2 in f32; t within 2.3e-13 in f64)."""
    spec = j_scenes.cornell_klein()
    _group(j_klein.intersect, t_klein.intersect, lambda: spec, CORNELL_BOX,
           ((150, 50, 150), (400, 300, 400)), prec, seed=14,
           tols=(1e-11, 1e-3))


# ---------------------------------------------------------------------------
# 11. integrator/pdfs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec", PRECS)
def test_pdfs(prec):
    """The cosine PDF, the xz-rect and sphere light PDFs (Cornell's light
    and a sphere light beside it), the light sampler and the mixture."""
    r = np.random.default_rng(15)
    p = r.uniform(1, 554, (N, 3))
    p[:4] = [400, 310, 300]                         # inside the sphere light
    n = r.normal(size=(N, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    u = r.random((N, 12))
    with x64(prec):
        js, ts = _scene(_two_lights_objs(), prec)
        assert js.n_lights == 2
        (jp, jn, ju), (tp, tn, tu) = _pair(prec, p, n, u)
        jdir, jpdf = j_pdfs.mixture_sample_and_value_u(ju, js, jn, jp)
        want = (j_pdfs.cosine_value(jn, jdir),
                j_pdfs.cosine_sample_u(ju[:, 0], ju[:, 1], jn),
                j_pdfs.lights_sample_u(ju[:, 3], ju[:, 4], ju[:, 5],
                                       ju[:, 6], ju[:, 7], js, jp),
                j_pdfs.lights_value(js, jp, jdir), jdir, jpdf)
    tdir, tpdf = t_pdfs.mixture_sample_and_value_u(tu, ts, tn, tp)
    got = (t_pdfs.cosine_value(tn, tdir),
           t_pdfs.cosine_sample_u(tu[:, 0], tu[:, 1], tn),
           t_pdfs.lights_sample_u(tu[:, 3], tu[:, 4], tu[:, 5], tu[:, 6],
                                  tu[:, 7], ts, tp),
           t_pdfs.lights_value(ts, tp, tdir), tdir, tpdf)
    assert (_np(want[3]) > 0).sum() > 10          # directions at the lights
    _check(want, got, prec)
