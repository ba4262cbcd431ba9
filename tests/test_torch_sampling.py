"""PyTorch port: the key-based samplers of `ops/sampling` and
`integrator/pdfs` against the JAX package's (CPU).

  * For the same key (`jax.random.key(seed)` and the port's
    `core/rng.root_key(seed)`, each folded with the same datum, paired as
    tests/test_torch_wavefront.py pairs them), `_draws` is bitwise JAX's
    `_draws` (one `jax.random.uniform(key, shape + (n,))`, split on the
    last axis) in f32 and f64, for flat and nested shapes.
  * Each of the eight samplers (`in_unit_sphere`, `in_unit_disk`,
    `cosine_direction`, `hemisphere_direction`, `to_sphere`,
    `cosine_sample`, `lights_sample`, `mixture_sample_and_value`) is
    bitwise the port's `_u` form on those draws: the wrapper draws on the
    key's device in the dtype it is given and adds no rounding of its own.
    Against JAX's sampler for the same key it holds the tolerance at which
    tests/test_torch_ops.py holds the `_u` forms (f64 1e-12, f32 1e-4,
    relative to max(1, |value|)): the draws are the same bits, but cos,
    sin, sqrt and the cube root round differently in XLA and in PyTorch,
    by an ulp on some lanes, so a sample is JAX's to the `_u` forms'
    agreement and not bit for bit.
  * `lights_sample` and `mixture_sample_and_value` run on Cornell's xz-rect
    light and on `simple_light`'s sphere light.
  * tests/test_sampling.py's support and first-moment checks, with its N
    and bounds, on the port's samplers under the port's key 0.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scheme_raytrace_tpu import scenes as j_scenes
from scheme_raytrace_tpu.integrator import pdfs as j_pdfs
from scheme_raytrace_tpu.ops import sampling as j_sampling
from scheme_raytrace_tpu.scene import build as j_build
from scheme_raytrace_torch.core import rng as t_rng
from scheme_raytrace_torch.core import vecmath as t_vm
from scheme_raytrace_torch.integrator import pdfs as t_pdfs
from scheme_raytrace_torch.ops import sampling as t_sampling
from scheme_raytrace_torch.scene import build as t_build

PRECS = ("f64", "f32")
TOL = {"f64": 1e-12, "f32": 1e-4}      # tests/test_torch_ops.py's
SEEDS = (0, 7)
SHAPES = ((512,), (8, 32))
N = 200_000                            # tests/test_sampling.py's


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


def _keys(seed):
    """One key of each package: key(seed) folded with 3."""
    return (jax.random.fold_in(jax.random.key(seed), 3),
            t_rng.fold_in(t_rng.root_key(seed, device="cpu"), 3))


def _bits(x):
    a = x.numpy() if torch.is_tensor(x) else np.asarray(x)
    return a.view(np.int64 if a.dtype == np.float64 else np.int32)


def _same_bits(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _bits(g), _bits(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _close(got, want, prec):
    """Port against JAX: same dtype and shape, within TOL[prec] relative to
    max(1, |value|)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.isfinite(g).all()
        bound = TOL[prec] * np.maximum(1.0, np.abs(w))
        assert (np.abs(g - w) <= bound).all(), np.abs(g - w).max()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("prec", PRECS)
def test_draws_bitwise_jax(prec, seed, shape):
    jd, td = _dtypes(prec)
    for n in (2, 3, 5):
        with x64(prec):
            jk, tk = _keys(seed)
            want = j_sampling._draws(jk, n, shape, jd)
        got = t_sampling._draws(tk, n, shape, td)
        assert len(got) == n and got[0].shape == shape
        _same_bits(got, want)


def _radius_dist(shape):
    r = np.random.default_rng(3)
    radius = r.uniform(0.1, 3.0, shape)
    return radius, r.uniform(0.01, 20.0, shape)    # some points inside


SAMPLERS = {             # name -> draws a sample
    "in_unit_sphere": 3, "in_unit_disk": 2, "cosine_direction": 2,
    "hemisphere_direction": 2, "to_sphere": 2}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
@pytest.mark.parametrize("prec", PRECS)
def test_sampler_matches_jax(prec, name):
    jd, td = _dtypes(prec)
    shape = (64, 8)
    radius, dist_sq = _radius_dist(shape)
    with x64(prec):
        jk, tk = _keys(1)
        extra = ((jnp.asarray(radius, jd), jnp.asarray(dist_sq, jd))
                 if name == "to_sphere" else ())
        want = getattr(j_sampling, name)(jk, *extra, shape, dtype=jd)
    extra = ((torch.tensor(radius, dtype=td), torch.tensor(dist_sq, dtype=td))
             if name == "to_sphere" else ())
    got = getattr(t_sampling, name)(tk, *extra, shape, dtype=td)
    assert got.shape == shape + (3,) and got.dtype == td
    u = t_sampling._draws(tk, SAMPLERS[name], shape, td)
    _same_bits(got, getattr(t_sampling, name + "_u")(*u, *extra))
    _close(got, want, prec)


def _light_scene(name, prec):
    """(JAX scene, the port's from its arrays, points, unit normals)."""
    spec = {"cornell": j_scenes.cornell_box,
            "simple_light": j_scenes.test_scene2}[name]()
    jd, td = _dtypes(prec)
    js = j_build.compile_scene(spec.objects, sky=spec.sky, dtype=jd)
    ts = t_build.scene_from_arrays(
        {f: np.asarray(getattr(js, f)) for f in j_build._DATA_FIELDS},
        {f: getattr(js, f) for f in j_build._META_FIELDS}, dtype=td,
        device="cpu")
    r = np.random.default_rng(4)
    box = (((1, 1, 1), (554, 540, 554)) if name == "cornell"
           else ((-6, 0.1, -6), (6, 4, 6)))
    p = r.uniform(*box, (1024, 3))
    n = r.normal(size=(1024, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    return js, ts, p, n


@pytest.mark.parametrize("scene", ["cornell", "simple_light"])
@pytest.mark.parametrize("prec", PRECS)
def test_pdf_samplers_match_jax(prec, scene):
    jd, td = _dtypes(prec)
    with x64(prec):
        js, ts, p, n = _light_scene(scene, prec)
        kind = set(np.asarray(js.light_kind)[:js.n_lights].tolist())
        assert kind == {j_build.LIGHT_XZ_RECT if scene == "cornell"
                        else j_build.LIGHT_SPHERE}
        jk, tk = _keys(2)
        jp, jn = jnp.asarray(p, jd), jnp.asarray(n, jd)
        want = {"cosine_sample": j_pdfs.cosine_sample(jk, jn),
                "lights_sample": j_pdfs.lights_sample(jk, js, jp),
                "mixture_sample_and_value":
                    j_pdfs.mixture_sample_and_value(jk, js, jn, jp)}
    tp, tn = torch.tensor(p, dtype=td), torch.tensor(n, dtype=td)
    got = {"cosine_sample": t_pdfs.cosine_sample(tk, tn),
           "lights_sample": t_pdfs.lights_sample(tk, ts, tp),
           "mixture_sample_and_value":
               t_pdfs.mixture_sample_and_value(tk, ts, tn, tp)}
    r2, r5, r8 = (t_rng.uniform(tk, (1024, k), td) for k in (2, 5, 8))
    _same_bits(got["cosine_sample"],
               t_pdfs.cosine_sample_u(r2[:, 0], r2[:, 1], tn))
    _same_bits(got["lights_sample"],
               t_pdfs.lights_sample_u(*r5.unbind(1), ts, tp))
    _same_bits(got["mixture_sample_and_value"],
               t_pdfs.mixture_sample_and_value_u(r8, ts, tn, tp))
    for k in want:
        _close(got[k], want[k], prec)
    d, pdf = got["mixture_sample_and_value"]
    assert (pdf > 0).all()
    np.testing.assert_allclose(t_vm.length(d).numpy(), 1.0, atol=1e-5)


# --- tests/test_sampling.py's checks on the port ----------------------------

@pytest.fixture
def key():
    return t_rng.root_key(0, device="cpu")


def _length(p):
    return t_vm.length(p)


def test_in_unit_sphere_support_and_moment(key):
    p = t_sampling.in_unit_sphere(key, (N,))
    r = _length(p)
    assert float(r.max()) <= 1.0 + 1e-6
    # E[|p|] = 3/4 for uniform-in-ball
    np.testing.assert_allclose(float(r.mean()), 0.75, atol=0.01)
    # isotropy
    np.testing.assert_allclose(p.mean(0).numpy(), 0.0, atol=0.01)


def test_in_unit_disk(key):
    p = t_sampling.in_unit_disk(key, (N,))
    np.testing.assert_allclose(p[:, 2].numpy(), 0.0)
    r = _length(p)
    assert float(r.max()) <= 1.0 + 1e-6
    # E[r] = 2/3 for uniform-in-disk
    np.testing.assert_allclose(float(r.mean()), 2.0 / 3.0, atol=0.01)


def test_cosine_direction_moments(key):
    d = t_sampling.cosine_direction(key, (N,))
    np.testing.assert_allclose(_length(d).numpy(), 1.0, atol=1e-5)
    assert float(d[:, 2].min()) >= 0.0
    # E[cos(theta)] = 2/3 under pdf = cos/pi
    np.testing.assert_allclose(float(d[:, 2].mean()), 2.0 / 3.0, atol=0.01)


def test_hemisphere_direction_uniform(key):
    d = t_sampling.hemisphere_direction(key, (N,))
    assert float(d[:, 2].min()) >= 0.0
    # E[z] = 1/2 for uniform hemisphere
    np.testing.assert_allclose(float(d[:, 2].mean()), 0.5, atol=0.01)


def test_to_sphere_cone_support(key):
    # util.scm:46-54: directions lie in the cone toward the sphere
    radius, dist = 1.0, 4.0
    d = t_sampling.to_sphere(key, radius, dist * dist, (N,))
    cos_theta_max = np.sqrt(1 - radius**2 / dist**2)
    assert float(d[:, 2].min()) >= cos_theta_max - 1e-5
    np.testing.assert_allclose(_length(d).numpy(), 1.0, atol=1e-5)
    # mean z = (1 + cos_theta_max)/2 (z uniform on [cos_theta_max, 1])
    np.testing.assert_allclose(float(d[:, 2].mean()),
                               (1 + cos_theta_max) / 2, atol=0.005)
