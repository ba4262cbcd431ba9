"""PyTorch port: the plain step's gradients at exact ties equal JAX's.

JAX's `maximum` (and `clip`) split the cotangent 0.5 / 0.5 at a tie, as
`torch.maximum` does; `torch.clamp` would pass all of it.  The plain step
clamps with the maximum form (bounce._max, bounce._clip), and these tests
hold it against the JAX package in f64 at constructed ties:

  * `unit3` at a.a == eps (a = (0.5, 0, 0), eps = 0.25);
  * `_cosine_value` at n.d == 0;
  * `_lights_value`'s xz-rect denominator at |d.y| * area == 1e-12;
  * `_lights_sample`'s sphere distance at oc.oc == 1e-12 (1e-6 squared is
    exactly 1e-12 in f64);
  * the whole step on a lane whose light sample is a tie of `unit3`: a ray
    straight down onto the floor at p = (50, 0, 50), with the light shrunk
    to the point (50, 1e-6, 50), so target - p = (0, 1e-6, 0) and its
    squared length is exactly the 1e-12 guard.  The card's backward kernel
    is held against the plain VJP on the same lane (tests/test_torch_cuda.py).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scheme_raytrace_tpu import scenes as j_scenes
from scheme_raytrace_tpu.config import RenderConfig as JConfig
from scheme_raytrace_tpu.integrator import bounce as jb
from scheme_raytrace_tpu.scene import build as j_build
from scheme_raytrace_torch.integrator import bounce as tb
from tests.test_torch_cuda import tie_lane


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _grads(j_fn, t_fn, args, ct):
    """VJPs of j_fn and t_fn (same signature, a tuple of outputs) at the
    numpy args with the numpy cotangents ct, as two lists of numpy."""
    _, vjp = jax.vjp(jax.jit(j_fn), *[jnp.asarray(a) for a in args])
    want = [np.asarray(g) for g in vjp(tuple(jnp.asarray(c) for c in ct))]
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    out = t_fn(*leaves)
    got = torch.autograd.grad(out, leaves, [torch.tensor(c) for c in ct],
                              allow_unused=True)
    got = [np.zeros_like(a) if g is None else g.numpy()
           for a, g in zip(args, got)]
    return got, want


def _assert_grads_equal(got, want):
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=1e-14, atol=1e-15,
                                   err_msg=f"input {k}")


def test_unit3_tie(x64):
    a = (np.array([0.5]), np.array([0.0]), np.array([0.0]))
    assert float(a[0][0] ** 2) == 0.25            # a.a == eps exactly
    got, want = _grads(lambda *v: jb.unit3(v, eps=0.25),
                       lambda *v: tb.unit3(v, eps=0.25), a,
                       [np.array([0.7]), np.array([-0.2]), np.array([0.3])])
    _assert_grads_equal(got, want)
    assert want[0][0] != 0.0


def test_cosine_value_tie(x64):
    args = [np.array([0.0]), np.array([1.0]), np.array([0.0]),
            np.array([1.0]), np.array([0.0]), np.array([0.0])]
    got, want = _grads(lambda *v: (jb._cosine_value(v[:3], v[3:]),),
                       lambda *v: (tb._cosine_value(v[:3], v[3:]),), args,
                       [np.array([1.0])])
    _assert_grads_equal(got, want)
    assert want[0][0] != 0.0                      # d.x / 2pi


def _one_light(kind, x0, x1, z0, z1, ky, c, radius):
    """A one-light packed vector at lgt_base 0 and its plan."""
    pk = np.zeros(tb.LGT_SIZE)
    pk[tb.L_KIND], pk[tb.L_X0], pk[tb.L_X1] = kind, x0, x1
    pk[tb.L_Z0], pk[tb.L_Z1], pk[tb.L_KY] = z0, z1, ky
    pk[tb.L_C:tb.L_C + 3], pk[tb.L_RAD] = c, radius
    return pk, types.SimpleNamespace(n_lights=1, lgt_base=0)


def test_lights_value_rect_denominator_tie(x64):
    # area = 1 * 1e-12 and |d.y| = 1: the 1e-12 guard is met exactly
    pk, plan = _one_light(0.0, 0.0, 1.0, 0.0, 1e-12, 10.0, (9.0, 9.0, 9.0),
                          1.0)
    args = [pk, np.array([0.5]), np.array([0.0]), np.array([0.5e-12]),
            np.array([0.0]), np.array([1.0]), np.array([0.0])]

    def fn(lib, unbind):
        return lambda pk, *v: (lib._lights_value(plan, unbind(pk), v[:3],
                                                 v[3:]),)

    got, want = _grads(fn(jb, lambda x: x), fn(tb, lambda x: x.unbind(0)),
                       args, [np.array([1.0])])
    _assert_grads_equal(got, want)
    assert want[0][tb.L_Z1] != 0.0


def test_lights_sample_sphere_distance_tie(x64):
    # oc = c - p = (1e-6, 0, 0): oc.oc == 1e-12 exactly
    pk, plan = _one_light(1.0, 0.0, 1.0, 0.0, 1.0, 10.0, (1e-6, 0.0, 0.0),
                          1e-7)
    assert (1e-6) ** 2 == 1e-12
    u = [np.array([v]) for v in (0.3, 0.4, 0.6, 0.25, 0.5)]
    args = [pk, np.array([0.0]), np.array([0.0]), np.array([0.0])]

    def fn(lib, unbind, conv):
        return lambda pk, *p: lib._lights_sample(
            plan, unbind(pk), *[conv(x) for x in u], p)

    got, want = _grads(fn(jb, lambda x: x, jnp.asarray),
                       fn(tb, lambda x: x.unbind(0), torch.tensor),
                       args, [np.array([0.3]), np.array([-0.5]),
                              np.array([0.8])])
    _assert_grads_equal(got, want)
    assert np.abs(want[0][tb.L_C:tb.L_C + 3]).max() > 0.0


def test_step_vjp_at_a_light_sample_tie(x64):
    spec = j_scenes.cornell_box()
    j_scene = j_build.compile_scene(spec.objects, sky=spec.sky,
                                    dtype=jnp.float64)
    cfg = JConfig(nx=16, ny=16, spp=1, max_depth=8, light_sampling=True,
                  dtype="f64")
    plan = jb.make_plan(j_scene, cfg)
    pk = np.asarray(jb.pack(j_scene, spec.camera(dtype=jnp.float64,
                                                 aspect=1.0), plan,
                            jnp.float64))
    pk, ints, lanes = tie_lane(plan, pk, np.float64)
    cts = [np.array([v]) for v in (0.3, -0.2, 0.5, 0.7, 1.1, -0.4, 0.2, 0.6,
                                   0.5, 0.4, -0.3, 0.2, 0.9)]
    split = tb.split_lanes

    def j_step(pk, *lanes):
        out = jb.step(plan, pk, *[jnp.asarray(x) for x in ints],
                      *split(lanes))
        return tuple(tb.flat_lanes(*out[:5]))

    t_plan = tb.BouncePlan(**{k: getattr(plan, k)
                              for k in tb.BouncePlan.__dataclass_fields__})

    def t_step(pk, *lanes):
        out = tb.step(t_plan, pk, *[torch.as_tensor(x) for x in ints],
                      *split(lanes))
        return tuple(tb.flat_lanes(*out[:5]))

    with torch.no_grad():
        out = tb.step(t_plan, torch.tensor(pk),
                      *[torch.as_tensor(x) for x in ints],
                      *split([torch.tensor(x) for x in lanes]))
    assert bool(out[5][0])                          # the lane scatters ...
    assert float(out[1][1][0]) > 0.99               # ... straight up
    got, want = _grads(j_step, t_step, [pk, *lanes], cts)
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=1e-12,
                                   atol=1e-12 * max(1.0, np.abs(w).max()),
                                   err_msg=f"input {k}")
    assert want[0][plan.lgt_base + tb.L_KY] != 0.0
