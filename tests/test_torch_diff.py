"""PyTorch port, reverse mode: the plain step VJP and the differentiable pool
against the JAX package.

  * `bounce.step_vjp` (torch autograd of the plain step) against `jax.vjp`
    of the JAX `bounce.step` on the same numpy-seeded lanes and cotangents:
    f64 within 1e-10, f32 within tests/test_bounce_vjp.py's bounds;
  * `diff_fused.render_diff_fused` in f64 on Cornell 16^2 spp3 depth 12
    with a 256-lane pool (tests/test_diff_fused.py's CFG) against the JAX
    `render_diff_fused` and `jax.grad`: the same iteration count, segments
    and leftover, the same image, and gradients of every float scene leaf
    and the camera's lookfrom within 1e-12 of the leaf's largest;
  * the `BounceStep` autograd plumbing, driven on the CPU with the plain
    (step, step_vjp) pair.

The bounce_step_bwd kernel itself runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scheme_raytrace_tpu import scenes as j_scenes
from scheme_raytrace_tpu.config import RenderConfig as JConfig
from scheme_raytrace_tpu.integrator import bounce as jb
from scheme_raytrace_tpu.integrator import diff_fused as j_diff
from scheme_raytrace_tpu.scene import build as j_build
from scheme_raytrace_torch import render as t_render
from scheme_raytrace_torch import scenes as t_scenes
from scheme_raytrace_torch.camera import CAMERA_FIELDS, camera_from_arrays
from scheme_raytrace_torch.config import RenderConfig as TConfig
from scheme_raytrace_torch.integrator import bounce as tb
from scheme_raytrace_torch.integrator import diff_fused as t_diff
from scheme_raytrace_torch.scene import build as t_build

CFG = dict(nx=16, ny=16, spp=3, max_depth=12, light_sampling=True,
           pool_rays=256, dtype="f64")


def _lanes_and_cts(m, nx, ny, max_depth, seed):
    """Numpy draws of the step's inputs (tests/test_torch_bounce.py's kinds)
    and of normal cotangents for its 13 float outputs."""
    r = np.random.default_rng(seed)
    gitem = r.integers(-2 ** 31, 2 ** 31, m, dtype=np.int64).astype(np.int32)
    px = r.integers(0, nx, m).astype(np.float64)
    py = r.integers(0, ny, m).astype(np.float64)
    fresh = r.random(m) < 0.5
    alive = fresh | (r.random(m) < 0.7)
    depth = r.integers(0, 4, m).astype(np.int32)
    depth[r.random(m) < 0.05] = max_depth
    o = r.random((3, m)) * 500.0
    dvec = r.normal(size=(3, m))
    dvec /= np.linalg.norm(dvec, axis=0, keepdims=True)
    rad = r.random((3, m))
    tp = r.uniform(0.1, 1.0, (3, m))
    lanes = [*o, *dvec, np.zeros(m), *rad, *tp]
    cts = list(r.normal(size=(13, m)))
    return (gitem, px, py, fresh, alive, depth), lanes, cts


def _split(x):
    return (tuple(x[0:3]), tuple(x[3:6]), x[6], tuple(x[7:10]),
            tuple(x[10:13]))


@pytest.mark.parametrize("light_sampling", [True, False],
                         ids=["light", "cosine"])
@pytest.mark.parametrize("dtype_name", ["f32", "f64"])
def test_step_vjp_matches_jax_vjp(dtype_name, light_sampling):
    m = 256
    j_dt = jnp.float64 if dtype_name == "f64" else jnp.float32
    t_dt = torch.float64 if dtype_name == "f64" else torch.float32
    if dtype_name == "f64":
        jax.config.update("jax_enable_x64", True)
    try:
        spec = j_scenes.cornell_box()
        j_scene = j_build.compile_scene(spec.objects, sky=spec.sky,
                                        dtype=j_dt)
        cfg = JConfig(nx=16, ny=16, spp=1, max_depth=8,
                      light_sampling=light_sampling, dtype=dtype_name)
        plan = jb.make_plan(j_scene, cfg)
        pk = np.asarray(jb.pack(j_scene, spec.camera(dtype=j_dt, aspect=1.0),
                                plan, j_dt))
        ints, lanes, cts = _lanes_and_cts(m, 16, 16, plan.max_depth, seed=4)
        gitem, px, py, fresh, alive, depth = ints
        f = lambda x: jnp.asarray(x, j_dt)

        def fn(pk, o, d, time, rad, tp):
            out = jb.step(plan, pk, jnp.asarray(gitem), f(px), f(py),
                          jnp.asarray(fresh), jnp.asarray(alive),
                          jnp.asarray(depth), o, d, time, rad, tp)
            return out[:5], out[5]

        _, vjp, scattering = jax.vjp(fn, f(pk),
                                     *_split([f(x) for x in lanes]),
                                     has_aux=True)
        want = [np.asarray(g) for g in jax.tree.leaves(
            vjp(_split([f(x) for x in cts])))]
        scattering = np.asarray(scattering)
    finally:
        jax.config.update("jax_enable_x64", False)
    assert scattering.any() and not scattering.all()
    t_plan = tb.BouncePlan(**{k: getattr(plan, k)
                              for k in tb.BouncePlan.__dataclass_fields__})
    g = lambda x: torch.tensor(np.asarray(x), dtype=t_dt)
    got = tb.step_vjp(t_plan, g(pk), torch.as_tensor(gitem), g(px), g(py),
                      torch.as_tensor(fresh), torch.as_tensor(alive),
                      torch.as_tensor(depth), *_split([g(x) for x in lanes]),
                      *_split([g(x) for x in cts]))
    got = [x.numpy() for x in (got[0], *got[1], *got[2], got[3], *got[4],
                               *got[5])]
    assert len(got) == len(want) == 14
    assert np.abs(want[0]).max() > 0
    rtol, atol = (1e-10, 1e-10) if dtype_name == "f64" else (1e-3, 1e-5)
    for k, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(
            a, b, rtol=rtol, atol=atol * max(1.0, float(np.abs(b).max())),
            err_msg=f"cotangent {k}")


@pytest.fixture(scope="module")
def jax_reference():
    """The f64 JAX render_diff_fused on CFG, its jax.grad, and the scene
    and camera as numpy arrays (one compile shared by the module)."""
    jax.config.update("jax_enable_x64", True)
    try:
        spec = j_scenes.cornell_box()
        scene = j_build.compile_scene(spec.objects, sky=spec.sky,
                                      dtype=jnp.float64)
        cam = spec.camera(dtype=jnp.float64, aspect=1.0)
        cfg = JConfig(**CFG)
        n_iters = j_diff.calibrate_iters(scene, cam, cfg)
        params, rest = j_build.partition(scene)

        def loss(p, c):
            raw, segs, leftover = j_diff.render_diff_fused(
                j_build.combine(p, rest), c, cfg, n_iters)
            return jnp.mean(raw), (raw, segs, leftover)

        (_, (raw, segs, leftover)), (g_par, g_cam) = jax.jit(
            jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
                params, cam)
        ref = dict(
            n_iters=n_iters, raw=np.asarray(raw), segments=int(segs),
            leftover=int(leftover),
            grads={k: np.asarray(v) for k, v in g_par.items()},
            grad_lookfrom=np.asarray(g_cam.lookfrom),
            arrays={f: np.asarray(getattr(scene, f))
                    for f in j_build._DATA_FIELDS},
            meta={f: getattr(scene, f) for f in j_build._META_FIELDS},
            cam={k: np.asarray(getattr(cam, k)) for k in CAMERA_FIELDS})
    finally:
        jax.config.update("jax_enable_x64", False)
    return ref


def _cornell64():
    spec = t_scenes.cornell_box()
    scene = t_build.compile_scene(spec.objects, sky=spec.sky,
                                  dtype=torch.float64, device="cpu")
    return scene, spec.camera(dtype=torch.float64, aspect=1.0,
                              device="cpu")


def _port_scene(ref):
    scene = t_build.scene_from_arrays(ref["arrays"], ref["meta"],
                                      dtype=torch.float64, device="cpu")
    return scene, camera_from_arrays(ref["cam"], dtype=torch.float64,
                                     device="cpu")


def test_diff_render_matches_jax_and_forward(jax_reference):
    ref = jax_reference
    scene, cam = _port_scene(ref)
    cfg = TConfig(**CFG)
    n_iters = t_diff.calibrate_iters(scene, cam, cfg)
    assert n_iters == ref["n_iters"]
    assert t_diff.supported(scene, cfg)
    with torch.no_grad():
        raw, segs, leftover = t_diff.render_diff_fused(scene, cam, cfg,
                                                       n_iters)
    assert int(leftover) == ref["leftover"] == 0
    assert int(segs) == ref["segments"]
    np.testing.assert_allclose(raw.numpy(), ref["raw"], rtol=1e-12,
                               atol=1e-12)
    st, f_segs, _ = t_render.render_with_stats(scene, cam, cfg,
                                               t_render.init_state(cfg, device="cpu"))
    assert int(f_segs) == int(segs)
    assert torch.equal(raw, st.raw_sum.reshape(-1, 3))


def test_diff_render_grads_match_jax_grad(jax_reference):
    ref = jax_reference
    scene, cam = _port_scene(ref)
    params, rest = t_build.partition(scene)
    params = {k: v.clone().requires_grad_() for k, v in params.items()}
    cam = dataclasses.replace(cam,
                              lookfrom=cam.lookfrom.clone().requires_grad_())
    raw, _, leftover = t_diff.render_diff_fused(
        t_build.combine(params, rest), cam, TConfig(**CFG), ref["n_iters"])
    assert int(leftover) == 0
    leaves = [*params.values(), cam.lookfrom]
    grads = torch.autograd.grad(raw.mean(), leaves, allow_unused=True)
    assert set(params) == set(ref["grads"])
    want = {**ref["grads"], "lookfrom": ref["grad_lookfrom"]}
    names = [*params, "lookfrom"]
    for name, leaf, g in zip(names, leaves, grads):
        g = np.zeros(leaf.shape) if g is None else g.numpy()
        w = want[name]
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-12 * np.abs(w).max(initial=0.0),
                                   err_msg=name)
    for name in ("tex_color", "rect_k", "rect_trans", "light_rect", "sky_a",
                 "lookfrom"):
        assert np.abs(want[name]).max() > 0, name


def test_undersized_iters_report_leftover_and_strict_poisons():
    scene, cam = _cornell64()
    cfg = TConfig(**CFG)
    raw, _, leftover = t_diff.render_diff_fused(scene, cam, cfg, 2)
    assert int(leftover) > 0
    assert torch.isfinite(raw).all()
    bad, _, lo = t_diff.render_diff_fused_strict(scene, cam, cfg, 2)
    assert int(lo) == int(leftover)
    assert torch.isnan(bad).all()


def test_bounce_step_function_matches_plain_autograd():
    # The autograd Function driven with the plain (step, step_vjp) pair
    # over two chained steps equals autograd straight through the plain
    # step; px/py get no gradient and `scattering` is not differentiable.
    scene, cam = _cornell64()
    cfg = TConfig(nx=16, ny=16, spp=1, max_depth=8, light_sampling=True)
    plan = tb.make_plan(scene, cfg)
    ints, lanes, cts = _lanes_and_cts(256, 16, 16, 8, seed=5)
    gitem, px, py, fresh, alive, depth = (torch.as_tensor(x) for x in ints)
    px, py = px.requires_grad_(), py.requires_grad_()

    def run(stepfn):
        pk = tb.pack(scene, cam, plan, torch.float64).detach()
        pk.requires_grad_()
        x = [torch.as_tensor(v).requires_grad_() for v in lanes]
        state = _split(x)
        for k in range(2):
            out = stepfn(plan, pk, gitem, px, py, fresh if k == 0
                         else torch.zeros_like(fresh), alive, depth + k,
                         *state)
            state = out[:5]
        assert not out[5].requires_grad
        flat = [*state[0], *state[1], state[2], *state[3], *state[4]]
        loss = sum((a * torch.as_tensor(c)).sum() for a, c in zip(flat, cts))
        return torch.autograd.grad(loss, [pk, *x, px, py], allow_unused=True)

    want = run(tb.step)
    got = run(lambda *a: tb.step_with_vjp((tb.step, tb.step_vjp), *a))
    assert got[-2] is None and got[-1] is None
    assert np.abs(want[0].numpy()).max() > 0
    for a, b in zip(got[:-2], want[:-2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_step_cuda_bwd_takes_cuda_tensors_only():
    scene, cam = _cornell64()
    cfg = TConfig(nx=16, ny=16, spp=1, max_depth=8, light_sampling=True)
    plan = tb.make_plan(scene, cfg)
    ints, lanes, cts = _lanes_and_cts(128, 16, 16, 8, seed=6)
    before = tb.BWD_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        tb.step_cuda_bwd(plan, tb.pack(scene, cam, plan, torch.float64),
                         *(torch.as_tensor(x) for x in ints),
                         *_split([torch.as_tensor(x) for x in lanes]),
                         *_split([torch.as_tensor(x) for x in cts]))
    assert tb.BWD_LAUNCHES == before
