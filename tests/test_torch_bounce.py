"""PyTorch port, fused bounce: layout, pack, the plain step and the kernel.

The plain PyTorch `step` follows the JAX `bounce.step` op for op, so the
same inputs (numpy draws, one packed scene) give the same outputs: equal to
round-off in f64, and within the f32 bounds of tests/test_bounce.py
(rtol 1e-4 / atol 1e-3 at Cornell's 0..555 scale) in f32.  The CUDA kernel
is held against the plain step on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scheme_raytrace_tpu import scenes as j_scenes
from scheme_raytrace_tpu.config import RenderConfig as JConfig
from scheme_raytrace_tpu.integrator import bounce as jb
from scheme_raytrace_tpu.scene import build as j_build
from scheme_raytrace_torch import scenes as t_scenes
from scheme_raytrace_torch.config import RenderConfig as TConfig
from scheme_raytrace_torch.core import rng as t_rng
from scheme_raytrace_torch.integrator import bounce as tb
from scheme_raytrace_torch.integrator import pool as t_pool
from scheme_raytrace_torch.scene import build as t_build
from scheme_raytrace_torch.scene import objects as t_ob
from scheme_raytrace_torch.utils import telemetry


def launches(kernel):
    """The process's launches of one kernel so far (utils/telemetry)."""
    return telemetry.counter(f"launches.{kernel}")


CSRC = pathlib.Path(tb.__file__).resolve().parent.parent / "csrc"
LAYOUT = re.compile(r"^(H|R|S|L|M|K|B)_[A-Z0-9]+$|_SIZE$")


def test_layout_constants_match_jax():
    names = [n for n in dir(jb) if LAYOUT.search(n)
             and isinstance(getattr(jb, n), int)]
    assert len(names) > 40
    for n in names:
        assert getattr(tb, n) == getattr(jb, n), n
    for n in ("UNROLL_MAX", "MAX_FUSED_PRIMS", "IMG_ROWS_MAX"):
        assert getattr(tb, n) == getattr(jb, n), n


def test_cuda_source_constants_match():
    # the kernels' shared layout and RNG constants (bounce_common.cuh) and
    # any a kernel source declares itself
    text = "".join(p.read_text() for p in sorted(CSRC.glob("*.cu*")))
    consts = dict(re.findall(r"constexpr (?:int|uint32_t) (\w+) = (\w+)u?;",
                             text))
    consts = {k: int(v.rstrip("u"), 0) for k, v in consts.items()}
    expect = {n: getattr(tb, n) for n in consts if hasattr(tb, n)}
    expect.update({n: getattr(t_ob, n) for n in consts if n.startswith("MAT_")})
    expect.update({n: getattr(t_build, n) for n in consts
                   if n.startswith("TEX_")})
    assert {"TEX_CHECKER", "TEX_NOISE", "TEX_MARBLE", "TEX_IMAGE"} <= set(expect)
    expect.update(CAMERA_DEPTH=t_rng.CAMERA_DEPTH,
                  GROUP_MEDIUM=t_rng.GROUP_MEDIUM,
                  PCG_MULT=t_rng._PCG_MULT, PCG_ADD=t_rng._PCG_ADD)
    # k-prefixed names are a kernel's own (block size, list widths)
    expect.update({n: v for n, v in consts.items() if n.startswith("k")})
    assert "kThreads" in consts and tb.SPH_SIZE == consts["SPH_SIZE"]
    assert set(consts) == set(expect), set(consts) ^ set(expect)
    for n, v in consts.items():
        assert v == expect[n], n


def _both_scenes(spec_fn, dtype_name="f32"):
    j_dt = jnp.float64 if dtype_name == "f64" else jnp.float32
    t_dt = torch.float64 if dtype_name == "f64" else torch.float32
    spec = spec_fn()
    j_scene = j_build.compile_scene(spec.objects, sky=spec.sky, dtype=j_dt)
    j_cam = spec.camera(dtype=j_dt, aspect=1.0)
    t_spec = t_scenes.SCENES[[k for k, v in j_scenes.SCENES.items()
                              if v is spec_fn][0]]()
    t_scene = t_build.compile_scene(t_spec.objects, sky=t_spec.sky,
                                    dtype=t_dt, device="cpu")
    t_cam = t_spec.camera(dtype=t_dt, aspect=1.0, device="cpu")
    return j_scene, j_cam, t_scene, t_cam


@pytest.mark.parametrize("name", sorted(j_scenes.SCENES))
def test_pack_equals_jax(name):
    j_scene, j_cam, t_scene, t_cam = _both_scenes(j_scenes.SCENES[name])
    kw = dict(nx=16, ny=16, spp=1, max_depth=8, light_sampling=True)
    j_plan = jb.make_plan(j_scene, JConfig(**kw))
    t_plan = tb.make_plan(t_scene, TConfig(**kw))
    assert t_plan == tb.BouncePlan(**{
        k: getattr(j_plan, k) for k in tb.BouncePlan.__dataclass_fields__})
    assert (tb.supported(t_scene, TConfig(**kw))
            == jb.supported(j_scene, JConfig(**kw)))
    assert tb.pallas_ok(t_plan) == jb.pallas_ok(j_plan)
    j_pk = jb.pack(j_scene, j_cam, j_plan, jnp.float32)
    t_pk = tb.pack(t_scene, t_cam, t_plan, torch.float32)
    if j_plan.has_atlas:
        (j_pk, j_atlas), (t_pk, t_atlas) = j_pk, t_pk
        np.testing.assert_array_equal(t_atlas.numpy(), np.asarray(j_atlas))
    j_pk, t_pk = np.asarray(j_pk), t_pk.numpy()
    assert t_pk.shape == j_pk.shape == (t_plan.size,)
    # the camera basis (header 6..23) goes through tan/rsqrt in each
    # framework: equal to f32 rounding; every scene field is exact
    np.testing.assert_allclose(t_pk[:tb.HDR_SIZE], j_pk[:tb.HDR_SIZE],
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(t_pk[tb.HDR_SIZE:], j_pk[tb.HDR_SIZE:])


def _lane_inputs(m, nx, ny, max_depth, seed=0):
    """Numpy draws of the kinds tests/test_bounce.py uses, plus wrapped
    negative gitems, nonzero radiance/throughput and lanes at the cap."""
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
    time = np.zeros(m)
    rad = r.random((3, m))
    tp = r.uniform(0.1, 1.0, (3, m))
    return gitem, px, py, fresh, alive, depth, o, dvec, time, rad, tp


def _run_jax(plan, pk, ins, dt, interpret=None):
    gitem, px, py, fresh, alive, depth, o, d, time, rad, tp = ins
    f = lambda x: jnp.asarray(x, dt)
    args = (jnp.asarray(gitem), f(px), f(py), jnp.asarray(fresh),
            jnp.asarray(alive), jnp.asarray(depth), tuple(f(x) for x in o),
            tuple(f(x) for x in d), f(time), tuple(f(x) for x in rad),
            tuple(f(x) for x in tp))
    fn = (jb.step if interpret is None
          else jb.as_pallas(plan, px.shape[0], interpret=True))
    out = fn(plan, jnp.asarray(pk, dt), *args)
    return _flat(out, np.asarray)


def _torch_args(ins, dt, device="cpu"):
    gitem, px, py, fresh, alive, depth, o, d, time, rad, tp = ins
    f = lambda x: torch.as_tensor(np.asarray(x), dtype=dt, device=device)
    return (torch.as_tensor(gitem, device=device), f(px), f(py),
            torch.as_tensor(fresh, device=device),
            torch.as_tensor(alive, device=device),
            torch.as_tensor(depth, device=device), tuple(f(x) for x in o),
            tuple(f(x) for x in d), f(time), tuple(f(x) for x in rad),
            tuple(f(x) for x in tp))


def _flat(out, conv):
    o, d, time, rad, tp, sc = out
    return [conv(x) for x in (*o, *d, time, *rad, *tp)], conv(sc)


OUT_NAMES = ["ox", "oy", "oz", "dx", "dy", "dz", "time", "rx", "ry", "rz",
             "tx", "ty", "tz"]


def _assert_outputs_close(got, want, rtol, atol):
    (g_cols, g_sc), (w_cols, w_sc) = got, want
    np.testing.assert_array_equal(g_sc, w_sc)
    for name, g, w in zip(OUT_NAMES, g_cols, w_cols):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=name)


def _cornell_plan_pk(dtype_name, light_sampling, m_nx=16):
    j_scene, j_cam, _, _ = _both_scenes(j_scenes.cornell_box, dtype_name)
    cfg = JConfig(nx=m_nx, ny=m_nx, spp=1, max_depth=8,
                  light_sampling=light_sampling, dtype=dtype_name)
    plan = jb.make_plan(j_scene, cfg)
    dt = jnp.float64 if dtype_name == "f64" else jnp.float32
    pk = np.asarray(jb.pack(j_scene, j_cam, plan, dt))
    t_plan = tb.BouncePlan(**{k: getattr(plan, k)
                              for k in tb.BouncePlan.__dataclass_fields__})
    return plan, t_plan, pk


@pytest.mark.parametrize("light_sampling", [True, False], ids=["light", "cosine"])
@pytest.mark.parametrize("dtype_name", ["f32", "f64"])
def test_step_matches_jax(dtype_name, light_sampling):
    if dtype_name == "f64":
        jax.config.update("jax_enable_x64", True)
    try:
        plan, t_plan, pk = _cornell_plan_pk(dtype_name, light_sampling)
        ins = _lane_inputs(256, plan.nx, plan.ny, plan.max_depth)
        j_dt = jnp.float64 if dtype_name == "f64" else jnp.float32
        want = _run_jax(plan, pk, ins, j_dt)
    finally:
        jax.config.update("jax_enable_x64", False)
    t_dt = torch.float64 if dtype_name == "f64" else torch.float32
    got = _flat(tb.step(t_plan, torch.tensor(pk, dtype=t_dt),
                        *_torch_args(ins, t_dt)), lambda x: x.numpy())
    assert got[1].any() and not got[1].all()
    if dtype_name == "f64":
        _assert_outputs_close(got, want, rtol=1e-9, atol=1e-9)
    else:
        _assert_outputs_close(got, want, rtol=1e-4, atol=1e-3)


def test_step_matches_pallas_interpret():
    plan, t_plan, pk = _cornell_plan_pk("f32", True)
    ins = _lane_inputs(256, plan.nx, plan.ny, plan.max_depth, seed=1)
    want = _run_jax(plan, pk, ins, jnp.float32, interpret=True)
    got = _flat(tb.step(t_plan, torch.tensor(pk), *_torch_args(
        ins, torch.float32)), lambda x: x.numpy())
    _assert_outputs_close(got, want, rtol=1e-4, atol=1e-3)


def _plan_pk_ins(name, sky=None):
    spec = t_scenes.SCENES[name]()
    scene = t_build.compile_scene(spec.objects, sky=sky or spec.sky,
                                  device="cpu")
    cfg = TConfig(nx=8, ny=8, spp=1, max_depth=4)
    plan = tb.pool_plan(scene, cfg)
    pk = tb.pack(scene, spec.camera(aspect=1.0, device="cpu"), plan,
                 torch.float32)
    ins = _torch_args(_lane_inputs(128, 8, 8, 4), torch.float32)
    return scene, spec, cfg, plan, pk, ins


def test_step_raises_outside_the_cornell_slice():
    # a sphere plan runs; the kernel wrapper refuses CPU tensors; what
    # `supported` rejects goes to the general pool (no fused step)
    scene, spec, cfg, plan, pk, ins = _plan_pk_ins("test", sky="gradient")
    assert plan.n_spheres == 5 and not plan.has_atlas
    out = tb.step(plan, pk, *ins)
    assert out[5].any() and all(torch.isfinite(x).all() for x in out[0])
    with pytest.raises(ValueError, match="CUDA"):
        tb.step_cuda(plan, pk, *ins)
    bvh_cfg = cfg.replace(traversal="bvh")
    assert not tb.supported(scene, bvh_cfg)
    raw, segs, iters = t_pool.render_pool_auto(
        scene, spec.camera(device="cpu"), bvh_cfg, torch.zeros(64, 3), 0)
    assert torch.isfinite(raw).all() and int(segs) >= 64 and iters > 0


def test_kernel_wrappers_take_no_atlas():
    spec = t_scenes.random_scene(seed=0)
    scene = t_build.compile_scene(spec.objects, sky=spec.sky, device="cpu")
    plan = tb.make_plan(scene, TConfig(nx=8, ny=8, spp=1, max_depth=4))
    pk, atlas = tb.pack(scene, spec.camera(aspect=1.0, device="cpu"), plan,
                        torch.float32)
    ins = _torch_args(_lane_inputs(128, 8, 8, 4), torch.float32)
    out = tb.step(plan, (pk, atlas), *ins)        # the plain step ignores it
    assert torch.isfinite(torch.stack(out[0])).all()
    with pytest.raises(ValueError, match="pool_plan"):
        tb.step_cuda(plan, pk, *ins)


@pytest.mark.parametrize("name", ["cornell_smoke", "simple_light", "textured"])
def test_step_covers_media_perlin_and_image_plans(name):
    # the groups ported after the spheres run through the plain step, and
    # the kernel wrapper gets as far as its device check
    scene, spec, cfg, plan, pk, ins = _plan_pk_ins(name)
    assert (plan.n_media, plan.has_perlin, plan.has_image) == {
        "cornell_smoke": (2, False, False), "simple_light": (0, True, False),
        "textured": (0, True, True)}[name]
    assert isinstance(pk, tuple) == plan.has_image
    out = tb.step(plan, pk, *ins)
    assert out[5].any() and all(torch.isfinite(x).all() for x in out[3])
    with pytest.raises(ValueError, match="CUDA"):
        tb.step_cuda(plan, pk, *ins)
    raw, segs, _ = t_pool.render_pool_auto(
        scene, spec.camera(aspect=1.0, device="cpu"), cfg,
        torch.zeros(64, 3), 0)
    assert int(segs) >= 64 and torch.isfinite(raw).all()


def test_step_cuda_takes_cuda_tensors_only():
    plan, t_plan, pk = _cornell_plan_pk("f32", True)
    ins = _torch_args(_lane_inputs(128, 16, 16, 8), torch.float32)
    before = launches("K1")
    with pytest.raises(ValueError, match="CUDA"):
        tb.step_cuda(t_plan, torch.tensor(pk), *ins)
    assert launches("K1") == before
