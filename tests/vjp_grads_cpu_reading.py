"""The CPU half of the float32 gradient reading of
scheme_raytrace_torch/tools/check_vjp_grads.py, held against the JAX
package (a script, not a test: it takes minutes of JAX compile).

tools/check_vjp_grads_tpu.py's workload (Cornell with light sampling,
64^2 spp2 depth 24, m = 4,096, the loss sum(raw^2)/numel) through three
plain steps on the CPU, each on the same trip count (JAX's float32
`calibrate_iters`) and each drained:

  * JAX's `render_diff_fused` with the jnp step (use_pallas=False), f32;
  * the same in f64 (jax_enable_x64), the anchor;
  * the port's `render_diff_fused` with its plain f32 step, on the JAX f32
    scene's and camera's arrays.

For every leaf it prints the largest difference over the leaf's largest
|gradient| (the JAX tool's ratio): port f32 against JAX f32, then JAX f32
and port f32 each against JAX f64.  Where the two f32 steps miss the JAX
tool's 5e-3 against each other by as much as each misses f64, the miss is
float32's rounding of a cancelling sum, not either step's adjoint.

    JAX_PLATFORMS=cpu python tests/vjp_grads_cpu_reading.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from scheme_raytrace_tpu import scenes  # noqa: E402
from scheme_raytrace_tpu.config import RenderConfig as JConfig  # noqa: E402
from scheme_raytrace_tpu.integrator import diff_fused as j_diff  # noqa: E402
from scheme_raytrace_tpu.scene import build as j_build  # noqa: E402
from scheme_raytrace_tpu.scene import compile_scene  # noqa: E402
from scheme_raytrace_torch.camera import (CAMERA_FIELDS,  # noqa: E402
                                          camera_from_arrays)
from scheme_raytrace_torch.config import RenderConfig  # noqa: E402
from scheme_raytrace_torch.scene import build as t_build  # noqa: E402
from scheme_raytrace_torch.tools.common import fwd_bwd  # noqa: E402

WORKLOAD = dict(nx=64, ny=64, spp=2, max_depth=24, light_sampling=True,
                seed=0, pool_rays=4096)


def jax_scene(dtype):
    spec = scenes.cornell_box()
    return (compile_scene(spec.objects, sky=spec.sky, dtype=dtype),
            spec.camera(aspect=1.0, dtype=dtype))


def jax_grads(scene, cam, config, n_iters):
    params, rest = j_build.partition(scene)

    def loss_fn(p):
        raw, _, leftover = j_diff.render_diff_fused(
            j_build.combine(p, rest), cam, config, n_iters)
        return jnp.sum(raw ** 2) / raw.size, leftover

    (loss, leftover), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    assert int(leftover) == 0
    return float(loss), {k: np.asarray(v, np.float64) for k, v in g.items()}


def port_grads(j_scene, j_cam, config, n_iters):
    scene = t_build.scene_from_arrays(
        {f: np.asarray(getattr(j_scene, f)) for f in j_build._DATA_FIELDS},
        {f: getattr(j_scene, f) for f in j_build._META_FIELDS},
        dtype=torch.float32, device="cpu")
    cam = camera_from_arrays({k: np.asarray(getattr(j_cam, k))
                              for k in CAMERA_FIELDS},
                             dtype=torch.float32, device="cpu")
    params, rest = t_build.partition(scene)
    loss, (_, leftover), g = fwd_bwd(params, rest, cam, config, n_iters)
    assert int(leftover) == 0
    return float(loss), {k: v.double().numpy() for k, v in g.items()}


def rel(g, ref):
    scale = max(np.abs(ref).max(initial=0.0), 1e-8)
    return float(np.abs(g - ref).max(initial=0.0) / scale)


def main():
    j32 = JConfig(**WORKLOAD, use_pallas=False)
    scene32, cam32 = jax_scene(jnp.float32)
    n_iters = j_diff.calibrate_iters(scene32, cam32, j32)
    print(f"n_iters={n_iters}", flush=True)
    l_j32, g_j32 = jax_grads(scene32, cam32, j32, n_iters)
    l_t32, g_t32 = port_grads(scene32, cam32, RenderConfig(**WORKLOAD),
                              n_iters)
    jax.config.update("jax_enable_x64", True)
    scene64, cam64 = jax_scene(jnp.float64)
    l_j64, g_j64 = jax_grads(scene64, cam64,
                             JConfig(**WORKLOAD, dtype="f64",
                                     use_pallas=False), n_iters)
    jax.config.update("jax_enable_x64", False)
    print(f"loss JAX f32 {l_j32} port f32 {l_t32} JAX f64 {l_j64}")
    print(f"{'leaf':16s} {'max|g_f64|':>10s}  port32/jax32  jax32/f64  "
          "port32/f64")
    for k in g_j64:
        print(f"{k:16s} {np.abs(g_j64[k]).max(initial=0.0):10.3e}  "
              f"{rel(g_t32[k], g_j32[k]):12.2e}  "
              f"{rel(g_j32[k], g_j64[k]):9.2e}  "
              f"{rel(g_t32[k], g_j64[k]):10.2e}", flush=True)


if __name__ == "__main__":
    main()
