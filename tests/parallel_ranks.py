"""What each rank of tests/test_torch_parallel.py's gloo groups runs.

`parallel.distributed.spawn` pickles `run_entry_points` by its import path,
so every child imports this module: it imports torch and the port only,
never JAX or a test module, and each rank reports whether JAX was loaded.
Each rank takes its share of its worker's cores (tests/torch_threads.py).
"""

import sys

import torch
import torch_threads

from scheme_raytrace_torch.camera import camera_from_arrays
from scheme_raytrace_torch.config import RenderConfig
from scheme_raytrace_torch.parallel import (calibrate_iters_sharded,
                                            render_pool_balanced,
                                            render_pool_sharded,
                                            render_sharded, train_step,
                                            train_step_fused)
from scheme_raytrace_torch.scene import build


def _inputs(case):
    dtype = torch.float64 if case["cfg"].get("dtype") == "f64" \
        else torch.float32
    scene = build.scene_from_arrays(case["scene"], case["meta"],
                                    device="cpu", dtype=dtype)
    cam = camera_from_arrays(case["cam"], device="cpu", dtype=dtype)
    return scene, cam, RenderConfig(**case["cfg"]), dtype


def _run(mesh, case):
    scene, cam, cfg, dtype = _inputs(case)
    kind = case["kind"]
    if kind == "pool_sharded":
        return render_pool_sharded(scene, cam, cfg, mesh)
    if kind == "pool_balanced":
        return render_pool_balanced(scene, cam, cfg, mesh)
    if kind == "render_sharded":
        return render_sharded(scene, cam, cfg, mesh)
    # the JAX leaves carried across, the id tables from the scene
    params = build.params_from_arrays(case["params"], device="cpu",
                                      dtype=dtype)
    _, rest = build.partition(scene)
    if kind == "train_step":
        target = torch.as_tensor(case["target"], dtype=dtype)
        return train_step(params, rest, cam, cfg, target, mesh,
                          lr=case["lr"])
    if kind == "train_loop":
        truth = build.scene_from_arrays(case["target_scene"], case["meta"],
                                        device="cpu", dtype=dtype)
        target = render_sharded(truth, cam, cfg, mesh)
        losses = []
        for _ in range(case["steps"]):
            params, loss = train_step(params, rest, cam, cfg, target, mesh,
                                      lr=case["lr"])
            losses.append(float(loss))
        return losses
    if kind == "train_step_fused":
        target = torch.as_tensor(case["target"], dtype=dtype)
        n_iters = calibrate_iters_sharded(scene, cam, cfg, mesh)
        new, loss, leftover = train_step_fused(params, rest, cam, cfg,
                                               target, mesh, n_iters,
                                               lr=case["lr"])
        return new, loss, leftover, n_iters
    raise ValueError(kind)


def run_entry_points(mesh, cases):
    """Every case of `cases` (name -> inputs as numpy arrays and a config)
    through its entry point of scheme_raytrace_torch.parallel on this
    rank; returns {name: result} with the rank and whether JAX is loaded."""
    torch_threads.cap(mesh.size)
    out = {name: _run(mesh, case) for name, case in cases.items()}
    out["rank"], out["size"] = mesh.rank, mesh.size
    out["jax_loaded"] = "jax" in sys.modules or any(
        m.startswith("scheme_raytrace_tpu") for m in sys.modules)
    return out
