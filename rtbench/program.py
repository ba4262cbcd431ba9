"""The program under test, driven from a configuration file.

The only module of the benchmark that imports `scheme_raytrace_torch`: it
turns a configuration's scene description into the port's scene objects
and hands them to the port's own compiler, and wraps the three entries the
cells drive: `render.render_with_stats` (a progressive frame),
and `parallel.train_step_fused` (a training step on a mesh of one rank).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from scheme_raytrace_torch import render as R
from scheme_raytrace_torch.camera import make_camera
from scheme_raytrace_torch.config import RenderConfig
from scheme_raytrace_torch.integrator import pool_fused
from scheme_raytrace_torch.parallel import distributed as pdist
from scheme_raytrace_torch.parallel.render import (calibrate_iters_sharded,
                                                    train_step_fused)
from scheme_raytrace_torch.scene import build as sb
from scheme_raytrace_torch.scene import compile_scene
from scheme_raytrace_torch.scene import objects as ob

_RECTS = {"xy": ob.xy_rect, "xz": ob.xz_rect, "yz": ob.yz_rect}


def _texture(t):
    if isinstance(t, dict):
        return ob.CheckerTexture(ob.ConstantTexture(tuple(t["even"])),
                                 ob.ConstantTexture(tuple(t["odd"])))
    return tuple(t)


def _materials(cfg):
    out = {}
    for name, m in cfg["materials"].items():
        if "lambertian" in m:
            out[name] = ob.Lambertian(_texture(m["lambertian"]))
        else:
            out[name] = ob.DiffuseLight(_texture(m["diffuse_light"]))
    return out


def _rect(o, m):
    r = o["rect"]
    return _RECTS[r["plane"]](*r["a"], *r["b"], r["k"], m)


_OBJECTS = {
    "rect": _rect,
    "box": lambda o, m: ob.Box(tuple(o["box"]["min"]),
                               tuple(o["box"]["max"]), m),
    "sphere": lambda o, m: ob.Sphere(tuple(o["sphere"]["center"]),
                                     o["sphere"]["radius"], m),
    "bezier": lambda o, m: ob.Bezier(
        np.asarray(o["bezier"]["points"], np.float64), o["bezier"]["width"],
        m),
    "klein": lambda o, m: ob.Klein(tuple(o["klein"]["center"]), m),
}
_WRAPPERS = {"material", "rotate_y", "translate", "flip_normals"}


def scene_objects(cfg):
    """The configuration's objects as the port's hittables (one material
    object a name, so the port's compiler shares it).  Each object names
    one kind of _OBJECTS; any other raises."""
    mats = _materials(cfg)
    objs = []
    for o in cfg["objects"]:
        kinds = set(o) - _WRAPPERS
        if len(kinds) != 1 or not kinds <= set(_OBJECTS):
            raise ValueError(f"an object is one of {sorted(_OBJECTS)}: "
                             f"{o!r}")
        h = _OBJECTS[kinds.pop()](o, mats[o["material"]])
        if "rotate_y" in o:
            h = ob.RotateY(h, o["rotate_y"])
        if "translate" in o:
            h = ob.Translate(h, tuple(o["translate"]))
        if o.get("flip_normals"):
            h = ob.FlipNormals(h)
        objs.append(h)
    return objs


def build(cfg, nx, ny, spp, seed, device):
    """(scene, camera, RenderConfig) of a configuration on `device`, the
    scene and the camera in the configuration's float type."""
    rc = cfg["render"]
    dtype = torch.float64 if rc["dtype"] == "f64" else torch.float32
    scene = compile_scene(scene_objects(cfg), sky=cfg["sky"], dtype=dtype,
                          device=device)
    cam = make_camera(**cfg["camera"], aspect=nx / ny, dtype=dtype,
                      device=device)
    config = RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=rc["max_depth"],
                          seed=seed, light_sampling=rc["light_sampling"],
                          dtype=rc["dtype"], bezier_seeds=rc["bezier_seeds"],
                          bezier_newton=rc["bezier_newton"])
    return scene, cam, config


def zero_state(config, device):
    return R.init_state(config, device=device)


def frame(scene, cam, config, state):
    """One progressive frame: (new state, segments tensor)."""
    st, seg, _ = R.render_with_stats(scene, cam, config, state)
    return st, seg


@contextlib.contextmanager
def one_rank(device):
    """A mesh of one rank in this process (NCCL on the card, gloo on the
    CPU), as one card runs the data-parallel step."""
    with pdist.single_process(None if device.type == "cuda" else "cpu") as m:
        yield m


def params_of(scene):
    params, rest = sb.partition(scene)
    return params, rest


class SegmentCounter:
    """The forward path segments of the last training step run inside it.

    `train_step_fused` returns (params, loss, leftover) and drops the pool's
    segment count; this keeps the count the pool returns to it (`last`, a
    0-d device tensor, read with no host sync) by wrapping
    `pool_fused.render_pool_fused` while it is entered."""

    def __init__(self):
        self.last = None

    def __enter__(self):
        self._orig = pool_fused.render_pool_fused

        def counted(*a, **kw):
            out = self._orig(*a, **kw)
            self.last = out[1]
            return out
        pool_fused.render_pool_fused = counted
        return self

    def __exit__(self, *exc):
        pool_fused.render_pool_fused = self._orig
        return False


def calibrate(scene, cam, config, mesh):
    return calibrate_iters_sharded(scene, cam, config, mesh)


def train_step(params, rest, cam, config, target, mesh, n_iters, lr):
    """(new params, loss, leftover) of one step."""
    return train_step_fused(params, rest, cam, config, target, mesh, n_iters,
                            lr=lr)

