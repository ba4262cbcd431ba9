"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py [--phases NAME[,NAME...]]

Drives scheme_raytrace_torch's paths on the card: the forward render and
the fwd+bwd training step of the Cornell box with mixture-PDF light
sampling (BASELINE config 4), the forward render through the three strided
work pools, the op and loop probes, the sphere scenes up to the RTOW
final scene (227 spheres) forward and fwd+bwd, and the textured and smoke
scenes (hash-Perlin noise and marble, image texels, constant media) forward
and fwd+bwd, the bezier scenes and the klein scenes forward and fwd+bwd, in
phases; any
failure raises and the exit code is non-zero.  `--phases` takes a
comma-separated selection of the phase names in PHASES (the default is every
phase); the device and build phases always run, a phase that needs another's
result brings it along, and a run with a selection says so and prints no
kernel table:

  1. device: a CUDA card is required; prints nvidia-smi's name and power
     limit and the CUDA version PyTorch was built with;
  2. build: compiles, with nvcc (sm_90a), the variant of each kernel of
     csrc/ for each feature set the selected phases' plans need (one nvcc a
     variant, as many at once as the host has cores), loads them, and logs
     each variant's build seconds, registers and spills;
  3. forward kernel against plain: the CUDA bounce kernel against the plain
     PyTorch step on the same inputs, at the forward pool's width (65,536
     lanes), light sampling on and off, in float32 and float64, with times;
  4. backward kernel against plain: the CUDA backward kernel against the
     plain VJP (torch autograd of the plain step) at the reverse pool's
     width (24,576 lanes), on Cornell with light sampling on and off and on
     the kernels' coverage scene, in float32 and float64, with times;
  5. forward render against the reference: render_image at 64x64 spp8
     depth 100 against tests/goldens/config4_cornell_light.npz (the f64
     oracle), and one kernel launch per pool iteration;
  6. differentiable render against its references at the same size: a
     drained queue, the image equal to the forward render's bitwise,
     deterministic gradients, one backward launch per forward launch, and
     in float64 the AD gradient against central finite differences;
  7. full-size forward: 512x512 spp16 depth 100, one warm-up then three
     chained timed renders (rays/s counted as exact path segments), and one
     render under torch.profiler for the device-time breakdown;
  8. full-size fwd+bwd: 512x512 spp8 depth 100, one warm-up then three
     chained training steps (params -= 1e-6 grad), peak memory, and one
     step under torch.profiler;
  9. packed kernel against plain: the packed-state kernel (K3) against the
     plain step_packed on random packed Cornell states at 65,536 lanes;
 10. persistent kernel: one chunk of the persistent kernel (K4) bitwise
     equal to as many K3 launches, against the plain chunk, with times for
     several chunk lengths;
 11. the strided pools at full size: 512x512 spp16 depth 100 through
     render_pool_strided (K1), render_pool_packed (K3) and
     render_pool_persistent (K4), timed as phase 7 times the FIFO pool,
     each with phase 7's exact segment count and its image to rtol 1e-5,
     and one render of each under torch.profiler;
 12. probes: the op probe (K5) and the nine loop probes and the two
     extension loop forms (K6: the bezier probe's and the klein march's)
     against their plain versions;
 13. the kernels on the sphere scenes: K1 against the plain step (65,536
     lanes) and K2 against the plain VJP (24,576 lanes) on test_scene under
     the gradient sky, a moving-sphere scene and the RTOW final scene
     (random_scene(seed=0): 227 spheres, P = 4,794), float32 and float64;
     K3 against step_packed and one K4 chunk bitwise equal to 32 K3
     launches on the RTOW scene;
 14. sphere renders against their references: parity configs 1
     (three_spheres) and 2 (the RTOW final scene) against their goldens,
     compiled with no `device` (the card is the default); the
     differentiable render of three_spheres against its forward render
     (bitwise) and, in float64, against finite differences;
 15. the sphere slice at full width: the RTOW final scene at 512x512 spp8
     depth 100, forward through render_with_stats (FIFO pool, K1) and the
     persistent pool (K4) with equal segments, and the fwd+bwd step through
     render_diff_fused (K1 and K2), timed and profiled as phases 7-8 and 11;
 16. the kernels on the textured and smoke scenes: K1 against the plain step
     and K2 against the plain VJP (the image texels' cotangent included) on
     textured_scene (BASELINE config 3), test_scene2 ("simple light": marble)
     and cornell_smoke (two constant media), float32 and float64; K3 against
     step_packed and one K4 chunk bitwise equal to 32 K3 launches on
     textured_scene and cornell_smoke;
 17. their renders against their references: parity config 3 against its
     golden; the differentiable renders of textured_scene and cornell_smoke
     against their forward renders (bitwise) and, in float64, against finite
     differences on the marble's scale, an image texel and a medium's
     density;
 18. the textured and smoke scenes at full width: textured_scene and
     cornell_smoke (light sampled) at 512x512 spp8 depth 100, forward
     through the FIFO pool and the persistent pool and fwd+bwd, as phase 15;
 19. the kernels on the bezier scenes: K1 against the plain step and K2
     against the plain VJP on test_bezier (BASELINE config 5), cornell_bezier
     (config 6) and points_chain_scene's helix, float32 and float64, on
     lanes aimed into the curves' bounding box (the share that hits a ribbon
     is logged), K2 with the control points' slots of dpk named;
 20. K3 against step_packed and one K4 chunk bitwise equal to 32 K3 launches
     on test_bezier and cornell_bezier;
 21. parity configs 5 and 6 against their goldens;
 22. the differentiable render of test_bezier against its forward render
     (bitwise), and in float64 AD against finite differences on one
     control-point coordinate of the noise-textured curve of the parity
     harness's gradient scene;
 23. the bezier scenes at full width: test_bezier and cornell_bezier (light
     sampled) at 512x512 spp8 depth 100, forward through the FIFO pool and
     the persistent pool and fwd+bwd, as phase 15 but with five timed runs
     (minimum, median, maximum) and the kernels' device time in one run by
     CUDA events around every launch;
 24. the kernels on the klein scenes: K1 against the plain step and K2
     against the plain VJP on klein_scene and cornell_klein, float32 and
     float64, on lanes aimed at the fractal from outside its precull ball
     (the share that ends on the klein, the plain march's steps and
     inversions and the share of marching lanes at the 100-step cap are
     logged), K2's f64 dpk within 1e-10 and the K_C slots named;
 25. K3 against step_packed and one K4 chunk bitwise equal to 32 K3 launches
     on both klein scenes;
 26. there is no klein golden, and f32 and f64 klein renders differ by
     design: the f32 render of cornell_klein at 32x32 spp2 depth 100 against
     the plain step's, with tests/test_parity.py's bounds, and its distance
     from the f64 render logged;
 27. the differentiable render of cornell_klein against its forward render
     (bitwise), and in float64 AD against finite differences on the klein's
     centre on a window where the estimator's normal holds (KLEIN_FD_CFG);
 28. the klein scenes at full width, as phase 23: klein_scene and
     cornell_klein (light sampled) at 512x512 spp8 depth 100, forward
     through the FIFO and the persistent pools and fwd+bwd.

Every kernel's bound is printed beside its time: the larger of its bytes
over 3.35 TB/s and a floor of its float operations over 67 TFLOP/s.  The
last two lines are the kernel table and the device line, as JSON; every
phase logs what it took (`[time]`).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from scheme_raytrace_torch import render, scenes
from scheme_raytrace_torch.config import SHADOW_EPS, RenderConfig
from scheme_raytrace_torch.integrator import (bounce, diff_fused, persist,
                                              pool_fused, pool_packed,
                                              pool_strided)
from scheme_raytrace_torch.scene import build, compile_scene
from scheme_raytrace_torch.scene import objects as ob
from scheme_raytrace_torch.tools import probe_loops, probe_ops
from scheme_raytrace_torch.utils import cuda_build

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "config4_cornell_light.npz")
M = 64 * 1024                 # lanes: the pool width of the 512^2 render
FULL = RenderConfig(nx=512, ny=512, spp=16, max_depth=100, seed=0,
                    light_sampling=True)
CONFIG4 = RenderConfig(nx=64, ny=64, spp=8, max_depth=100, seed=0,
                       light_sampling=True)
# f32 kernel vs plain bounds (tests/test_bounce.py:180-187): rtol 1e-4,
# atol 1e-3 at Cornell's 0..555 coordinate scale; lanes outside them (f32
# branch flips: a rect-edge or threshold decision taken the other way) may
# be at most 0.1%.  f64: every lane within rtol 1e-9 / atol 1e-9.
F32_TOL = dict(rtol=1e-4, atol=1e-3)
F64_TOL = dict(rtol=1e-9, atol=1e-9)
MAX_FLIP_FRAC = 1e-3
M_BWD = 24 * 1024             # lanes: the reverse pool's width at 512^2
FULL_BWD = RenderConfig(nx=512, ny=512, spp=8, max_depth=100, seed=0,
                        light_sampling=True)
# backward kernel vs plain VJP bounds.  f64: lane cotangents within rtol /
# atol 1e-9, dpk within 1e-8 of max|dpk| (its sums run in another order).
# f32: tests/test_bounce_vjp.py:69-73, rtol 1e-3 and atol 1e-5 * max(1,
# max|ref|) per output, on the lanes whose forward agrees (F32_TOL).
BWD_F64 = dict(rtol=1e-9, atol=1e-9, dpk=1e-8)
BWD_F32 = dict(rtol=1e-3, atol=1e-5)
# The sphere scenes.  Parity configs 1 and 2 at their goldens' sizes
# (scheme_raytrace_tpu/parity.py), and the RTOW final scene at the size
# tools/bench_scenes.py renders a scene (512^2 spp8 depth 100; no emitter,
# so no light sampling).
CONFIG1 = RenderConfig(nx=64, ny=64, spp=10, max_depth=100, seed=0)
CONFIG2 = RenderConfig(nx=64, ny=64, spp=4, max_depth=100, seed=0)
RTOW = RenderConfig(nx=512, ny=512, spp=8, max_depth=100, seed=0)
# The textured and smoke scenes: parity config 3 at its golden's size, and
# textured_scene and cornell_smoke at tools/bench_scenes.py's size
# (textured_scene has no emitter, so no light sampling).
CONFIG3 = RenderConfig(nx=64, ny=64, spp=4, max_depth=100, seed=0)
TEXTURED = RenderConfig(nx=512, ny=512, spp=8, max_depth=100, seed=0)
SMOKE = RenderConfig(nx=512, ny=512, spp=8, max_depth=100, seed=0,
                     light_sampling=True)
# AD against finite differences needs few paths: every path is a chance
# that +-eps moves a hit across a silhouette, which FD sees and AD's
# interior derivative leaves out (at 64^2 spp10 depth 100 FD of a centre is
# dominated by such flips).  So that check runs parity config 1's big
# gradient workload: 16^2, depth 3, the loss over the centre sphere's
# interior (window_big), at spp 4.
FD_CFG = RenderConfig(nx=16, ny=16, spp=4, max_depth=3, seed=0, dtype="f64")
FD_WINDOW = (6, 10, 6, 10)
# The card's published peaks (NVIDIA H100 SXM data sheet): the bound of a
# kernel is the larger of its bytes over the memory rate and its operations
# over the float32 rate outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# A floor of the float operations of one bounce, counted from the code: a
# rect probe's two dots, difference and quotient (12); a sphere probe's
# o - c, two dots, r r and the discriminant (18), and 12 more for a moving
# centre; a fresh lane's camera ray (60) and a scattering lane's shading
# (100), both without their transcendentals.  Probes that pass a test do
# more; the floor keeps the bound a bound.
RECT_FLOPS, SPHERE_FLOPS, MOVING_FLOPS = 12, 18, 12
CAMERA_FLOPS, SHADE_FLOPS = 60, 100
# One Perlin noise value: 8 corners, each the 27 integer operations of the
# truncated PCG4D round and 25 float ones (three top-24-bit conversions, the
# normalisation, the corner's dot and weight), and the fade (14); marble is
# 7 of them.  The integer operations are counted at the float rate (their
# own peak is lower, so the floor stays a floor).  A live lane probes each
# medium: three slab intervals (two dots, two quotient products and the
# compares each), its share of a PCG4D group and a log.
NOISE_OPS, MARBLE_OCTAVES, MEDIUM_OPS = 8 * (27 + 25) + 14, 7, 60
# The bezier scenes: parity configs 5 and 6 at their goldens' sizes, and
# test_bezier and cornell_bezier (light sampled) at the size of the other
# full-size configurations.
CONFIG5 = RenderConfig(nx=64, ny=64, spp=4, max_depth=100, seed=0)
CONFIG6 = RenderConfig(nx=64, ny=64, spp=4, max_depth=100, seed=0)
BEZIER = RenderConfig(nx=512, ny=512, spp=8, max_depth=100, seed=0)
CORNELL_BEZIER = RenderConfig(nx=512, ny=512, spp=8, max_depth=100, seed=0,
                              light_sampling=True)
# The bezier probe's operations, counted from csrc/bounce_common.cuh: one
# evaluation of g and its derivatives (bezier_g) is two Horner forms (12),
# the two first and two second derivatives (12) and g, g', 2|c'|^2 and g''
# (16); a Newton step adds its quotient, difference, clip and guard (5); a
# seed ends in one more evaluation, zc's Horner form and the accept test
# (11).  A curve costs a live lane its four control points' projections and
# the power basis (100) and bez_seeds seeds; the frame is once a lane (30).
BEZ_G_OPS, BEZ_STEP_OPS, BEZ_END_OPS = 40, 5, 11
BEZ_CURVE_OPS, BEZ_FRAME_OPS = 100, 30
N_TIMED_BEZIER = 5  # timed runs of the bezier cells: minimum, median, maximum
# The klein scenes: klein_scene (a ground sphere of radius 1000 and the
# fractal, the camera inside its solid) and cornell_klein (the Cornell walls,
# a wide light and the fractal; light sampled) at the size of the other
# full-size configurations, and cornell_klein at 32^2 spp2 depth 100 for the
# kernel's render against the plain step's.
KLEIN = RenderConfig(nx=512, ny=512, spp=8, max_depth=100, seed=0)
CORNELL_KLEIN = RenderConfig(nx=512, ny=512, spp=8, max_depth=100, seed=0,
                             light_sampling=True)
CONFIG_KLEIN = RenderConfig(nx=32, ny=32, spp=2, max_depth=100, seed=0,
                            light_sampling=True)
# The klein probe's operations, counted from csrc/bounce_common.cuh: the
# precull a live lane (20); a march step: the point (6), the DE's escape test
# of all six spheres (54) and its tail (13), and the step's accept and
# retirement tests (28); an inversion: the selected sphere's test and the
# inversion itself (18); a winner's normal, klein_dist_grad (100), and in K2
# its adjoint, a second gradient and the Hessian-vector sweep (300).  Floors:
# the spheres tested before the selected one are not counted.
KLEIN_PRECULL_OPS, KLEIN_STEP_OPS, KLEIN_INV_OPS = 20, 101, 18
KLEIN_NORMAL_OPS, KLEIN_ADJ_OPS = 100, 300
# AD against finite differences on the klein's centre.  The JAX package's
# estimator (the port's, held to jax.grad) differentiates the hit's t by the
# implicit function at the march's t_raw but evaluates the normal at
# o + t_raw d with t_raw held: where the centre's move shifts the hit along
# the ray, the normal's change from that shift is left out, which FD sees (up
# to 100% on a curved lobe, by design).  So the check runs where that shift
# is small: one bounce (no path beyond the first scatter), the y component of
# the centre (across the view), and the window of 16^2 pixels whose camera
# rays meet the fractal there; measured on the CPU, AD is within 0.31% of FD
# (eps 1e-3 and 1e-4 agree).
KLEIN_FD_CFG = RenderConfig(nx=16, ny=16, spp=1, max_depth=1, seed=0,
                            dtype="f64", light_sampling=True)
KLEIN_FD_WINDOW = (2, 8, 10, 13)
KLEIN_FD_AXIS, KLEIN_FD_EPS = 1, 1e-3
K1, K2, K3, K4 = ("bounce_step", "bounce_step_bwd", "bounce_packed",
                  "bounce_persist")
PROBES = ("probe_ops", "probe_loops")
CHUNK_TS = (8, 16, 32, 64)    # K4 chunk lengths timed (CHUNK_T stays 32)
# K5: outputs of the int path exact, the transcendental ones within 2e-6
# relative (nvcc's sinf/cosf/powf against PyTorch's, a few ulp apart)
PROBE_RTOL = 2e-6


def log(*a):
    print(*a, flush=True)


START = time.perf_counter()


def timed(name, phase, *args):
    """Run one phase and log what it took."""
    t0 = time.perf_counter()
    out = phase(*args)
    t1 = time.perf_counter()
    log(f"[time] {name}: {t1 - t0:.1f} s ({t1 - START:.1f} s since the "
        f"start)")
    return out


def spread(times):
    """Minimum, median and maximum of a list of seconds, in ms."""
    return (f"min {min(times) * 1e3:.2f} / median "
            f"{statistics.median(times) * 1e3:.2f} / max "
            f"{max(times) * 1e3:.2f} ms")


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count "
        f"{torch.cuda.device_count()}")
    return torch.device("cuda", 0), smi


def grad_bezier_spec():
    """test_bezier with its curves replaced by one noise-textured curve of
    width 0.7 (the gradient scene of the parity harness's config 5): a
    constant-albedo ribbon with normal -d has no continuous dependence on
    its control points; an albedo that depends on the hit point has."""
    spec = scenes.test_bezier()
    objs = [o for o in spec.objects if not isinstance(o, ob.Bezier)]
    cp = np.array([[-1, 0, -1], [-0.8, 1, 1], [0.8, -1, 1], [1, 0, -1]], float)
    objs.append(ob.Bezier(cp, 0.7, ob.Lambertian(ob.NoiseTexture(2.0))))
    return scenes.SceneSpec(objs, spec.camera_kwargs, spec.sky)


def moving_spec():
    """The moving-sphere scene of tests/test_bounce.py."""
    objs = [ob.Sphere((0, -100.5, -1), 100, ob.Lambertian((0.6, 0.6, 0.2))),
            ob.MovingSphere((0, 0, -1), (0, 0.4, -1), 0.0, 1.0, 0.5,
                            ob.Lambertian((0.2, 0.3, 0.7)))]
    return scenes.SceneSpec(objs, scenes.default_camera(), "gradient")


def rtow_spec():
    return scenes.random_scene(seed=0)


# phase -> the (kernels, scene) pairs whose variants it launches: what the
# build phase compiles ahead of the timed windows.  A variant is named by its
# plan's feature set, which the scene alone decides.
VARIANTS = {
    "kernel": [((K1,), scenes.cornell_box)],
    "kernel-bwd": [((K1, K2), scenes.cornell_box),
                   ((K1, K2), scenes.cornell_materials)],
    "golden": [((K1,), scenes.cornell_box)],
    "diff": [((K1, K2), scenes.cornell_box)],
    "full": [((K1,), scenes.cornell_box)],
    "profile": [((K1,), scenes.cornell_box)],
    "full-bwd": [((K1, K2), scenes.cornell_box)],
    "packed-kernel": [((K3,), scenes.cornell_box)],
    "persist-kernel": [((K3, K4), scenes.cornell_box)],
    "pools-full": [((K1, K3, K4), scenes.cornell_box)],
    "probes": [(PROBES, None)],
    "kernel-spheres": [((K1,), scenes.test_scene), ((K1,), moving_spec),
                       ((K1,), rtow_spec)],
    "kernel-bwd-spheres": [((K1, K2), scenes.test_scene),
                           ((K1, K2), moving_spec), ((K1, K2), rtow_spec)],
    "packed-spheres": [((K3, K4), rtow_spec)],
    "golden-spheres": [((K1,), scenes.three_spheres), ((K1,), rtow_spec)],
    "diff-spheres": [((K1, K2), scenes.three_spheres)],
    "full-spheres": [((K1, K2, K4), rtow_spec)],
    "kernel-textures": [((K1, K2), scenes.textured_scene),
                        ((K1, K2), scenes.test_scene2),
                        ((K1, K2), scenes.cornell_smoke)],
    "packed-textures": [((K3, K4), scenes.textured_scene),
                        ((K3, K4), scenes.cornell_smoke)],
    "golden-textures": [((K1,), scenes.textured_scene)],
    "diff-textures": [((K1, K2), scenes.textured_scene),
                      ((K1, K2), scenes.cornell_smoke)],
    "full-textures": [((K1, K2, K4), scenes.textured_scene),
                      ((K1, K2, K4), scenes.cornell_smoke)],
    "kernel-bezier": [((K1, K2), scenes.test_bezier),
                      ((K1, K2), scenes.cornell_bezier),
                      ((K1, K2), scenes.points_chain_scene)],
    "packed-bezier": [((K3, K4), scenes.test_bezier),
                      ((K3, K4), scenes.cornell_bezier)],
    "golden-bezier": [((K1,), scenes.test_bezier),
                      ((K1,), scenes.cornell_bezier)],
    "diff-bezier": [((K1, K2), scenes.test_bezier),
                    ((K1, K2), grad_bezier_spec)],
    "full-bezier": [((K1, K2, K4), scenes.test_bezier),
                    ((K1, K2, K4), scenes.cornell_bezier)],
    "kernel-klein": [((K1, K2), scenes.klein_scene),
                     ((K1, K2), scenes.cornell_klein)],
    "packed-klein": [((K3, K4), scenes.klein_scene),
                     ((K3, K4), scenes.cornell_klein)],
    "golden-klein": [((K1,), scenes.cornell_klein)],
    "diff-klein": [((K1, K2), scenes.cornell_klein)],
    "full-klein": [((K1, K2, K4), scenes.klein_scene),
                   ((K1, K2, K4), scenes.cornell_klein)],
}


def features_of(spec_fn):
    """The kernel feature set of a scene's plans (compiled on the CPU: the
    device does not enter a plan)."""
    spec = spec_fn()
    scene = compile_scene(spec.objects, sky=spec.sky, lights=spec.lights,
                          device="cpu")
    return bounce.kernel_features(
        bounce.pool_plan(scene, RenderConfig(nx=8, ny=8, spp=1)))


def needed_variants(selected):
    """The (kernel, feature set) pairs the selected phases launch."""
    out = set()
    for phase in selected:
        for kernels, spec_fn in VARIANTS[phase]:
            feats = () if spec_fn is None else features_of(spec_fn)
            out |= {(k, feats) for k in kernels}
    return sorted(out)


# Device functions that stay calls in a variant that has their group: a
# variant without the group must have none of them (its log lists every
# function ptxas compiled).
GROUP_FUNCTIONS = {"perlin": "perlin_noise", "media": "medium_adj",
                   "bezier": "bezier_adj", "klein": "klein_adj"}


def phase_build(selected):
    """Every variant the selected phases need, compiled ahead of the timed
    windows: one nvcc a variant, as many at once as the host has cores, the
    backward kernels (the longest builds) first.  Logs each variant's build
    seconds and each compiled entry's registers, spills, stack and shared
    memory; returns them by variant name."""
    variants = needed_variants(selected)
    order = sorted(variants, key=lambda v: (v[0] != K2, v))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 8) as ex:
        list(ex.map(lambda v: cuda_build.load(*v), order))
    sets = sorted({f for _, f in variants})
    log(f"[build] {len(variants)} variants of "
        f"{len({k for k, _ in variants})} kernels over {len(sets)} feature "
        f"sets in {time.perf_counter() - t0:.1f} s on {os.cpu_count()} cores: "
        + ", ".join("+".join(f) or "base" for f in sets))
    out = {}
    for name, feats in variants:
        key = cuda_build.variant_name(name, feats)
        info = cuda_build.LOADED[key]
        res = cuda_build.resources(info["log"])
        out[key] = res
        how = (f"built in {info['seconds']:.1f} s" if info["built"]
               else "cached")
        log(f"[build] {key}: {how} -> "
            f"{os.path.relpath(info['path'], ROOT)}")
        for r in res:
            kind = "f64" if "IdE" in r["entry"] else "f32"
            log(f"[build]   {kind}: {r['registers']} "
                f"registers, spills {r['spill_stores']} B stored "
                f"{r['spill_loads']} B loaded, stack {r['stack']} B, shared "
                f"{r['smem']} B")
        if "error" in info["log"].lower():
            log(f"[build]   log: {info['log'][-2000:]}")
        calls = [fn for fn in GROUP_FUNCTIONS.values() if fn in info["log"]]
        if calls:
            log(f"[build]   device functions kept as calls: {calls}")
        for group, fn in GROUP_FUNCTIONS.items():
            if group not in feats and fn in info["log"]:
                raise AssertionError(f"[build] {key} holds {fn}, the code of "
                                     f"a group its feature set lacks")
    return out


def cornell(dtype, device, spec_fn=scenes.cornell_box):
    spec = spec_fn()
    scene = compile_scene(spec.objects, sky=spec.sky, dtype=dtype,
                          lights=spec.lights, device=device)
    return scene, spec.camera(dtype=dtype, aspect=1.0, device=device)


def lane_inputs(m, config, dtype, device, seed=0, box=None, aim=None):
    """Numpy-seeded lanes of the kinds tests/test_bounce.py draws: random
    gitems (negatives included), pixels, fresh/alive masks, depths (some
    at the cap), origins inside the box, unit directions, and nonzero
    radiance/throughput.  `box` (lo, hi) scales the origins to a sphere
    scene and draws the lanes' times in [0, 1); without it the origins lie
    in Cornell's 0..500 cube and the times are 0.  `aim` (lo, hi) points
    every direction from its origin at a random point of that box, so that a
    real share of the lanes meets what lies in it."""
    r = np.random.default_rng(seed)
    gitem = r.integers(-2 ** 31, 2 ** 31, m, dtype=np.int64).astype(np.int32)
    px = r.integers(0, config.nx, m)
    py = r.integers(0, config.ny, m)
    fresh = r.random(m) < 0.5
    alive = fresh | (r.random(m) < 0.7)
    depth = r.integers(0, 4, m).astype(np.int32)
    depth[r.random(m) < 0.05] = config.max_depth
    o = r.random((3, m)) * 500.0
    dvec = r.normal(size=(3, m))
    dvec /= np.linalg.norm(dvec, axis=0, keepdims=True)
    rad = r.random((3, m))
    tp = r.uniform(0.1, 1.0, (3, m))
    times = np.zeros(m)
    if box is not None:
        lo, hi = (np.asarray(b, np.float64)[:, None] for b in box)
        o = lo + o / 500.0 * (hi - lo)
        times = r.random(m)
    if aim is not None:
        lo, hi = (np.asarray(b, np.float64)[:, None] for b in aim)
        dvec = lo + r.random((3, m)) * (hi - lo) - o
        dvec /= np.linalg.norm(dvec, axis=0, keepdims=True)
    f = lambda x: torch.tensor(x, dtype=dtype, device=device)
    return (torch.tensor(gitem, device=device), f(px), f(py),
            torch.tensor(fresh, device=device),
            torch.tensor(alive, device=device),
            torch.tensor(depth, device=device), tuple(f(x) for x in o),
            tuple(f(x) for x in dvec), f(times),
            tuple(f(x) for x in rad), tuple(f(x) for x in tp))


def flat(out):
    o, d, time_, rad, tp, sc = out
    return torch.stack([*o, *d, time_, *rad, *tp]), sc


def median_ms(fn, n=20):
    """Median elapsed time of fn() on the card over n runs (CUDA events
    around each call: host work inside the call that keeps the card waiting
    counts)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_kernels(fn, n=1, host_ops=True):
    """Run fn() n times under torch.profiler; return the wall ms per run and
    {kernel name: (device us per run, launches per run)} from the device
    events alone (op rows on the host side are not counted).  Without
    `host_ops` the profiler traces the card only: the same device events,
    and half the time to read them (0.11 against 0.22 ms an event on a plain
    step's 9,637 launches), which counts for the plain versions' hundreds of
    thousands of launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    table = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, k = table.get(e.name, (0.0, 0))
            table[e.name] = (us + e.time_range.elapsed_us() / n, k + 1 / n)
    return wall_ms, table


def disagreeing(got, want, tol):
    """Lanes where scattering differs, an output is outside the bounds, or
    the kernel's output is not finite."""
    (g, g_sc), (w, w_sc) = got, want
    off = ((g - w).abs() > tol["atol"] + tol["rtol"] * w.abs()).any(0)
    return (g_sc != w_sc) | off | ~torch.isfinite(g).all(0)


def errors(got, want, tol):
    """(lanes disagreeing, of which scattering differs, max abs err on the
    other lanes)."""
    bad = disagreeing(got, want, tol)
    return (int(bad.sum()), int((got[1] != want[1]).sum()),
            float((got[0] - want[0]).abs()[:, ~bad].max()))


# name -> (spec, sky, the box the lane origins are drawn from): test_scene
# under the gradient sky (its own sky is black with no emitter), the
# moving-sphere scene, and the RTOW final scene (227 spheres, P = 4,794)
SPHERE_SCENES = {
    "test": (scenes.test_scene, "gradient", ((-2, -0.4, -3), (2, 1.5, 1))),
    "moving": (moving_spec, "gradient", ((-2, -0.4, -3), (2, 1.5, 1))),
    "rtow": (rtow_spec, "gradient",
             ((-6, 0.0, -6), (10, 2.5, 10))),
}


def sphere_scene(name, dtype, device):
    """(scene, camera, lane box, f32 atol) of a SPHERE_SCENES entry.  The
    atol is Cornell's 1e-3 at its 0..555 scale, scaled to this scene's: its
    largest centre coordinate or radius (the ground sphere's)."""
    spec_fn, sky, box = SPHERE_SCENES[name]
    spec = spec_fn()
    scene = compile_scene(spec.objects, sky=sky, dtype=dtype, device=device)
    scale = max(float(scene.sph_c0.abs().max()), float(scene.sph_c1.abs().max()),
                float(scene.sph_r.abs().max()))
    cam = spec.camera(dtype=dtype, aspect=1.0, device=device)
    return scene, cam, box, 1e-3 * scale / 555.0


def sweep_flops(plan):
    """The floor of one lane's closest-hit sweep (see RECT_FLOPS)."""
    return (plan.n_rects * RECT_FLOPS + plan.n_spheres
            * (SPHERE_FLOPS + (MOVING_FLOPS if plan.has_moving else 0)))


def bound(n_bytes, flops):
    """(bound_ms, bound_by): the least time the card could take."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def texture_ops(plan, pk, gitem, px, py, fresh, alive, depth, o, d, time,
                *_):
    """The operations these lanes' media and Perlin textures need: every
    live lane probes each medium, and a live lane whose winner (the plain
    step's record) carries a noise or a marble texture evaluates it."""
    ops = int(alive.sum()) * plan.n_media * MEDIUM_OPS
    if plan.has_perlin:
        rec = bounce.hit_record(plan, bounce.split_pk(plan, pk)[0], gitem, px,
                                py, fresh, depth, o, d, time)[3]
        live = alive & rec["hit"]
        ops += NOISE_OPS * (
            int((live & (rec["texk"] == build.TEX_NOISE)).sum())
            + MARBLE_OCTAVES
            * int((live & (rec["texk"] == build.TEX_MARBLE)).sum()))
    return ops


def bezier_ops(plan, alive):
    """The operations of these lanes' bezier probes (see BEZ_G_OPS): every
    live lane runs every seed of every curve to the end; dead lanes run
    none."""
    if not plan.n_beziers:
        return 0
    seed = (plan.bez_newton * (BEZ_G_OPS + BEZ_STEP_OPS) + BEZ_G_OPS
            + BEZ_END_OPS)
    return int(alive.sum()) * (BEZ_FRAME_OPS + plan.n_beziers
                               * (BEZ_CURVE_OPS + plan.bez_seeds * seed))


def ribbon_winners(plan, pk, gitem, px, py, fresh, alive, depth, o, d, time,
                   *_):
    """The live lanes whose closest hit (the plain step's record) is a
    ribbon: its normal is -d, bit for bit."""
    o, d, _, rec = bounce.hit_record(plan, bounce.split_pk(plan, pk)[0],
                                     gitem, px, py, fresh, depth, o, d, time)
    return (alive & rec["hit"] & (rec["wn"][0] == -d[0])
            & (rec["wn"][1] == -d[1]) & (rec["wn"][2] == -d[2]))


def klein_rays(c, m, seed):
    """Origins and unit directions of m lanes aimed at the klein centred at
    c: origins outside the march's precull ball (|o - c| in [730, 1000]) on
    the side of smaller z, the cameras' side, aimed at random points within
    300 of c; one lane in ten born within 100 of c on each axis, most of
    them inside the fractal's solid, where the march retires them
    backward-stuck."""
    r = np.random.default_rng(seed + 1000)
    u = r.normal(size=(3, m))
    u[2] = -np.abs(u[2]) - 1.0
    u /= np.linalg.norm(u, axis=0)
    o = c[:, None] + u * r.uniform(730.0, 1000.0, m)
    inside = r.random(m) < 0.1
    o[:, inside] = c[:, None] + r.uniform(-100.0, 100.0,
                                          (3, int(inside.sum())))
    dv = c[:, None] + r.uniform(-300.0, 300.0, (3, m)) - o
    return o, dv / np.linalg.norm(dv, axis=0)


def klein_inputs(m, config, dtype, device, scene, seed=0):
    """lane_inputs with the rays of klein_rays about the scene's first
    klein (a fresh lane still takes the camera's ray)."""
    ins = lane_inputs(m, config, dtype, device, seed=seed)
    o, d = klein_rays(scene.kl_center[0].double().cpu().numpy(), m, seed)
    f = lambda x: torch.tensor(x, dtype=dtype, device=device)
    return (*ins[:6], tuple(f(x) for x in o), tuple(f(x) for x in d),
            *ins[8:])


def klein_work(plan, pk, gitem, px, py, fresh, alive, depth, o, d, time,
               *_):
    """The live lanes whose closest hit is a klein, and the klein march's
    work on these lanes: the plain march (bounce._klein_march) as the
    kernels run it, on the live lanes, bounded by the closest hit of the
    rects and spheres (the klein scenes have no ribbon or medium after the
    kleins).  Returns (winners, {marching, steps, inversions, stuck,
    capped})."""
    pk0 = bounce.split_pk(plan, pk)[0]
    o, d, _, rec = bounce.hit_record(dataclasses.replace(plan, n_kleins=0),
                                     pk0, gitem, px, py, fresh, depth, o, d,
                                     time)
    live = alive.nonzero()[:, 0]
    stats = dict(marching=0, steps=0, inversions=0, stuck=0, capped=0)
    best, won = rec["t"][live], torch.zeros_like(live, dtype=torch.bool)
    for k in range(plan.n_kleins):
        b = plan.kl_base + k * bounce.KL_SIZE
        hit, t = bounce._klein_march(
            tuple(pk0[b + bounce.K_C + i] for i in range(3)),
            tuple(x[live] for x in o), tuple(x[live] for x in d), SHADOW_EPS,
            best, stats)
        hit = hit & (pk0[b + bounce.K_VALID] > 0.5)
        best = torch.where(hit, t, best)
        won = won | hit
    winners = torch.zeros_like(alive)
    winners[live] = won
    return winners, stats


def klein_ops(plan, pk, ins, win_ops):
    """The klein probe's operations on these lanes (see KLEIN_STEP_OPS), a
    winner counted at win_ops; returns (winners, ops, the march's stats)."""
    won, st = klein_work(plan, pk, *ins)
    ops = (int(ins[4].sum()) * plan.n_kleins * KLEIN_PRECULL_OPS
           + st["steps"] * KLEIN_STEP_OPS + st["inversions"] * KLEIN_INV_OPS
           + int(won.sum()) * win_ops)
    return won, ops, st


def log_klein_work(tag, name, plan, pk, ins, win_ops):
    """Logs the lanes' klein winners and march work (the share of marching
    lanes that reach the step cap); raises if no lane ends on a klein.
    Returns (winners, ops)."""
    won, ops, st = klein_ops(plan, pk, ins, win_ops)
    n_won, n_live = int(won.sum()), int(ins[4].sum())
    marching = max(st["marching"], 1)
    log(f"[{tag}] {name}: {n_won} of {n_live} live lanes "
        f"({n_won / ins[4].numel():.1%} of all) end on the klein; the plain "
        f"march: {st['marching']} lanes march {st['steps']} steps "
        f"({st['steps'] / marching:.1f} a lane) "
        f"with {st['inversions']} inversions "
        f"({st['inversions'] / max(st['steps'], 1):.2f} a step); "
        f"{st['capped']} lanes ({st['capped'] / marching:.2%} of those "
        f"marching) reach the {bounce.cfg_mod.KLEIN_MAX_STEPS}-step cap")
    if not n_won:
        raise AssertionError(f"[{tag}] {name}: no lane ends on the klein")
    return won, ops


def scene_bytes(plan):
    """pk and the image texels, each read once, in f32."""
    return (plan.size + plan.img_rows * 128) * 4


def k1_bound(plan, pk, m, ins, scattering, klein_ops=0):
    """K1 in f32: 6 queue columns (18 B), 13 floats in, 13 out and one
    bool a lane, and pk and the texels once; every lane sweeps.  klein_ops:
    the klein probe's (klein_work)."""
    flops = (m * sweep_flops(plan) + int(ins[3].sum()) * CAMERA_FLOPS
             + int(scattering.sum()) * SHADE_FLOPS
             + texture_ops(plan, pk, *ins) + bezier_ops(plan, ins[4])
             + klein_ops)
    return bound(m * (18 + 13 * 4 + 13 * 4 + 1) + scene_bytes(plan), flops)


def check_k1(tag, name, scene, cam, cfg, dtype, dev, box=None, atol=None,
             aim=None, timed=True):
    """K1 against the plain step on one (scene, config, dtype) at the
    forward pool's width: agreement, flips, times (unless not `timed`),
    bound.  A klein scene's lanes are aimed at the fractal
    (klein_inputs)."""
    plan = bounce.pool_plan(scene, cfg)
    pk = bounce.pack(scene, cam, plan, dtype)
    ins = (klein_inputs(M, cfg, dtype, dev, scene) if plan.n_kleins
           else lane_inputs(M, cfg, dtype, dev, box=box, aim=aim))
    want = flat(bounce.step(plan, pk, *ins))
    kl_ops = 0
    if plan.n_kleins:
        _, kl_ops = log_klein_work(tag, name, plan, pk, ins, KLEIN_NORMAL_OPS)
    if plan.n_beziers:
        n_rib = int(ribbon_winners(plan, pk, *ins).sum())
        log(f"[{tag}] {name}: {n_rib} of {int(ins[4].sum())} live lanes "
            f"({n_rib / M:.1%} of all) end on a ribbon")
        if not n_rib:
            raise AssertionError(f"[{tag}] {name}: no lane hits a ribbon")
    got = flat(bounce.step_cuda(plan, pk, *ins))
    torch.cuda.synchronize()
    tol = dict(F64_TOL if dtype == torch.float64 else F32_TOL)
    if atol is not None and dtype == torch.float32:
        tol["atol"] = atol
    n_bad, n_sc, max_err = errors(got, want, tol)
    log(f"[{tag}] {name}: m={M} P={plan.size} scattering "
        f"{int(want[1].sum())} lanes; kernel vs plain: lanes disagreeing "
        f"{n_bad} (scattering differs on {n_sc}; bounds rtol "
        f"{tol['rtol']:g} atol {tol['atol']:.3g}); max abs err on the other "
        f"lanes {max_err:.3e}")
    if dtype == torch.float32 and n_bad:
        # which side took the rounding: on the disagreeing lanes, both
        # f32 versions against the plain step in f64 on the same
        # (exactly widened) inputs
        wide = lambda x: (tuple(t.double() for t in x)
                          if isinstance(x, tuple) else
                          x.double() if x.is_floating_point() else x)
        ref = flat(bounce.step(plan, wide(pk), *[wide(x) for x in ins]))[0]
        lanes = disagreeing(got, want, tol)
        k_err = (got[0].double() - ref).abs()[:, lanes].amax(0)
        p_err = (want[0].double() - ref).abs()[:, lanes].amax(0)
        log(f"[{tag}] {name}: of the {n_bad} disagreeing lanes the "
            f"kernel is nearer the f64 step on "
            f"{int((k_err < p_err).sum())}, the plain f32 step on "
            f"{int((p_err < k_err).sum())}")
    limit = 0 if dtype == torch.float64 else MAX_FLIP_FRAC * M
    if n_bad > limit:
        raise AssertionError(f"[{tag}] {name}: {n_bad} lanes disagree "
                             f"(limit {limit:g})")
    if not timed:
        return dict(name=name, max_abs_err=max_err, bad=n_bad)
    k_wall = median_ms(lambda: bounce.step_cuda(plan, pk, *ins))
    p_wall = median_ms(lambda: bounce.step(plan, pk, *ins),
                       n=1 if plan.n_kleins else 3)
    # the wrapper launches the kernel and nothing else, so the back-to-back
    # calls' time is the kernel's (the profiler drops device events of short
    # windows, see device_ms: it recorded 12, 1 and 0 of 20 K1 launches)
    k_ms = kernel_ms(lambda: bounce.step_cuda(plan, pk, *ins))
    if plan.n_kleins:                 # some 45,000 launches: p_wall's call
        p_ms, p_launches = p_wall, float("nan")
    else:
        p_ms, p_launches = device_ms(lambda: bounce.step(plan, pk, *ins), 2)
    b_ms, b_by = k1_bound(plan, pk, M, ins, want[1], kl_ops)
    log(f"[{tag}] {name}: device time per step: kernel {k_ms:.4f} ms "
        f"(CUDA events, back to back), plain {p_ms:.4f} ms ({p_launches:.0f} "
        f"launches); elapsed per call (median, host included): "
        f"kernel {k_wall:.4f} ms, plain {p_wall:.3f} ms; f32 bound "
        f"{b_ms * 1e3:.2f} us ({b_by})")
    return dict(name=name, max_abs_err=max_err, ms=k_ms, plain_ms=p_ms,
                wall_ms=k_wall, plain_wall_ms=p_wall, bad=n_bad,
                bound_ms=b_ms, bound_by=b_by)


def dtype_name(dtype):
    return "f64" if dtype == torch.float64 else "f32"


def phase_kernel(dev):
    results = []
    for dtype in (torch.float32, torch.float64):
        for ls in (True, False):
            scene, cam = cornell(dtype, dev)
            results.append(check_k1(
                "kernel", f"{dtype_name(dtype)}-{'light' if ls else 'cosine'}",
                scene, cam, FULL.replace(light_sampling=ls), dtype, dev))
    return results


def phase_kernel_spheres(dev):
    """K1 on the sphere scenes: static spheres with the hollow negative
    radius, a moving sphere, and the 227-sphere RTOW final scene."""
    results = []
    for dtype in (torch.float32, torch.float64):
        for name in SPHERE_SCENES:
            scene, cam, box, atol = sphere_scene(name, dtype, dev)
            results.append(check_k1(
                "kernel-spheres", f"{dtype_name(dtype)}-{name}", scene, cam,
                RTOW, dtype, dev, box=box, atol=atol))
    return results


def dpk_of(grads):
    """A VJP's pk cotangent as one vector: dpk, then, for a plan with image
    textures, the texels' cotangent."""
    dpk = grads[0]
    if isinstance(dpk, tuple):
        dpk = torch.cat([dpk[0], dpk[1].reshape(-1)])
    return dpk


def lanes_of(grads):
    """(dpk, do, dd, dtime, drad, dtp) -> (dpk, [13, m] lane cotangents)."""
    return dpk_of(grads), torch.stack(bounce.flat_lanes(*grads[1:]))


def k2_bound(plan, pk, m, ins, scattering, klein_ops=0):
    """K2 in f32: the step's 19 inputs (70 B a lane), 13 cotangents in and
    13 out, pk and the texels once and one row of partials per 256-lane
    block; the replay of the forward and the adjoint of the scattering
    lanes (a Perlin texture is evaluated in both; the bezier march is run
    once, in the replay, and a winner's adjoint is a few hundred operations
    more, which the floor leaves out; klein_ops: the klein probe's replay and
    its winners' adjoints, klein_work)."""
    flops = (m * sweep_flops(plan) + int(ins[3].sum()) * CAMERA_FLOPS
             + 2 * int(scattering.sum()) * SHADE_FLOPS
             + 2 * texture_ops(plan, pk, *ins) + bezier_ops(plan, ins[4])
             + klein_ops)
    n_bytes = m * (70 + 26 * 4) + scene_bytes(plan) * (1 + -(-m // 256))
    return bound(n_bytes, flops)


def check_k2(tag, name, scene, cam, cfg, dtype, dev, box=None, atol=None,
             aim=None, dpk_tol=BWD_F64["dpk"], timed=True):
    """K2 against the plain VJP on one (scene, config, dtype) at the
    reverse pool's width: bounds, two launches bitwise equal, times.  The
    lanes' cotangents and every dpk slot are held on every lane that the
    forward does not flip; in f64 dpk within `dpk_tol` of its largest slot.
    A fresh lane's camera ray is the plain step's bit for bit (camera_ray
    rounds op by op), so a big ground sphere, which amplifies an ulp of the
    ray into percent-level f32 differences of the camera and sphere slots,
    sees the plain step's ray; the worst slot's share of its bound is
    logged.  Times and the bound unless not `timed`."""
    f64 = dtype == torch.float64
    plan = bounce.pool_plan(scene, cfg)
    pk = bounce.pack(scene, cam, plan, dtype)
    ins = (klein_inputs(M_BWD, cfg, dtype, dev, scene, seed=3)
           if plan.n_kleins else
           lane_inputs(M_BWD, cfg, dtype, dev, seed=3, box=box, aim=aim))
    r = np.random.default_rng(103)
    cts = [torch.tensor(x, dtype=dtype, device=dev)
           for x in r.normal(size=(13, M_BWD))]
    # f32: lanes whose forward the kernel and the plain step take
    # differently (the forward phases' flips) are left out, and given zero
    # cotangent for the dpk comparison
    keep = torch.ones(M_BWD, dtype=torch.bool, device=dev)
    fwd = flat(bounce.step(plan, pk, *ins))
    if not f64:
        tol = dict(F32_TOL, atol=F32_TOL["atol"] if atol is None else atol)
        keep = ~disagreeing(flat(bounce.step_cuda(plan, pk, *ins)), fwd, tol)
    n_out = int((~keep).sum())
    if n_out > MAX_FLIP_FRAC * M_BWD:
        raise AssertionError(f"[{tag}] {name}: {n_out} lanes "
                             f"flip in the forward")
    cts = bounce.split_lanes([torch.where(keep, c, 0.0)
                              for c in cts])
    want_pk, want = lanes_of(bounce.step_vjp(plan, pk, *ins, *cts))
    got_pk, got = lanes_of(bounce.step_cuda_bwd(plan, pk, *ins, *cts))
    again_pk, again = lanes_of(bounce.step_cuda_bwd(plan, pk, *ins,
                                                    *cts))
    torch.cuda.synchronize()
    if not (torch.equal(got_pk, again_pk) and torch.equal(got, again)):
        raise AssertionError(f"[{tag}] {name}: two identical "
                             f"launches differ")
    err = (got - want).abs()
    if f64:
        lane_bad = (err > BWD_F64["atol"]
                    + BWD_F64["rtol"] * want.abs()).any(0)
        pk_lim = dpk_tol * float(want_pk.abs().max())
        pk_bad = int(((got_pk - want_pk).abs() > pk_lim).sum())
    else:
        scale = torch.clamp(want[:, keep].abs().amax(1), min=1.0)
        lane_bad = (err > BWD_F32["atol"] * scale[:, None]
                    + BWD_F32["rtol"] * want.abs()).any(0) & keep
        pk_lim = (BWD_F32["atol"] * max(1.0, float(want_pk.abs().max()))
                  + BWD_F32["rtol"] * want_pk.abs())
        pk_off = (got_pk - want_pk).abs() > pk_lim
        log(f"[{tag}] {name}: dpk over all lanes, fresh ones included: "
            f"{int(pk_off.sum())} slots outside the bounds, the worst at "
            f"{float(((got_pk - want_pk).abs() / pk_lim).max()):.3f} of its "
            f"bound")
        pk_bad = int(pk_off.sum())
    n_bad = int(lane_bad.sum())
    max_err = float(err[:, keep].max())
    pk_err = float((got_pk - want_pk).abs().max()
                   / want_pk.abs().max())
    kl_ops = 0
    if plan.n_kleins:
        wins, kl_ops = log_klein_work(tag, name, plan, pk, ins,
                                      KLEIN_NORMAL_OPS + KLEIN_ADJ_OPS)
        # the fractal's centre takes cotangent from the lanes it wins
        kc = lambda x: x[plan.kl_base + bounce.K_C:plan.kl_base + bounce.K_C
                         + 3]
        log(f"[{tag}] {name}: dpk's K_C slots {kc(got_pk).tolist()} (plain "
            f"{kc(want_pk).tolist()}) from {int((wins & keep).sum())} klein "
            f"winners")
        if not (bool((wins & keep).any()) and bool((kc(got_pk) != 0).all())):
            raise AssertionError(f"[{tag}] {name}: the klein's centre took "
                                 f"no cotangent")
    if plan.has_image:
        d_atlas = got_pk[plan.size:]
        log(f"[{tag}] {name}: the texels' cotangent: {int((d_atlas != 0).sum())}"
            f" of {d_atlas.numel()} entries nonzero, max "
            f"{float(d_atlas.abs().max()):.3e} (plain "
            f"{float(want_pk[plan.size:].abs().max()):.3e})")
        if not bool((d_atlas != 0).any()):
            raise AssertionError(f"[{tag}] {name}: no texel took cotangent")
    if plan.n_beziers:
        # the ribbons' slots of dpk: the control points (B_CP .. B_CP + 11)
        # take cotangent, the width (B_W) enters a comparison only
        blocks = lambda x: x[plan.bez_base:plan.bez_base + plan.n_beziers
                             * bounce.BEZ_SIZE].reshape(-1, bounce.BEZ_SIZE)
        g_cp, w_cp = (blocks(x)[:, bounce.B_CP:bounce.B_CP + 12]
                      for x in (got_pk, want_pk))
        g_w = blocks(got_pk)[:, bounce.B_W]
        n_rib = int((ribbon_winners(plan, pk, *ins) & keep).sum())
        log(f"[{tag}] {name}: {n_rib} lanes end on a ribbon; dpk's B_CP "
            f"slots: {int((g_cp != 0).sum())} of {g_cp.numel()} nonzero, max "
            f"{float(g_cp.abs().max()):.3e} (plain "
            f"{float(w_cp.abs().max()):.3e}), max err "
            f"{float((g_cp - w_cp).abs().max()):.3e}; B_W slots max "
            f"{float(g_w.abs().max()):.1e} (plain "
            f"{float(blocks(want_pk)[:, bounce.B_W].abs().max()):.1e})")
        if not (n_rib and bool((g_cp != 0).any()) and not bool(g_w.any())):
            raise AssertionError(f"[{tag}] {name}: the control points took "
                                 f"no cotangent, or the width took some")
    log(f"[{tag}] {name}: m={M_BWD} P={plan.size}; lanes left "
        f"out (forward flips) {n_out}; lanes outside the bounds "
        f"{n_bad}, max abs err {max_err:.3e}; dpk slots outside "
        f"{pk_bad}, max err / max|dpk| {pk_err:.3e}; time cotangent max "
        f"{float(want[6].abs().max()):.3e}; two launches bitwise equal")
    if n_bad or pk_bad:
        raise AssertionError(f"[{tag}] {name}: {n_bad} lanes and "
                             f"{pk_bad} dpk slots outside the bounds")
    if not timed:
        return dict(name=name, max_abs_err=max_err)
    args = (plan, pk, *ins, *cts)
    k_wall = median_ms(lambda: bounce.step_cuda_bwd(*args))
    p_wall = median_ms(lambda: bounce.step_vjp(*args),
                       n=1 if plan.n_kleins else 2)
    # CUDA events around back-to-back calls, as for K1.  The wrapper
    # launches the kernel and the sum of its partials over the blocks: the
    # kernel's own time is the wrapper's less that of the same sum alone.
    k_all = kernel_ms(lambda: bounce.step_cuda_bwd(*args))
    partials = torch.empty(-(-M_BWD // 256), got_pk.numel(), dtype=dtype,
                           device=dev)
    k_ms = k_all - kernel_ms(lambda: partials.sum(dim=0))
    if plan.n_kleins:                 # some 50,000 launches: p_wall's call
        p_ms, p_launches = p_wall, float("nan")
    else:
        p_ms, p_launches = device_ms(lambda: bounce.step_vjp(*args), 1)
    b_ms, b_by = k2_bound(plan, pk, M_BWD, ins, fwd[1], kl_ops)
    log(f"[{tag}] {name}: device time per call: kernel "
        f"{k_ms:.4f} ms (CUDA events; with the partials' sum {k_all:.4f} "
        f"ms), plain "
        f"VJP {p_ms:.4f} ms ({p_launches:.0f} launches); elapsed per "
        f"call (median): kernel {k_wall:.4f} ms, plain {p_wall:.3f} ms; "
        f"f32 bound {b_ms * 1e3:.2f} us ({b_by})")
    return dict(name=name, max_abs_err=max_err, ms=k_ms, plain_ms=p_ms,
                wall_ms=k_wall, plain_wall_ms=p_wall, bound_ms=b_ms,
                bound_by=b_by)


def phase_kernel_bwd(dev):
    results = []
    cases = (("cornell-light", scenes.cornell_box, True),
             ("cornell-cosine", scenes.cornell_box, False),
             ("materials-light", scenes.cornell_materials, True))
    for dtype in (torch.float32, torch.float64):
        for case, spec_fn, ls in cases:
            scene, cam = cornell(dtype, dev, spec_fn)
            results.append(check_k2(
                "kernel-bwd", f"{dtype_name(dtype)}-{case}", scene, cam,
                FULL_BWD.replace(light_sampling=ls), dtype, dev))
    return results


def phase_kernel_bwd_spheres(dev):
    """K2 on the sphere scenes; the f64 launch on the RTOW scene is the
    P = 4,794 case, whose [warps, P] reduction would not fit a block's
    shared memory."""
    results = []
    for dtype in (torch.float32, torch.float64):
        for name in SPHERE_SCENES:
            scene, cam, box, atol = sphere_scene(name, dtype, dev)
            results.append(check_k2(
                "kernel-bwd-spheres", f"{dtype_name(dtype)}-{name}", scene,
                cam, RTOW, dtype, dev, box=box, atol=atol))
    return results


def check_golden(tag, scene, cam, cfg, golden):
    """An f32 render against an f64 oracle golden (a file, or the image
    itself) with the bounds of tests/test_parity.py; one kernel launch per
    pool iteration."""
    start = bounce.LAUNCHES
    mean, state = render.render_image(scene, cam, cfg)
    launches = bounce.LAUNCHES - start
    start = bounce.LAUNCHES
    state2, segs, iters = render.render_with_stats(
        scene, cam, cfg, render.init_state(cfg))
    launches2 = bounce.LAUNCHES - start
    if not (launches == launches2 == iters):
        raise AssertionError(f"[{tag}] launches {launches}/{launches2} != "
                             f"pool iterations {iters}")
    if not torch.equal(state.raw_sum, state2.raw_sum):
        raise AssertionError(f"[{tag}] two identical renders differ")
    ref = np.load(golden)["image"] if isinstance(golden, str) else golden
    img = mean.cpu().numpy().astype(np.float64)
    if img.shape != ref.shape or not np.isfinite(img).all():
        raise AssertionError(f"[{tag}] image shape or finiteness")
    diff = np.abs(img - ref)
    mae, outliers = diff.mean(), (diff.max(axis=-1) > 0.05).mean()
    log(f"[{tag}] {cfg.nx}x{cfg.ny} spp{cfg.spp} depth{cfg.max_depth}: "
        f"segments {int(segs)} iters {iters} "
        f"launches {launches}; MAE {mae:.3e} (< 5e-3), pixels off by > 0.05: "
        f"{outliers:.4%} (< 1%)")
    if not (mae < 5e-3 and outliers < 0.01):
        raise AssertionError(f"[{tag}] image outside the golden's bounds")


def phase_golden(dev):
    scene, cam = cornell(torch.float32, dev)
    check_golden("golden", scene, cam, CONFIG4, GOLDEN)


def spec_scene(spec, dtype, dev=None):
    """A SceneSpec compiled with its own sky; with no `dev` the scene and
    camera land on the card, the port's default."""
    scene = compile_scene(spec.objects, sky=spec.sky, dtype=dtype,
                          lights=spec.lights, device=dev)
    return scene, spec.camera(dtype=dtype, aspect=1.0, device=dev)


def phase_golden_spheres(dev):
    """Parity configs 1 and 2 against their goldens.  The scenes are
    compiled with no `device`: they must land on the card."""
    for name, spec, cfg in (
            ("config1_three_spheres", scenes.three_spheres(), CONFIG1),
            ("config2_rtow_final", scenes.random_scene(seed=0), CONFIG2)):
        scene, cam = spec_scene(spec, torch.float32)
        if scene.device.type != "cuda" or cam.lookfrom.device.type != "cuda":
            raise AssertionError("[golden-spheres] the default device is "
                                 "not the card")
        check_golden(f"golden-spheres {name}", scene, cam, cfg,
                     os.path.join(ROOT, "tests", "goldens", name + ".npz"))


def fwd_bwd(scene, cam, cfg, n_iters, params, rest, loss_fn):
    """One training step: render_diff_fused of `params`, the loss, and its
    gradient for every leaf (zeros where a leaf is unused)."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    raw, segs, leftover = diff_fused.render_diff_fused(
        build.combine(leaves, rest), cam, cfg, n_iters)
    loss = loss_fn(raw)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(leaves.items(), grads)}
    return raw.detach(), loss.detach(), segs, leftover, grads


def check_diff(tag, scene, cam, cfg):
    """The f32 differentiable render: drained, equal to the forward image
    bitwise, deterministic gradients, one backward launch per forward
    launch."""
    n_iters = diff_fused.calibrate_iters(scene, cam, cfg)
    params, rest = build.partition(scene)
    mean = lambda raw: raw.mean()
    bounce.LAUNCHES = bounce.BWD_LAUNCHES = 0
    raw, _, segs, leftover, grads = fwd_bwd(scene, cam, cfg, n_iters, params,
                                            rest, mean)
    torch.cuda.synchronize()
    launches, bwd_launches = bounce.LAUNCHES, bounce.BWD_LAUNCHES
    blocks = -(-n_iters // pool_fused.FLUSH_EVERY) * pool_fused.FLUSH_EVERY
    st, f_segs, _ = render.render_with_stats(
        scene, cam, cfg, render.init_state(cfg))
    same_image = torch.equal(raw, st.raw_sum.reshape(-1, 3))
    _, _, _, _, grads2 = fwd_bwd(scene, cam, cfg, n_iters, params, rest, mean)
    same_grads = all(torch.equal(grads[k], grads2[k]) for k in grads)
    finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
    log(f"[{tag}] {cfg.nx}x{cfg.ny} spp{cfg.spp} depth{cfg.max_depth} f32: "
        f"n_iters {n_iters} -> {blocks} pool "
        f"iterations; leftover {int(leftover)}; segments {int(segs)} "
        f"(forward {int(f_segs)}); launches forward {launches} backward "
        f"{bwd_launches}; image equal to the forward render bitwise: "
        f"{same_image}; two steps' gradients bitwise equal: {same_grads}; "
        f"finite: {finite}")
    if int(leftover) != 0 or int(segs) != int(f_segs):
        raise AssertionError(f"[{tag}] the queue did not drain")
    if not (launches == bwd_launches == blocks):
        raise AssertionError(f"[{tag}] launches {launches}/{bwd_launches} != "
                             f"{blocks} pool iterations")
    if not (same_image and same_grads and finite):
        raise AssertionError(f"[{tag}] image, determinism or finiteness")
    return n_iters


def check_fd(tag, scene, cam, cfg, probes, eps, window=None):
    """f64: the AD gradient of the mean image (over `window`'s rows and
    columns, if given) against central finite differences, per probe
    (leaf, index); returns {probe: (AD, FD)}."""
    n_iters = diff_fused.calibrate_iters(scene, cam, cfg)
    params, rest = build.partition(scene)

    def loss_fn(raw):
        img = raw.reshape(cfg.ny, cfg.nx, 3)
        if window is not None:
            img = img[window[0]:window[1], window[2]:window[3]]
        return img.mean()

    _, _, _, leftover, grads = fwd_bwd(scene, cam, cfg, n_iters, params, rest,
                                       loss_fn)
    if int(leftover) != 0:
        raise AssertionError(f"[{tag}] the f64 render did not drain")
    out = {}
    for leaf, idx in probes:
        def loss_at(x):
            p = dict(params)
            p[leaf] = params[leaf].clone()
            p[leaf][idx] += x
            with torch.no_grad():
                raw, _, lo = diff_fused.render_diff_fused(
                    build.combine(p, rest), cam, cfg, n_iters)
            if int(lo) != 0:
                raise AssertionError(f"[{tag}] an FD render did not drain")
            return float(loss_fn(raw))
        ad = float(grads[leaf][idx])
        fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
        out[leaf] = (ad, fd)
        log(f"[{tag}] f64 {cfg.nx}x{cfg.ny} spp{cfg.spp} "
            f"depth{cfg.max_depth} d mean(image) / d {leaf}{list(idx)}: AD "
            f"{ad:.8e}, central FD (eps {eps:g}) {fd:.8e}, rel diff "
            f"{abs(ad - fd) / max(abs(fd), 1e-30):.3e}")
    return out


def phase_diff(dev):
    """The differentiable render at config 4's size: drained, equal to the
    forward image, deterministic, one backward launch per forward launch;
    in float64 the AD gradient against central finite differences."""
    scene, cam = cornell(torch.float32, dev)
    n_iters = check_diff("diff", scene, cam, CONFIG4)
    scene, cam = cornell(torch.float64, dev)
    out = check_fd("diff", scene, cam, CONFIG4.replace(dtype="f64"),
                   (("tex_color", (0, 0)), ("rect_k", (0,))), 1e-2)
    ad, fd = out["tex_color"]
    if not abs(ad - fd) < 0.01 * abs(fd):
        raise AssertionError("[diff] f64 tex_color AD not within 1% of FD")
    return dict(n_iters=n_iters)


def phase_diff_spheres(dev):
    """The differentiable render of three_spheres at config 1's size, and
    in float64 config 1's probes (a centre component, the radius, an
    albedo of the centre sphere) against finite differences on FD_CFG."""
    scene, cam = spec_scene(scenes.three_spheres(), torch.float32, dev)
    check_diff("diff-spheres", scene, cam, CONFIG1)
    scene, cam = spec_scene(scenes.three_spheres(), torch.float64, dev)
    out = check_fd("diff-spheres", scene, cam, FD_CFG,
                   (("sph_c0", (1, 1)), ("sph_r", (1,)),
                    ("tex_color", (1, 0))), 1e-4, FD_WINDOW)
    for leaf, (ad, fd) in out.items():
        if not abs(ad - fd) < 0.01 * abs(fd):
            raise AssertionError(f"[diff-spheres] f64 {leaf} AD not within "
                                 f"1% of FD")


N_TIMED = 3         # chained timed renders or steps after the warm-up


def run_full(tag, what, scene, cam, cfg, n_timed=N_TIMED):
    """The forward main path through render_with_stats (the FIFO pool, K1):
    one warm-up render from zeros, then n_timed chained renders.  Sets
    bounce.LAUNCHES to 0 just before and reads it just after."""
    bounce.LAUNCHES = 0                       # the main path's count starts
    total_iters = 0
    t0 = time.perf_counter()
    st, segs, iters = render.render_with_stats(
        scene, cam, cfg, render.init_state(cfg))
    float(st.raw_sum[0, 0, 0])
    warm = time.perf_counter() - t0
    total_iters += iters
    # the warm-up render (sample_base 0, from zeros): the strided pools'
    # reference
    first = dict(image=st.raw_sum.reshape(-1, 3).clone(), segments=int(segs),
                 iters=iters)
    times = []
    for _ in range(n_timed):
        t0 = time.perf_counter()
        st, segs, iters = render.render_with_stats(scene, cam, cfg, st)
        float(st.raw_sum[0, 0, 0])
        times.append(time.perf_counter() - t0)
        total_iters += iters
    launches = bounce.LAUNCHES
    segs = int(segs)
    med = statistics.median(times)
    mean = (st.raw_sum / st.sample_count.to(torch.float32)).cpu().numpy()
    log(f"[{tag}] {cfg.nx}x{cfg.ny} spp{cfg.spp} depth{cfg.max_depth} "
        f"{what}: m={cfg.resolve_pool_rays()} warm-up segments "
        f"{first['segments']} in {first['iters']} iterations; last render "
        f"segments {segs} iters {iters}; warm-up {warm * 1e3:.1f} ms; "
        f"times_ms {[round(t * 1e3, 2) for t in times]}; {spread(times)} "
        f"-> {segs / med:.4e} rays/s; launches "
        f"{launches} over {n_timed + 1} renders")
    if launches != total_iters or launches == 0:
        raise AssertionError(f"[{tag}] launches {launches} != pool iterations "
                             f"{total_iters}")
    if not np.isfinite(mean).all() or mean.max() <= 0.0:
        raise AssertionError(f"[{tag}] frame is not finite or is black")
    log(f"[{tag}] frame mean {mean.mean():.4f} max {mean.max():.3f}")
    return dict(segments=segs, iters=iters, median_s=med, launches=launches,
                first=first)


def phase_full(dev):
    scene, cam = cornell(torch.float32, dev)
    full = run_full("full", "light-sampled", scene, cam, FULL)
    # the count PERF.md records for this render since the port began
    log(f"[full] Cornell warm-up render: {full['first']['segments']} segments "
        f"in {full['first']['iters']} FIFO iterations (recorded: 11646756 in "
        f"224)")
    return full


def log_profile(tag, wall_ms, table, ours=()):
    """The device-time breakdown of one profiled run; returns the busy
    share (None when the profiler recorded no device time)."""
    if not table:
        log(f"[{tag}] the profiler recorded no device time: not measured")
        return None
    busy_ms = sum(us for us, _ in table.values()) / 1e3
    rows = sorted(((us, k, name) for name, (us, k) in table.items()),
                  reverse=True)
    log(f"[{tag}] one run: {wall_ms:.1f} ms wall under the profiler, "
        f"device busy {busy_ms:.2f} ms ({busy_ms / wall_ms:.1%}), "
        f"{sum(k for _, k, _ in rows):.0f} kernel launches")
    for us, k, name in rows[:8]:
        log(f"[{tag}]   {us / 1e3:8.3f} ms {k:6.0f} x  {name[:90]}")
    for us, k, name in rows:
        if any(o in name for o in ours):
            log(f"[{tag}]   ours: {us / 1e3:8.3f} ms {k:6.0f} x "
                f"{us / k:8.2f} us each  {name[:70]}")
    return busy_ms / wall_ms


def profile_render(tag, scene, cam, cfg):
    """One forward render under torch.profiler: device time by kernel and
    the card's busy share of the render's wall time."""
    st = render.init_state(cfg)
    wall_ms, table = device_kernels(
        lambda: render.render_with_stats(scene, cam, cfg, st))
    return log_profile(tag, wall_ms, table, ours=("bounce_step",))


def phase_profile(dev):
    scene, cam = cornell(torch.float32, dev)
    profile_render("profile", scene, cam, FULL)


def run_full_bwd(tag, what, scene, cam, cfg, n_timed=N_TIMED,
                 recalibrate=False):
    """fwd+bwd steps as bench.py:_measure_fwd_bwd times them: calibration,
    a warm-up, then n_timed steps chained by params -= 1e-6 grad; the counts
    are set to 0 just before and read just after.  Then one step under
    torch.profiler.  `recalibrate` (the klein scenes): each timed step's
    trip count is calibrated again, outside its timed window, on the moved
    parameters: a klein path re-hits the fractal up to the depth cap
    (ROADMAP C.6), so the drain's tail moves with any change of the scene,
    beyond the 10% slack; those calibrations' forward launches are counted
    on the path and expected."""
    t0 = time.perf_counter()
    n_iters = diff_fused.calibrate_iters(scene, cam, cfg, slack=1.1)
    calib = time.perf_counter() - t0
    params, rest = build.partition(scene)
    loss_fn = lambda raw: (raw ** 2).sum() / raw.numel()
    bounce.LAUNCHES = bounce.BWD_LAUNCHES = 0  # the main path's count starts
    t0 = time.perf_counter()
    _, loss, segs, leftover, grads = fwd_bwd(scene, cam, cfg, n_iters,
                                             params, rest, loss_fn)
    float(loss)
    warm = time.perf_counter() - t0
    if int(leftover) != 0:
        raise AssertionError(f"[{tag}] warm-up did not drain")
    torch.cuda.reset_peak_memory_stats()
    times = []
    block = lambda n: -(-n // pool_fused.FLUSH_EVERY) * pool_fused.FLUSH_EVERY
    blocks, calib_launches = block(n_iters), 0
    for _ in range(n_timed):
        params = {k: v - 1e-6 * grads[k] for k, v in params.items()}
        if recalibrate:
            before = bounce.LAUNCHES
            n_iters = diff_fused.calibrate_iters(build.combine(params, rest),
                                                 cam, cfg, slack=1.1)
            calib_launches += bounce.LAUNCHES - before
        blocks += block(n_iters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, loss, segs, leftover, grads = fwd_bwd(scene, cam, cfg, n_iters,
                                                 params, rest, loss_fn)
        torch.cuda.synchronize()
        float(loss)
        times.append(time.perf_counter() - t0)
        if int(leftover) != 0:
            raise AssertionError(f"[{tag}] a timed step did not drain")
    launches, bwd_launches = bounce.LAUNCHES, bounce.BWD_LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    segs = int(segs)
    med = statistics.median(times)
    steps = n_timed + 1
    log(f"[{tag}] {cfg.nx}x{cfg.ny} spp{cfg.spp} depth{cfg.max_depth} "
        f"{what} f32: m={cfg.resolve_pool_rays(reverse=True)} "
        f"n_iters {n_iters} (calibration {calib * 1e3:.1f} ms) -> "
        f"{block(n_iters)} pool iterations (the last step; {blocks} over the "
        f"{steps} steps, {calib_launches} forward launches recalibrating); "
        f"segments {segs}; warm-up {warm * 1e3:.1f} ms; "
        f"times_ms {[round(t * 1e3, 2) for t in times]}; {spread(times)} "
        f"-> {segs / med:.4e} fwd+bwd rays/s; peak memory "
        f"{peak / 2 ** 30:.3f} GiB; launches forward {launches} backward "
        f"{bwd_launches} over {steps} steps")
    if not (launches - calib_launches == bwd_launches == blocks):
        raise AssertionError(f"[{tag}] launches {launches}/{bwd_launches}"
                             f" != {blocks} (+ {calib_launches} "
                             f"recalibrating)")
    if not all(bool(torch.isfinite(g).all()) for g in grads.values()):
        raise AssertionError(f"[{tag}] gradients are not finite")
    touched = sorted(k for k, g in grads.items() if bool((g != 0).any()))
    log(f"[{tag}] every float leaf's gradient finite; nonzero for {touched}")
    wall_ms, table = device_kernels(lambda: fwd_bwd(
        scene, cam, cfg, n_iters, params, rest, loss_fn))
    log_profile(tag, wall_ms, table, ours=("bounce_step",))
    return dict(segments=segs, median_s=med, launches=launches,
                bwd_launches=bwd_launches, peak=peak, iters=block(n_iters),
                touched=set(touched),
                step=lambda: fwd_bwd(scene, cam, cfg, n_iters, params, rest,
                                     loss_fn))


def phase_full_bwd(dev):
    """512^2 spp8 fwd+bwd steps of the light-sampled Cornell box."""
    scene, cam = cornell(torch.float32, dev)
    return run_full_bwd("full-bwd", "light-sampled", scene, cam, FULL_BWD)


# --- the strided work pools (K3, K4) and the probes (K5, K6) ------------


def packed_state(m, n_work, max_depth, device, seed=0, box=None, aim=None):
    """A numpy-seeded packed pool state ([N_PACKED, m] float32): items in
    [0, 1.1 n_work) (some lanes drained), fresh lanes, depths with some at
    the cap, origins inside the box, unit directions, nonzero radiance and
    throughput (tests/test_torch_cuda.py's kind).  `box` (lo, hi) scales the
    origins to a sphere scene and draws the times in [0, 1); `aim` (lo, hi)
    points every direction at a random point of that box (lane_inputs)."""
    r = np.random.default_rng(seed)
    st = np.zeros((bounce.N_PACKED, m), np.float32)
    ints = st.view(np.int32)
    ints[0] = r.integers(0, n_work + n_work // 10, m)
    st[1] = r.random(m) < 0.3
    ints[2] = r.integers(0, 4, m)
    ints[2][r.random(m) < 0.05] = max_depth
    st[3:6] = r.random((3, m)) * 500.0
    dvec = r.normal(size=(3, m))
    st[6:9] = dvec / np.linalg.norm(dvec, axis=0, keepdims=True)
    st[10:13] = r.random((3, m))
    st[13:16] = r.uniform(0.1, 1.0, (3, m))
    if box is not None:
        lo, hi = (np.asarray(b, np.float32)[:, None] for b in box)
        st[3:6] = lo + st[3:6] / 500.0 * (hi - lo)
        st[9] = r.random(m)
    if aim is not None:
        lo, hi = (np.asarray(b, np.float32)[:, None] for b in aim)
        dvec = lo + r.random((3, m)) * (hi - lo) - st[3:6]
        st[6:9] = dvec / np.linalg.norm(dvec, axis=0, keepdims=True)
    return torch.tensor(st, device=device)


def packed_setup(dev, scene=None, cam=None, cfg=FULL):
    """The f32 plan and pk of a full-size render (the 512^2 spp16 Cornell
    box unless a scene is given), its strided queue at the forward pool's
    width, and a sample base on the card."""
    if scene is None:
        scene, cam = cornell(torch.float32, dev)
    plan = bounce.pool_plan(scene, cfg)
    pk = bounce.pack(scene, cam, plan, torch.float32)
    n_pix = cfg.n_pixels
    q = dict(m=M, n_work=n_pix * cfg.spp, n_pix=n_pix, pix0=0,
             total_pix=n_pix)
    return plan, pk, q, torch.tensor([5], dtype=torch.int32, device=dev)


def packed_disagreeing(got, want, atol=F32_TOL["atol"]):
    """Lanes where an int row, the fresh row or a float row (outside
    F32_TOL's rtol and `atol`) differs, or the result is not finite."""
    g_i, w_i = got.view(torch.int32), want.view(torch.int32)
    off = ((got[3:] - want[3:]).abs()
           > atol + F32_TOL["rtol"] * want[3:].abs()).any(0)
    return (off | (g_i[0] != w_i[0]) | (got[1] != want[1])
            | (g_i[2] != w_i[2]) | ~torch.isfinite(got[3:]).all(0))


def device_ms(fn, n):
    """Device time per call of fn() (torch.profiler, n calls), summed over
    its kernels; with the launch count per call.  For the plain versions:
    the profiler can miss device events of a short window (on an H100 it
    has recorded 7 of 10 K4 launches, 15 or none of 20 K3 launches), so
    the kernels' own times come from kernel_ms."""
    _, tab = device_kernels(fn, n=n, host_ops=False)
    return (sum(us for us, _ in tab.values()) / 1e3,
            sum(k for _, k in tab.values()))


def kernel_ms(fn, n=20):
    """Device time per fn() call, from CUDA events: a sleep kernel holds
    the stream while the host queues n calls, so the calls run back to
    back, with no host time between them; the event at the sleep's end and
    one after the last call give their time, divided by n.  The sleep must
    outlast the queueing (with a margin); it is doubled until it does."""
    fn()
    torch.cuda.synchronize()
    cycles = 10 ** 8                  # about 50 ms at the H100's clock
    for _ in range(4):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        ev[2].record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if host_ms < 0.8 * ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / n
        cycles *= 2
    raise AssertionError("kernel_ms: the host queued slower than the sleep")


class KernelEvents:
    """Inside the block, a CUDA event pair around every launch of the four
    bounce kernels (the ctypes call itself, so K2's time is without the sum
    of its partials): `totals()` gives {kernel: (device ms, launches)}.  The
    wrappers' library getters are replaced for the block and put back."""

    GETTERS = ((bounce, "_kernel", K1), (bounce, "_kernel_bwd", K2),
               (bounce, "_kernel_packed", K3), (persist, "_kernel", K4))

    def __enter__(self):
        self.pairs = {}
        self.saved = [getattr(mod, attr) for mod, attr, _ in self.GETTERS]
        for (mod, attr, name), getter in zip(self.GETTERS, self.saved):
            setattr(mod, attr, self._timing(getter, name))
        return self

    def _timing(self, getter, name):
        def get(plan):
            fn = getter(plan)

            def call(*args):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                err = fn(*args)
                e1.record()
                self.pairs.setdefault(name, []).append((e0, e1))
                return err
            return call
        return get

    def __exit__(self, *exc):
        for (mod, attr, _), getter in zip(self.GETTERS, self.saved):
            setattr(mod, attr, getter)

    def totals(self):
        torch.cuda.synchronize()
        return {name: (sum(a.elapsed_time(b) for a, b in pairs), len(pairs))
                for name, pairs in self.pairs.items()}


def log_kernel_events(tag, what, fn):
    """One run of fn() with every bounce kernel launch timed by CUDA events:
    logs and returns {kernel: (device ms, launches)}."""
    with KernelEvents() as ev:
        fn()
        totals = ev.totals()
    log(f"[{tag}] {what}: our kernels' device time in one run, by CUDA events "
        f"around every launch: "
        + "; ".join(f"{name} {ms:.3f} ms in {k} launches "
                    f"({ms / k * 1e3:.2f} us each)"
                    for name, (ms, k) in totals.items()))
    return totals


def packed_lanes(plan, sb, state, q):
    """The step's inputs of the lanes of a packed state (step_packed's)."""
    st_i = state.view(torch.int32)
    alive = st_i[0] < q["n_work"]
    gitem, px, py, _ = bounce.strided_item(
        st_i[0].to(torch.int64), sb.to(torch.int64)[0], q["n_pix"], q["pix0"],
        q["total_pix"], plan.nx, torch.float32)
    return (gitem, px, py, (state[1] != 0.0) & alive, alive, st_i[2],
            tuple(state[3:6]), tuple(state[6:9]), state[9])


def packed_texture_ops(plan, pk, sb, state, q, klein=True):
    """`texture_ops`, `bezier_ops` and (with `klein`) `klein_ops` of one
    strided-pool iteration from a packed state."""
    alive = state.view(torch.int32)[0] < q["n_work"]
    if not (plan.n_media or plan.has_perlin or (klein and plan.n_kleins)):
        return bezier_ops(plan, alive)
    ins = packed_lanes(plan, sb, state, q)
    ops = bezier_ops(plan, alive) + texture_ops(plan, pk, *ins)
    if klein and plan.n_kleins:
        ops += klein_ops(plan, pk, ins, KLEIN_NORMAL_OPS)[1]
    return ops


def packed_bound(plan, q, state, T=1, segs=None, tex_ops=0):
    """K3 (T = 1) and K4 in f32: the 16 state words in and out, pk and the
    texels once, and per iteration K4's 4 flush words; only live lanes are
    traced (the count of each iteration for K4, `segs`); `tex_ops` are the
    media's and Perlin textures' operations (packed_texture_ops, summed over
    the chunk's iterations for K4)."""
    m = q["m"]
    live = int((state.view(torch.int32)[0] < q["n_work"]).sum())
    traced = live if segs is None else int(segs.sum())
    fresh = int(((state[1] != 0.0)
                 & (state.view(torch.int32)[0] < q["n_work"])).sum())
    flops = (traced * (sweep_flops(plan) + SHADE_FLOPS)
             + fresh * CAMERA_FLOPS + tex_ops)
    n_bytes = m * 2 * bounce.N_PACKED * 4 + scene_bytes(plan) + 4
    if segs is not None:
        n_bytes += T * (4 * m * 4 + 4)
    return bound(n_bytes, flops)


def check_k3(tag, setup, state, atol=F32_TOL["atol"]):
    plan, pk, q, sb = setup
    want = bounce.step_packed(plan, pk, sb, state, **q)
    got = bounce.step_packed_cuda(plan, pk, sb, state, **q)
    again = bounce.step_packed_cuda(plan, pk, sb, state, **q)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise AssertionError(f"[{tag}] two launches differ")
    bad = packed_disagreeing(got, want, atol)
    n_bad = int(bad.sum())
    max_err = float((got[3:] - want[3:]).abs()[:, ~bad].max())
    k_ms = kernel_ms(lambda: bounce.step_packed_cuda(plan, pk, sb, state,
                                                     **q))
    k_wall = median_ms(lambda: bounce.step_packed_cuda(plan, pk, sb, state,
                                                       **q))
    plain = lambda: bounce.step_packed(plan, pk, sb, state, **q)
    if plan.n_kleins:                 # some 46,000 launches: p_wall's call
        p_wall = median_ms(plain, n=1)
        p_ms, p_launches = p_wall, float("nan")
    else:
        p_ms, p_launches = device_ms(plain, 3)
        p_wall = median_ms(plain, n=3)
    live = int((state.view(torch.int32)[0] < q["n_work"]).sum())
    b_ms, b_by = packed_bound(plan, q, state, tex_ops=packed_texture_ops(
        plan, pk, sb, state, q))
    log(f"[{tag}] K3 f32 m={M} P={plan.size} ({live} live lanes): kernel vs "
        f"plain step_packed: lanes disagreeing {n_bad} (an int row, fresh, "
        f"or a float row outside rtol {F32_TOL['rtol']:g} atol "
        f"{atol:.3g}); max abs err on the other lanes "
        f"{max_err:.3e}; two launches bitwise equal")
    log(f"[{tag}] K3 device time per call: kernel {k_ms:.4f} ms, plain "
        f"{p_ms:.4f} ms ({p_launches:.0f} launches); elapsed per call "
        f"(median): kernel {k_wall:.4f} ms, plain {p_wall:.3f} ms; bound "
        f"{b_ms * 1e3:.2f} us ({b_by})")
    if n_bad > MAX_FLIP_FRAC * M:
        raise AssertionError(f"[{tag}] {n_bad} lanes disagree")
    return dict(max_abs_err=max_err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by)


def phase_packed_kernel(dev):
    setup = packed_setup(dev)
    plan, _, q, _ = setup
    return check_k3("packed-kernel", setup,
                    packed_state(M, q["n_work"], plan.max_depth, dev))


def k3_chunk(plan, pk, sb, state, q, T):
    """T K3 launches from `state`, with the flush rows and segment counts
    the persistent kernel writes, derived on the card; and the chunk's
    packed_texture_ops, summed over its iterations (the klein march's over
    all T iterations' lanes at once: one plain march of T m lanes)."""
    flush = torch.empty(T, 4, q["m"], dtype=torch.float32, device=state.device)
    segs = torch.empty(T, dtype=torch.int32, device=state.device)
    tex_ops, states = 0, []
    for t in range(T):
        item = state.view(torch.int32)[0]
        segs[t] = (item < q["n_work"]).sum()
        tex_ops += packed_texture_ops(plan, pk, sb, state, q, klein=False)
        states.append(state)
        state = bounce.step_packed_cuda(plan, pk, sb, state, **q)
        done = state[1] != 0.0
        flush.view(torch.int32)[t, 0] = torch.where(done, item % q["n_pix"],
                                                    -1)
        flush[t, 1:] = torch.where(done, state[10:13], 0.0)
    if plan.n_kleins:
        tex_ops += klein_ops(plan, pk, packed_lanes(
            plan, sb, torch.cat(states, 1), q), KLEIN_NORMAL_OPS)[1]
    return (state, flush, segs), tex_ops


def check_k4(tag, setup, state, atol=F32_TOL["atol"], chunk_ts=CHUNK_TS,
             plain_events=False):
    """One K4 chunk bitwise against CHUNK_T K3 launches, K4 against
    chunk_plain, and times.  `plain_events`: the plain chunk is timed by a
    CUDA event pair around one call (its host syncs included) instead of
    the profiler, whose per-event cost is minutes for the klein march's
    hundreds of thousands of launches; its launches are then not
    counted."""
    plan, pk, q, sb = setup
    T = persist.CHUNK_T
    got = persist.chunk_cuda(plan, pk, sb, state, T=T, **q)
    want, tex_ops = k3_chunk(plan, pk, sb, state, q, T)
    torch.cuda.synchronize()
    same = [torch.equal(g.view(torch.int32) if g.is_floating_point() else g,
                        w.view(torch.int32) if w.is_floating_point() else w)
            for g, w in zip(got, want)]
    log(f"[{tag}] one K4 chunk of T={T} against {T} K3 launches "
        f"from the same state: state, flush rows, segments bitwise equal: "
        f"{same}; segments {int(got[2].sum())}")
    if not all(same):
        raise AssertionError(f"[{tag}] K4 differs from K3 launches")
    # against the plain chunk at T = 4.  Each iteration is held on its own:
    # one K4 iteration from each state of the plain chain, within F32_TOL on
    # all but 0.1% of the lanes (f32 flips), as K1 and K3 are.  The chained
    # comparison (K4 over 4 iterations against the plain chain) is logged:
    # there the f32 rounding differences of each bounce compound.
    Tp = 4
    chain, n_bad, max_err = state, [], 0.0
    w_rows = []
    for t in range(Tp):
        w_st, w_fl, w_sg = persist.chunk_plain(plan, pk, sb, chain, T=1, **q)
        g_st, g_fl, g_sg = persist.chunk_cuda(plan, pk, sb, chain, T=1, **q)
        bad = (packed_disagreeing(g_st, w_st, atol)
               | (g_fl[0, 0].view(torch.int32) != w_fl[0, 0].view(torch.int32))
               | ((g_fl[0, 1:] - w_fl[0, 1:]).abs() > atol
                  + F32_TOL["rtol"] * w_fl[0, 1:].abs()).any(0)
               | (g_sg != w_sg).any())
        n_bad.append(int(bad.sum()))
        max_err = max(max_err, float((g_st[3:] - w_st[3:]).abs()[:, ~bad]
                                     .max()))
        w_rows.append(w_fl[0])
        chain = w_st
    g_st, g_fl, _ = persist.chunk_cuda(plan, pk, sb, state, T=Tp, **q)
    ints = ((g_st.view(torch.int32)[0] != chain.view(torch.int32)[0])
            | (g_st[1] != chain[1])
            | (g_st.view(torch.int32)[2] != chain.view(torch.int32)[2]))
    for t in range(Tp):
        ints |= (g_fl[t, 0].view(torch.int32)
                 != w_rows[t][0].view(torch.int32))
    off = packed_disagreeing(g_st, chain, atol)
    log(f"[{tag}] K4 vs chunk_plain, one iteration from each of "
        f"the plain chain's {Tp} states: lanes disagreeing {n_bad} (bound "
        f"{MAX_FLIP_FRAC * M:g} each); max abs err on the other lanes "
        f"{max_err:.3e}")
    log(f"[{tag}] K4 over {Tp} chained iterations against the "
        f"plain chain: lanes off F32_TOL {int(off.sum())}, of which item, "
        f"fresh, depth or a flushed pixel differ on {int(ints.sum())} (the "
        f"f32 differences of each bounce compound along the chain)")
    if max(n_bad) > MAX_FLIP_FRAC * M:
        raise AssertionError(f"[{tag}] {n_bad} lanes disagree")
    # device time per chunk at several chunk lengths (CHUNK_T stays 32)
    per_t = {}
    for t_len in sorted(set(chunk_ts) | {T}):
        per_t[t_len] = kernel_ms(lambda: persist.chunk_cuda(
            plan, pk, sb, state, T=t_len, **q), 10)
    k_ms = per_t[T]
    plain = lambda: persist.chunk_plain(plan, pk, sb, state, T=T, **q)
    if plain_events:                  # the chunk_plain calls above warmed it
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        plain()
        e1.record()
        e1.synchronize()
        p_ms, p_launches = e0.elapsed_time(e1), float("nan")
    else:
        p_ms, p_launches = device_ms(plain, 1)
    k3_ms = kernel_ms(lambda: bounce.step_packed_cuda(plan, pk, sb, state,
                                                      **q))
    log(f"[{tag}] device time per chunk: "
        + ", ".join(f"T={t} {ms:.4f} ms ({ms / t * 1e3:.2f} us/iteration)"
                    for t, ms in per_t.items())
        + f"; one K3 launch {k3_ms * 1e3:.2f} us; plain chunk_plain T={T} "
        f"{p_ms:.3f} ms ({p_launches:.0f} launches)")
    b_ms, b_by = packed_bound(plan, q, state, T, got[2], tex_ops)
    log(f"[{tag}] K4 bound for this chunk of T={T}: {b_ms * 1e3:.2f} us "
        f"({b_by})")
    return dict(max_abs_err=max_err, ms=k_ms, plain_ms=p_ms, per_t=per_t,
                bound_ms=b_ms, bound_by=b_by)


def phase_persist_kernel(dev):
    setup = packed_setup(dev)
    plan, _, q, _ = setup
    return check_k4("persist-kernel", setup,
                    packed_state(M, q["n_work"], plan.max_depth, dev, seed=1))


def phase_packed_spheres(dev):
    """K3 against step_packed, and one K4 chunk bitwise equal to 32 K3
    launches, on the RTOW final scene's packed states."""
    scene, cam, box, atol = sphere_scene("rtow", torch.float32, dev)
    setup = packed_setup(dev, scene, cam, RTOW)
    plan, _, q, _ = setup
    k3 = check_k3("packed-spheres", setup, packed_state(
        M, q["n_work"], plan.max_depth, dev, box=box), atol)
    k4 = check_k4("persist-spheres", setup, packed_state(
        M, q["n_work"], plan.max_depth, dev, seed=1, box=box), atol,
        chunk_ts=())
    return k3, k4


POOLS = (("strided", pool_strided.render_pool_strided, "LAUNCHES"),
         ("packed", pool_packed.render_pool_packed, "PACKED_LAUNCHES"),
         ("persistent", persist.render_pool_persistent, "PERSIST_LAUNCHES"))


def launch_counts():
    return dict(LAUNCHES=bounce.LAUNCHES,
                PACKED_LAUNCHES=bounce.PACKED_LAUNCHES,
                PERSIST_LAUNCHES=persist.PERSIST_LAUNCHES)


def reset_counts():
    bounce.LAUNCHES = bounce.PACKED_LAUNCHES = 0
    persist.PERSIST_LAUNCHES = 0


def run_pools(tag, pools, scene, cam, cfg, full, dev, n_timed=N_TIMED):
    """Strided pools at full size, each through its entry point with the
    counts reset just before: one warm-up render from zeros, then n_timed
    chained renders, timed as run_full times the FIFO pool (`full`, whose
    segments and warm-up image each must give)."""
    ref, ref_segs = full["first"]["image"], full["first"]["segments"]
    raw0 = torch.zeros(cfg.n_pixels, 3, device=dev)
    results = {}
    for name, fn, count in pools:
        reset_counts()
        t0 = time.perf_counter()
        raw, segs, iters = fn(scene, cam, cfg, raw0, 0)
        float(raw[0, 0])
        warm = time.perf_counter() - t0
        first_raw, first_segs, first_iters = raw, int(segs), iters
        total_iters, times, base = iters, [], 0
        for _ in range(n_timed):
            base += cfg.spp
            t0 = time.perf_counter()
            raw, segs, iters = fn(scene, cam, cfg, raw, base)
            float(raw[0, 0])
            times.append(time.perf_counter() - t0)
            total_iters += iters
        counts = launch_counts()
        segs = int(segs)
        med = statistics.median(times)
        launches = {k: v for k, v in counts.items() if v}
        log(f"[{tag}] {name}: m={M} segments {first_segs} (FIFO "
            f"{ref_segs}) in {first_iters} iterations (FIFO "
            f"{full['first']['iters']}); last render {segs} segments in {iters} "
            f"iterations; warm-up {warm * 1e3:.1f} ms; times_ms "
            f"{[round(t * 1e3, 2) for t in times]}; {spread(times)} "
            f"-> {segs / med:.4e} rays/s; launches over {n_timed + 1} renders "
            f"{launches}")
        expect = total_iters // (persist.CHUNK_T if name == "persistent"
                                 else 1)
        if counts[count] != expect or set(launches) != {count}:
            raise AssertionError(f"[{tag}] {name}: launches {launches},"
                                 f" expected {count} = {expect}")
        if first_segs != ref_segs or segs != full["segments"]:
            raise AssertionError(f"[{tag}] {name}: segments "
                                 f"{first_segs}/{segs} != FIFO "
                                 f"{ref_segs}/{full['segments']}")
        err = (first_raw - ref).abs()
        lim = 1e-5 * float(ref.abs().max()) + 1e-5 * ref.abs()
        n_out = int((err > lim).sum())
        rel = float((err / ref.abs().clamp(min=1e-30)).max())
        log(f"[{tag}] {name}: warm-up image against the FIFO pool's: "
            f"max abs err {float(err.max()):.3e}, max rel err {rel:.3e}, "
            f"entries outside rtol 1e-5 / atol 1e-5 max|ref|: {n_out}")
        if n_out or not torch.isfinite(first_raw).all():
            raise AssertionError(f"[{tag}] {name}: image off the FIFO "
                                 f"pool's")
        results[name] = dict(segments=segs, iters=iters, median_s=med,
                             launches=counts[count], image=first_raw)
    # reproducible on the card: a second persistent render, bitwise
    again, _, _ = persist.render_pool_persistent(scene, cam, cfg, raw0, 0)
    same = torch.equal(again, results["persistent"]["image"])
    same_sp = all(torch.equal(r["image"], results["persistent"]["image"])
                  for r in results.values())
    log(f"[{tag}] two persistent renders bitwise equal: {same}; the "
        f"{len(results)} strided pools' images bitwise equal: {same_sp}")
    if not same:
        raise AssertionError(f"[{tag}] two persistent renders differ")
    for name, fn, _ in pools:
        st_raw = torch.zeros(cfg.n_pixels, 3, device=dev)
        wall_ms, table = device_kernels(lambda: fn(scene, cam, cfg, st_raw,
                                                   0))
        if not table:
            log(f"[{tag}] {name}: the profiler recorded no device time: "
                f"not measured")
            continue
        busy_ms = sum(us for us, _ in table.values()) / 1e3
        rows = sorted(((us, k, n_) for n_, (us, k) in table.items()),
                      reverse=True)
        log(f"[{tag}] {name} profile: {wall_ms:.1f} ms wall under the "
            f"profiler, device busy {busy_ms:.2f} ms ({busy_ms / wall_ms:.1%})"
            f", {sum(k for _, k, _ in rows):.0f} kernel launches")
        for us, k, n_ in rows[:8]:
            log(f"[{tag}]   {us / 1e3:8.3f} ms {k:6.0f} x  {n_[:90]}")
        results[name]["busy"] = busy_ms / wall_ms
    return results


def phase_pools_full(dev, full):
    """The three strided pools on the 512^2 spp16 Cornell box."""
    scene, cam = cornell(torch.float32, dev)
    return run_pools("pools-full", POOLS, scene, cam, FULL, full, dev)


def phase_full_spheres(dev):
    """The sphere slice at full width: the RTOW final scene (227 spheres,
    most of them moving) at 512^2 spp8 depth 100, forward through
    render_with_stats (the FIFO pool, K1) and through the persistent pool
    (K4) with equal segment counts, and the fwd+bwd step through
    render_diff_fused (K1 and K2)."""
    scene, cam = spec_scene(scenes.random_scene(seed=0), torch.float32, dev)
    full = run_full("full-spheres", "RTOW final scene, 227 spheres", scene,
                    cam, RTOW)
    profile_render("full-spheres", scene, cam, RTOW)
    pools = run_pools("full-spheres", POOLS[2:], scene, cam, RTOW, full, dev)
    full_bwd = run_full_bwd("full-spheres-bwd", "RTOW final scene", scene,
                            cam, RTOW)
    return full, pools["persistent"], full_bwd


# name -> (spec, light sampling, the box the lane origins are drawn from;
# None: Cornell's cube): textured_scene (checker, marble, image and noise
# spheres on a radius-100 ground), test_scene2 (marble ground of radius 1000
# and sphere, two emitters) and cornell_smoke (two constant media)
TEXTURE_SCENES = {
    "textured": (scenes.textured_scene, False, ((-2, -0.4, -3), (2, 1.5, 2))),
    "simple_light": (scenes.test_scene2, True, ((-6, 0.0, -6), (6, 9, 6))),
    "smoke": (scenes.cornell_smoke, True, None),
}


def texture_scene(name, dtype, dev):
    """(scene, camera, config, lane box, f32 atol) of a TEXTURE_SCENES entry
    at the full-size configuration; the atol as sphere_scene scales it."""
    spec_fn, ls, box = TEXTURE_SCENES[name]
    scene, cam = spec_scene(spec_fn(), dtype, dev)
    scale = 555.0
    if scene.has_spheres:
        scale = max(float(scene.sph_c0.abs().max()),
                    float(scene.sph_r.abs().max()))
    return (scene, cam, TEXTURED.replace(light_sampling=ls), box,
            1e-3 * scale / 555.0)


def phase_kernel_textures(dev):
    """K1 and K2 on the textured and smoke scenes, float32 and float64."""
    k1, k2 = [], []
    for dtype in (torch.float32, torch.float64):
        for name in TEXTURE_SCENES:
            scene, cam, cfg, box, atol = texture_scene(name, dtype, dev)
            tag = f"{dtype_name(dtype)}-{name}"
            k1.append(check_k1("kernel-textures", tag, scene, cam, cfg, dtype,
                               dev, box=box, atol=atol))
            k2.append(check_k2("kernel-bwd-textures", tag, scene, cam, cfg,
                               dtype, dev, box=box, atol=atol))
    return k1, k2


def phase_packed_textures(dev):
    """K3 against step_packed, and one K4 chunk bitwise equal to 32 K3
    launches, on textured_scene's and cornell_smoke's packed states."""
    out = {}
    for name in ("textured", "smoke"):
        scene, cam, cfg, box, atol = texture_scene(name, torch.float32, dev)
        setup = packed_setup(dev, scene, cam, cfg)
        plan, _, q, _ = setup
        k3 = check_k3(f"packed-{name}", setup, packed_state(
            M, q["n_work"], plan.max_depth, dev, box=box), atol)
        k4 = check_k4(f"persist-{name}", setup, packed_state(
            M, q["n_work"], plan.max_depth, dev, seed=1, box=box), atol,
            chunk_ts=())
        out[name] = (k3, k4)
    return out


def phase_golden_textures(dev):
    """Parity config 3 (textured_scene) against its golden."""
    scene, cam = spec_scene(scenes.textured_scene(), torch.float32)
    check_golden("golden-textures config3_textured", scene, cam, CONFIG3,
                 os.path.join(ROOT, "tests", "goldens", "config3_textured.npz"))


def phase_diff_textures(dev):
    """The differentiable renders of textured_scene (config 3's size) and
    cornell_smoke (64x64 spp4), and in float64 AD against finite
    differences: the marble's scale and the image texel with the largest
    gradient (neither moves a path, so the whole image at config 3's size),
    and the first medium's -1 / density on FD_CFG (a density moves scatter
    points, and a path that changes its decision is a jump FD sees and AD
    leaves out, so few paths)."""
    smoke_cfg = CONFIG3.replace(light_sampling=True)
    scene, cam = spec_scene(scenes.textured_scene(), torch.float32, dev)
    check_diff("diff-textures textured", scene, cam, CONFIG3)
    scene, cam = spec_scene(scenes.cornell_smoke(), torch.float32, dev)
    check_diff("diff-textures smoke", scene, cam, smoke_cfg)

    scene, cam = spec_scene(scenes.textured_scene(), torch.float64, dev)
    marble = int((scene.tex_type == build.TEX_MARBLE).nonzero()[0])
    cfg = CONFIG3.replace(dtype="f64")
    n_iters = diff_fused.calibrate_iters(scene, cam, cfg)
    params, rest = build.partition(scene)
    grads = fwd_bwd(scene, cam, cfg, n_iters, params, rest,
                    lambda raw: raw.mean())[4]
    texel = np.unravel_index(int(grads["images"].abs().argmax()),
                             grads["images"].shape)
    out = check_fd("diff-textures textured", scene, cam, cfg,
                   (("tex_scale", (marble,)),
                    ("images", tuple(int(i) for i in texel))), 1e-4)
    scene, cam = spec_scene(scenes.cornell_smoke(), torch.float64, dev)
    out.update(check_fd("diff-textures smoke", scene, cam,
                        FD_CFG.replace(light_sampling=True),
                        (("med_neg_inv_d", (0,)),), 1e-4))
    for leaf, (ad, fd) in out.items():
        if not (ad != 0.0 and abs(ad - fd) < 0.01 * abs(fd)):
            raise AssertionError(f"[diff-textures] f64 {leaf} AD not within "
                                 f"1% of FD")


def phase_full_textures(dev):
    """The textured and smoke scenes at full width: textured_scene and
    cornell_smoke (light sampled) at 512^2 spp8 depth 100, forward through
    render_with_stats (the FIFO pool, K1) and the persistent pool (K4) with
    equal segments, and the fwd+bwd step through render_diff_fused (K1 and
    K2)."""
    out = {}
    for name, spec_fn, cfg in (("textured", scenes.textured_scene, TEXTURED),
                               ("smoke", scenes.cornell_smoke, SMOKE)):
        scene, cam = spec_scene(spec_fn(), torch.float32, dev)
        tag = f"full-{name}"
        full = run_full(tag, name, scene, cam, cfg)
        profile_render(tag, scene, cam, cfg)
        pools = run_pools(tag, POOLS[2:], scene, cam, cfg, full, dev)
        same = torch.equal(pools["persistent"]["image"],
                           full["first"]["image"])
        log(f"[{tag}] the persistent pool's image equals the FIFO pool's "
            f"bitwise: {same}")
        full_bwd = run_full_bwd(f"{tag}-bwd", name, scene, cam, cfg)
        if not full_bwd["touched"] >= {
                "textured": {"images", "tex_scale", "sph_c0"},
                "smoke": {"med_neg_inv_d", "med_pmin", "med_pmax"}}[name]:
            raise AssertionError(f"[{tag}-bwd] a texture or medium leaf "
                                 f"took no gradient: "
                                 f"{sorted(full_bwd['touched'])}")
        out[name] = (full, pools["persistent"], full_bwd)
    return out


# name -> (spec, light sampling, the box the lane origins are drawn from;
# None: Cornell's cube): test_bezier (ground, six marker spheres, three
# curves), cornell_bezier (the Cornell walls and one fat curve of width 10)
# and points_chain_scene's helix (11 curves)
BEZIER_SCENES = {
    "bezier": (scenes.test_bezier, False, ((-3, -0.4, -4), (3, 2, 4))),
    "cornell_bezier": (scenes.cornell_bezier, True, None),
    "points_chain": (scenes.points_chain_scene, False,
                     ((-2.5, -0.4, -2.5), (2.5, 2.5, 2.5))),
}


def bezier_scene(name, dtype, dev):
    """(scene, camera, config, lane box, aim box, f32 atol) of a
    BEZIER_SCENES entry at the full-size configuration.  The aim box is the
    control points' bounding box: lanes aimed into it meet a ribbon often
    enough to hold the probe on thousands of lanes.  The atol as
    sphere_scene scales it."""
    spec_fn, ls, box = BEZIER_SCENES[name]
    scene, cam = spec_scene(spec_fn(), dtype, dev)
    cp = scene.bez_cp.reshape(-1, 3)
    aim = (cp.amin(0).tolist(), cp.amax(0).tolist())
    scale = 555.0
    if scene.has_spheres:
        scale = max(float(scene.sph_c0.abs().max()),
                    float(scene.sph_r.abs().max()))
    return (scene, cam, BEZIER.replace(light_sampling=ls), box, aim,
            1e-3 * scale / 555.0)


def phase_kernel_bezier(dev):
    """K1 and K2 on the bezier scenes, float32 and float64, on lanes aimed
    into the curves' bounding box."""
    k1, k2 = [], []
    for dtype in (torch.float32, torch.float64):
        for name in BEZIER_SCENES:
            scene, cam, cfg, box, aim, atol = bezier_scene(name, dtype, dev)
            tag = f"{dtype_name(dtype)}-{name}"
            k1.append(check_k1("kernel-bezier", tag, scene, cam, cfg, dtype,
                               dev, box=box, atol=atol, aim=aim))
            k2.append(check_k2("kernel-bwd-bezier", tag, scene, cam, cfg,
                               dtype, dev, box=box, atol=atol, aim=aim))
    return k1, k2


def phase_packed_bezier(dev):
    """K3 against step_packed, and one K4 chunk bitwise equal to 32 K3
    launches, on test_bezier's and cornell_bezier's packed states."""
    out = {}
    for name in ("bezier", "cornell_bezier"):
        scene, cam, cfg, box, aim, atol = bezier_scene(name, torch.float32,
                                                       dev)
        setup = packed_setup(dev, scene, cam, cfg)
        plan, _, q, _ = setup
        k3 = check_k3(f"packed-{name}", setup, packed_state(
            M, q["n_work"], plan.max_depth, dev, box=box, aim=aim), atol)
        k4 = check_k4(f"persist-{name}", setup, packed_state(
            M, q["n_work"], plan.max_depth, dev, seed=1, box=box, aim=aim),
            atol, chunk_ts=())
        out[name] = (k3, k4)
    return out


def phase_golden_bezier(dev):
    """Parity configs 5 (test_bezier) and 6 (cornell_bezier) against their
    goldens."""
    for name, spec, cfg in (
            ("config5_bezier", scenes.test_bezier(), CONFIG5),
            ("config6_cornell_bezier", scenes.cornell_bezier(), CONFIG6)):
        scene, cam = spec_scene(spec, torch.float32)
        check_golden(f"golden-bezier {name}", scene, cam, cfg,
                     os.path.join(ROOT, "tests", "goldens", name + ".npz"))


# The control-point probe of parity config 5 (bez_cp[0, 1, 1] of the
# gradient scene's one curve) on the harness's small gradient workload: 8^2,
# one sample, depth 3, the loss over the window of pixels whose centres hit
# the ribbon.  That is where the harness holds AD against finite differences:
# on more paths some hit grazes the ribbon, where the curvature floor bounds
# the estimator on purpose and AD leaves the derivative (16^2 spp4 gives 17%,
# in the JAX package as here).
BEZ_FD_CFG = RenderConfig(nx=8, ny=8, spp=1, max_depth=3, seed=0, dtype="f64")
BEZ_FD_WINDOW = (3, 5, 2, 6)


def phase_diff_bezier(dev):
    """The differentiable render of test_bezier at config 5's size, and in
    float64 AD against central finite differences on one control-point
    coordinate of the gradient scene's noise-textured curve."""
    scene, cam = spec_scene(scenes.test_bezier(), torch.float32, dev)
    check_diff("diff-bezier", scene, cam, CONFIG5)
    scene, cam = spec_scene(grad_bezier_spec(), torch.float64, dev)
    out = check_fd("diff-bezier", scene, cam, BEZ_FD_CFG,
                   (("bez_cp", (0, 1, 1)),), 1e-3, BEZ_FD_WINDOW)
    ad, fd = out["bez_cp"]
    if not (ad != 0.0 and abs(ad - fd) < 0.01 * abs(fd)):
        raise AssertionError("[diff-bezier] f64 bez_cp AD not within 1% of FD")


def phase_full_bezier(dev):
    """The bezier scenes at full width: test_bezier and cornell_bezier (light
    sampled) at 512^2 spp8 depth 100, forward through render_with_stats (the
    FIFO pool, K1) and the persistent pool (K4) with equal segments and a
    bitwise-equal image, and the fwd+bwd step through render_diff_fused (K1
    and K2); five timed runs each, and one run of each with the kernels'
    launches timed by CUDA events."""
    out = {}
    n = N_TIMED_BEZIER
    for name, spec_fn, cfg in (
            ("bezier", scenes.test_bezier, BEZIER),
            ("cornell_bezier", scenes.cornell_bezier, CORNELL_BEZIER)):
        scene, cam = spec_scene(spec_fn(), torch.float32, dev)
        tag = f"full-{name}"
        full = run_full(tag, name, scene, cam, cfg, n_timed=n)
        st0 = render.init_state(cfg)
        ev_fifo = log_kernel_events(
            tag, "FIFO render",
            lambda: render.render_with_stats(scene, cam, cfg, st0))
        profile_render(tag, scene, cam, cfg)
        pools = run_pools(tag, POOLS[2:], scene, cam, cfg, full, dev,
                          n_timed=n)
        raw0 = torch.zeros(cfg.n_pixels, 3, device=dev)
        ev_pers = log_kernel_events(
            tag, "persistent render",
            lambda: persist.render_pool_persistent(scene, cam, cfg, raw0, 0))
        same = torch.equal(pools["persistent"]["image"],
                           full["first"]["image"])
        log(f"[{tag}] the persistent pool's image equals the FIFO pool's "
            f"bitwise: {same}")
        if not same:
            raise AssertionError(f"[{tag}] the persistent pool's image "
                                 f"differs from the FIFO pool's")
        full_bwd = run_full_bwd(f"{tag}-bwd", name, scene, cam, cfg,
                                n_timed=n)
        ev_bwd = log_kernel_events(f"{tag}-bwd", "fwd+bwd step",
                                   full_bwd["step"])
        if "bez_cp" not in full_bwd["touched"]:
            raise AssertionError(f"[{tag}-bwd] the control points took no "
                                 f"gradient: {sorted(full_bwd['touched'])}")
        out[name] = (full, pools["persistent"], full_bwd,
                     dict(fifo=ev_fifo, persistent=ev_pers, bwd=ev_bwd))
    return out


# name -> (spec, light sampling, full-size configuration)
KLEIN_SCENES = {"klein": (scenes.klein_scene, KLEIN),
                "cornell_klein": (scenes.cornell_klein, CORNELL_KLEIN)}


def klein_setup(name, dtype, dev):
    """(scene, camera, config, f32 atol) of a KLEIN_SCENES entry; the atol as
    sphere_scene scales it."""
    spec_fn, cfg = KLEIN_SCENES[name]
    scene, cam = spec_scene(spec_fn(), dtype, dev)
    scale = 555.0
    if scene.has_spheres:
        scale = max(float(scene.sph_c0.abs().max()),
                    float(scene.sph_r.abs().max()))
    return scene, cam, cfg, 1e-3 * scale / 555.0


def phase_kernel_klein(dev):
    """K1 and K2 on the klein scenes, float32 and float64, on lanes aimed at
    the fractal from outside its precull ball (klein_inputs); K2's f64 dpk
    within 1e-10 of its largest slot.  The plain klein step is some 45,000
    launches: it is timed in float32 alone."""
    k1, k2 = [], []
    for dtype in (torch.float32, torch.float64):
        f32 = dtype == torch.float32
        for name in KLEIN_SCENES:
            scene, cam, cfg, atol = klein_setup(name, dtype, dev)
            tag = f"{dtype_name(dtype)}-{name}"
            k1.append(check_k1("kernel-klein", tag, scene, cam, cfg, dtype,
                               dev, atol=atol, timed=f32))
            k2.append(check_k2("kernel-bwd-klein", tag, scene, cam, cfg,
                               dtype, dev, atol=atol, dpk_tol=1e-10,
                               timed=f32))
    return k1, k2


def klein_packed_state(m, n_work, max_depth, dev, scene, seed=0):
    """packed_state with the rays of klein_rays."""
    st = packed_state(m, n_work, max_depth, dev, seed=seed)
    o, d = klein_rays(scene.kl_center[0].double().cpu().numpy(), m, seed)
    st[3:9] = torch.tensor(np.concatenate([o, d]), dtype=torch.float32,
                           device=dev)
    return st


def phase_packed_klein(dev):
    """K3 against step_packed, and one K4 chunk bitwise equal to 32 K3
    launches, on klein_scene's and cornell_klein's packed states."""
    out = {}
    for name in KLEIN_SCENES:
        scene, cam, cfg, atol = klein_setup(name, torch.float32, dev)
        setup = packed_setup(dev, scene, cam, cfg)
        plan, _, q, _ = setup
        k3 = check_k3(f"packed-{name}", setup, klein_packed_state(
            M, q["n_work"], plan.max_depth, dev, scene), atol)
        k4 = check_k4(f"persist-{name}", setup, klein_packed_state(
            M, q["n_work"], plan.max_depth, dev, scene, seed=1), atol,
            chunk_ts=(), plain_events=True)
        out[name] = (k3, k4)
    return out


def phase_golden_klein(dev):
    """There is no klein golden, and the f32 render of cornell_klein is not
    its f64 render within tests/test_parity.py's bounds: most rays scattered
    off the fractal hit it again just past t_min (the JAX step's acceptance
    band, DE < eps), and f32 and f64 take some of those re-hits differently,
    along chains of them (ROADMAP C.6).  So the f32 render (K1) is held
    against the f32 render of the plain step on the card, at CONFIG_KLEIN,
    with those bounds, and its distance from the f64 render (K1 in float64)
    is logged.  The plain step runs on the card, not on the host's CPU: the
    CPU's sin, cos and log round otherwise, and along the re-hit chains that
    put 1.2% of the pixels off at 32^2 spp4 (measured on an H100)."""
    spec = scenes.cornell_klein()
    scene, cam = spec_scene(spec, torch.float32, dev)
    kernel_step, bounce.step_cuda = bounce.step_cuda, bounce.step
    try:                              # the FIFO pool's step: the plain one
        plain, _ = render.render_image(scene, cam, CONFIG_KLEIN)
    finally:
        bounce.step_cuda = kernel_step
    check_golden("golden-klein cornell_klein, K1 against the plain step",
                 scene, cam, CONFIG_KLEIN, plain.cpu().numpy())
    f32, _ = render.render_image(scene, cam, CONFIG_KLEIN)
    s64, c64 = spec_scene(spec, torch.float64, dev)
    f64, _ = render.render_image(s64, c64, CONFIG_KLEIN.replace(dtype="f64"))
    diff = (f32.double() - f64).abs()
    log(f"[golden-klein] the f32 render against the f64 render (not held): "
        f"MAE {float(diff.mean()):.3e}, pixels off by > 0.05: "
        f"{float((diff.amax(-1) > 0.05).double().mean()):.4%}")


def phase_diff_klein(dev):
    """The differentiable render of cornell_klein at CONFIG_KLEIN's size, and
    in float64 AD against central finite differences on the klein's centre
    over a window of KLEIN_FD_CFG's image where the fractal is seen."""
    scene, cam = spec_scene(scenes.cornell_klein(), torch.float32, dev)
    check_diff("diff-klein", scene, cam, CONFIG_KLEIN)
    scene, cam = spec_scene(scenes.cornell_klein(), torch.float64, dev)
    out = check_fd("diff-klein", scene, cam, KLEIN_FD_CFG,
                   (("kl_center", (0, KLEIN_FD_AXIS)),), KLEIN_FD_EPS,
                   KLEIN_FD_WINDOW)
    ad, fd = out["kl_center"]
    if not (ad != 0.0 and abs(ad - fd) < 0.01 * abs(fd)):
        raise AssertionError("[diff-klein] f64 kl_center AD not within 1% of "
                             "FD")


def phase_full_klein(dev):
    """The klein scenes at full width: klein_scene and cornell_klein (light
    sampled) at 512^2 spp8 depth 100, forward through render_with_stats (the
    FIFO pool, K1) and the persistent pool (K4) with equal segments and a
    bitwise-equal image, and the fwd+bwd step through render_diff_fused (K1
    and K2); five timed runs each, and one run of each with the kernels'
    launches timed by CUDA events."""
    out = {}
    n = N_TIMED_BEZIER
    for name, (spec_fn, cfg) in KLEIN_SCENES.items():
        scene, cam = spec_scene(spec_fn(), torch.float32, dev)
        tag = f"full-{name}"
        full = run_full(tag, name, scene, cam, cfg, n_timed=n)
        st0 = render.init_state(cfg)
        ev_fifo = log_kernel_events(
            tag, "FIFO render",
            lambda: render.render_with_stats(scene, cam, cfg, st0))
        profile_render(tag, scene, cam, cfg)
        pools = run_pools(tag, POOLS[2:], scene, cam, cfg, full, dev,
                          n_timed=n)
        raw0 = torch.zeros(cfg.n_pixels, 3, device=dev)
        ev_pers = log_kernel_events(
            tag, "persistent render",
            lambda: persist.render_pool_persistent(scene, cam, cfg, raw0, 0))
        same = torch.equal(pools["persistent"]["image"],
                           full["first"]["image"])
        log(f"[{tag}] the persistent pool's image equals the FIFO pool's "
            f"bitwise: {same}")
        if not same:
            raise AssertionError(f"[{tag}] the persistent pool's image "
                                 f"differs from the FIFO pool's")
        full_bwd = run_full_bwd(f"{tag}-bwd", name, scene, cam, cfg,
                                n_timed=n, recalibrate=True)
        ev_bwd = log_kernel_events(f"{tag}-bwd", "fwd+bwd step",
                                   full_bwd["step"])
        # klein_scene's camera sits inside the fractal's solid: its centre
        # takes gradient only through paths that bounce off the ground
        if name == "cornell_klein" and "kl_center" not in full_bwd["touched"]:
            raise AssertionError(f"[{tag}-bwd] the klein's centre took no "
                                 f"gradient: {sorted(full_bwd['touched'])}")
        out[name] = (full, pools["persistent"], full_bwd,
                     dict(fifo=ev_fifo, persistent=ev_pers, bwd=ev_bwd))
    return out


def phase_probes(dev):
    """K5 and K6: the probes' own entry points with the counts reset just
    before (the path), then each kernel against its plain version."""
    probe_ops.LAUNCHES = probe_loops.LAUNCHES = 0
    ops_line = probe_ops.main()
    loops_ok, ext_ok = probe_loops.main()
    launches = dict(probe_ops=probe_ops.LAUNCHES,
                    probe_loops=probe_loops.LAUNCHES)
    log(f"[probes] probe_ops.main(): {ops_line}; probe_loops.main(): "
        f"{loops_ok}, extension {ext_ok}; launches {launches}")
    if (not all(loops_ok.values()) or not all(ext_ok.values())
            or not ops_line.startswith("ok: True")):
        raise AssertionError("[probes] a probe's main failed")
    n_cases = len(probe_loops.ALL_CASES)
    if launches != dict(probe_ops=1, probe_loops=n_cases):
        raise AssertionError(f"[probes] kernel launches {launches}")
    pack, item = probe_ops.inputs(dev)
    r = np.random.default_rng(0)
    rand = torch.tensor(r.integers(-2 ** 31, 2 ** 31, (8, 128),
                                   dtype=np.int64).astype(np.int32),
                        device=dev)
    ops_err = 0.0
    for it in (item, rand):
        want, w_ext = probe_ops.probe_plain(pack, it)
        got, g_ext = probe_ops.probe_cuda(pack, it)
        ints = want == torch.round(want)
        rel = float(((got - want).abs() / want.abs())[~ints].max())
        exact = torch.equal(got[ints], want[ints])
        # the extension: the floor and hash rows exact, then log, atan2, rsqrt
        ext_exact = torch.equal(g_ext[:2], w_ext[:2])
        ext_rel = float(((g_ext[2:] - w_ext[2:]).abs()
                         / w_ext[2:].abs().clamp(min=1e-3)).max())
        ops_err = max(ops_err, float((got - want).abs().max()),
                      float((g_ext - w_ext).abs().max()))
        log(f"[probes] K5 on {'the tool' if it is item else 'random'} items: "
            f"int-path outputs ({int(ints.sum())}) exact: {exact}; "
            f"transcendental outputs max rel err {rel:.3e} (bound "
            f"{PROBE_RTOL:g}); extension: floor and negative-int hash exact: "
            f"{ext_exact}, log / atan2 / rsqrt max rel err {ext_rel:.3e}")
        if not (exact and ext_exact) or max(rel, ext_rel) > PROBE_RTOL:
            raise AssertionError("[probes] K5 against its plain version")
    x = probe_loops.inputs(device=dev)
    for name, plain in probe_loops.ALL_CASES.items():
        if not torch.equal(probe_loops.loops_cuda(name, x), plain(x)):
            raise AssertionError(f"[probes] K6 case {name} differs from its "
                                 f"plain version")
    hit = float((probe_loops.ext_bezier_seeds(x) < 100.0).float().mean())
    kl_hit = float((probe_loops.ext_klein_march(x) < 100.0).float().mean())
    log(f"[probes] K6: all {len(probe_loops.CASES)} cases and the extension "
        f"{list(probe_loops.EXT_CASES)} bitwise equal to their plain "
        f"versions; the bezier loop form hits on {hit:.1%} of the elements, "
        f"the klein loop form on {kl_hit:.1%}")
    k5_ms = kernel_ms(lambda: probe_ops.probe_cuda(pack, item))
    k5_plain, k5_pl = device_ms(lambda: probe_ops.probe_plain(pack, item), 5)
    k6_ms = kernel_ms(lambda: [probe_loops.loops_cuda(n, x)
                               for n in probe_loops.ALL_CASES], 5)
    k6_plain, k6_pl = device_ms(lambda: [f(x) for f in
                                         probe_loops.ALL_CASES.values()], 1)
    log(f"[probes] device time: K5 {k5_ms * 1e3:.2f} us per launch, plain "
        f"{k5_plain * 1e3:.2f} us ({k5_pl:.0f} launches); K6 "
        f"{k6_ms:.4f} ms for the {n_cases} cases (one launch each), plain "
        f"{k6_plain:.2f} ms ({k6_pl:.0f} launches)")
    # K5: 16 floats and 1,024 ints in, 6 x 1,024 floats out; per item three
    # PCG rounds' share, a div/mod, a floor and seven transcendentals, about
    # 120 operations.
    k5_b = bound(pack.numel() * 4 + 7 * item.numel() * 4, 120 * item.numel())
    # K6: one (64, 128) float32 array in and out per case; the loops' float
    # operations per element, counted from the cases (a product, a sum and a
    # compare each count one): 200, 2,000, 8,000, 40, 4,000, 40, 4,000, 40,
    # and 3 per iteration of the early-exit loop, which runs while any lane
    # is below its threshold (all 100 when a lane starts under the fixed
    # point -1/3 of a -> 1.3 a + 0.1, as with these inputs); and the bezier
    # loop form's BEZ_SEEDS seeds of BEZ_NEWTON steps (19 each) and an end
    # (10); and the klein loop form's steps (12 each: the point, the
    # estimate, the accept and retirement tests, and the escape test of both
    # spheres, 6) and inversions (8 each), counted on these inputs.
    wa, trips = x.clone(), 0
    done = torch.zeros_like(x, dtype=torch.bool)
    while trips < 100 and not bool(done.all()):
        wa2 = wa * 1.3 + 0.1
        done |= wa2 > 100.0
        wa = torch.where(done, wa, wa2)
        trips += 1
    per_elt = (200 + 2000 + 8000 + 40 + 4000 + 40 + 4000 + 40 + 3 * trips
               + probe_loops.BEZ_SEEDS * (probe_loops.BEZ_NEWTON * 19 + 10))
    kl = dict(steps=0, inversions=0)
    probe_loops.ext_klein_march(x, kl)
    k6_b = bound(n_cases * 2 * x.numel() * 4, per_elt * x.numel()
                 + 12 * kl["steps"] + 8 * kl["inversions"])
    log(f"[probes] bounds: K5 {k5_b[0] * 1e6:.2f} ns ({k5_b[1]}), K6 "
        f"{k6_b[0] * 1e3:.2f} us ({k6_b[1]}; the early-exit loop ran {trips} "
        f"iterations)")
    return dict(launches=launches,
                k5=dict(max_abs_err=ops_err, ms=k5_ms, plain_ms=k5_plain,
                        bound_ms=k5_b[0], bound_by=k5_b[1]),
                k6=dict(max_abs_err=0.0, ms=k6_ms, plain_ms=k6_plain,
                        bound_ms=k6_b[0], bound_by=k6_b[1]))


# The phases after the device and build phases, in the order they run:
# name -> phase(dev, results), `results` holding the earlier phases' returns
# by name.
PHASES = {
    "kernel": lambda dev, r: phase_kernel(dev),
    "kernel-bwd": lambda dev, r: phase_kernel_bwd(dev),
    "golden": lambda dev, r: phase_golden(dev),
    "diff": lambda dev, r: phase_diff(dev),
    "full": lambda dev, r: phase_full(dev),
    "profile": lambda dev, r: phase_profile(dev),
    "full-bwd": lambda dev, r: phase_full_bwd(dev),
    "packed-kernel": lambda dev, r: phase_packed_kernel(dev),
    "persist-kernel": lambda dev, r: phase_persist_kernel(dev),
    "pools-full": lambda dev, r: phase_pools_full(dev, r["full"]),
    "probes": lambda dev, r: phase_probes(dev),
    "kernel-spheres": lambda dev, r: phase_kernel_spheres(dev),
    "kernel-bwd-spheres": lambda dev, r: phase_kernel_bwd_spheres(dev),
    "packed-spheres": lambda dev, r: phase_packed_spheres(dev),
    "golden-spheres": lambda dev, r: phase_golden_spheres(dev),
    "diff-spheres": lambda dev, r: phase_diff_spheres(dev),
    "full-spheres": lambda dev, r: phase_full_spheres(dev),
    "kernel-textures": lambda dev, r: phase_kernel_textures(dev),
    "packed-textures": lambda dev, r: phase_packed_textures(dev),
    "golden-textures": lambda dev, r: phase_golden_textures(dev),
    "diff-textures": lambda dev, r: phase_diff_textures(dev),
    "full-textures": lambda dev, r: phase_full_textures(dev),
    "kernel-bezier": lambda dev, r: phase_kernel_bezier(dev),
    "packed-bezier": lambda dev, r: phase_packed_bezier(dev),
    "golden-bezier": lambda dev, r: phase_golden_bezier(dev),
    "diff-bezier": lambda dev, r: phase_diff_bezier(dev),
    "full-bezier": lambda dev, r: phase_full_bezier(dev),
    "kernel-klein": lambda dev, r: phase_kernel_klein(dev),
    "packed-klein": lambda dev, r: phase_packed_klein(dev),
    "golden-klein": lambda dev, r: phase_golden_klein(dev),
    "diff-klein": lambda dev, r: phase_diff_klein(dev),
    "full-klein": lambda dev, r: phase_full_klein(dev),
}
# A phase that reads another's result brings it along.
NEEDS = {"pools-full": ("full",)}


def select_phases(text):
    """--phases' value -> the phases to run, in PHASES' order: every phase
    for None, else the named phases with what they need."""
    if text is None:
        return list(PHASES)
    chosen = set(filter(None, (n.strip() for n in text.split(","))))
    unknown = chosen - set(PHASES)
    if unknown:
        raise SystemExit(f"chip_smoke: no phase {sorted(unknown)}; phases: "
                         f"{', '.join(PHASES)}")
    for name in list(chosen):
        chosen |= set(NEEDS.get(name, ()))
    if not chosen:
        raise SystemExit("chip_smoke: --phases names no phase")
    return [p for p in PHASES if p in chosen]


def kernel_table(r):
    """The kernel table of a full run, from its phases' results."""
    kern, kern_bwd = r["kernel"], r["kernel-bwd"]
    full, full_bwd, pools = r["full"], r["full-bwd"], r["pools-full"]
    packed, chunk, probes = (r["packed-kernel"], r["persist-kernel"],
                             r["probes"])
    kern_sph, kern_bwd_sph = r["kernel-spheres"], r["kernel-bwd-spheres"]
    packed_sph, chunk_sph = r["packed-spheres"]
    sph_full, sph_persist, sph_bwd = r["full-spheres"]
    kern_tex, kern_bwd_tex = r["kernel-textures"]
    packed_tex, tex_full = r["packed-textures"], r["full-textures"]
    kern_bez, kern_bwd_bez = r["kernel-bezier"]
    packed_bez, bez_full = r["packed-bezier"], r["full-bezier"]
    kern_kl, kern_bwd_kl = r["kernel-klein"]
    packed_kl, kl_full = r["packed-klein"], r["full-klein"]
    # the full-size paths of the later slices: (forward, persistent, fwd+bwd)
    later = {**{k: v[:3] for k, v in tex_full.items()},
             **{k: v[:3] for k, v in bez_full.items()},
             **{k: v[:3] for k, v in kl_full.items()}}
    k1_launches = (full["launches"] + full_bwd["launches"]
                   + pools["strided"]["launches"] + sph_full["launches"]
                   + sph_bwd["launches"]
                   + sum(f["launches"] + b["launches"]
                         for f, _, b in later.values()))
    log(f"[paths] bounce_step launches: Cornell forward render "
        f"{full['launches']}, fwd+bwd step {full_bwd['launches']}, strided "
        f"pool {pools['strided']['launches']}, RTOW forward render "
        f"{sph_full['launches']}, RTOW fwd+bwd step {sph_bwd['launches']}; "
        f"bounce_step_bwd launches: Cornell fwd+bwd step "
        f"{full_bwd['bwd_launches']}, RTOW fwd+bwd step "
        f"{sph_bwd['bwd_launches']}; bounce_packed launches: packed pool "
        f"{pools['packed']['launches']}; bounce_persist launches: Cornell "
        f"persistent pool {pools['persistent']['launches']}, RTOW persistent "
        f"pool {sph_persist['launches']}; probes {probes['launches']}")
    for name, (f, pers, b) in later.items():
        log(f"[paths] {name}: bounce_step launches: forward render "
            f"{f['launches']}, fwd+bwd step {b['launches']}; bounce_step_bwd "
            f"launches: {b['bwd_launches']}; bounce_persist launches: "
            f"{pers['launches']}")
    f32 = [k for k in kern + kern_sph + kern_tex + kern_bez + kern_kl
           if k["name"].startswith("f32")]
    f32_bwd = [k for k in kern_bwd + kern_bwd_sph + kern_bwd_tex
               + kern_bwd_bez + kern_bwd_kl if k["name"].startswith("f32")]
    pick = lambda rows, name: next(k for k in rows if k["name"] == name)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    on = lambda k: {key: k[key] for key in keys}
    src = "scheme_raytrace_torch/csrc/"
    # no single PyTorch call computes a bounce step, a chunk of steps or a
    # probe's loops: library_ms is null for every kernel
    return {"kernels": [{
        "name": "bounce_step",
        "route": "cuda",
        "source": src + "bounce_step.cu",
        "replaces": "scheme_raytrace_tpu/integrator/bounce.py:1576",
        "launches": k1_launches,
        **on(pick(kern, "f32-light")),
        "max_abs_err": max(k["max_abs_err"] for k in f32),
        "library_ms": None,
        "rtow_227_spheres": on(pick(kern_sph, "f32-rtow")),
        "textured": on(pick(kern_tex, "f32-textured")),
        "simple_light": on(pick(kern_tex, "f32-simple_light")),
        "cornell_smoke": on(pick(kern_tex, "f32-smoke")),
        "bezier": on(pick(kern_bez, "f32-bezier")),
        "cornell_bezier": on(pick(kern_bez, "f32-cornell_bezier")),
        "points_chain": on(pick(kern_bez, "f32-points_chain")),
        "klein": on(pick(kern_kl, "f32-klein")),
        "cornell_klein": on(pick(kern_kl, "f32-cornell_klein")),
    }, {
        "name": "bounce_step_bwd",
        "route": "cuda",
        "source": src + "bounce_step_bwd.cu",
        "replaces": "scheme_raytrace_tpu/integrator/bounce.py:1687",
        "launches": (full_bwd["bwd_launches"] + sph_bwd["bwd_launches"]
                     + sum(b["bwd_launches"] for _, _, b in later.values())),
        **on(pick(kern_bwd, "f32-cornell-light")),
        "max_abs_err": max(k["max_abs_err"] for k in f32_bwd),
        "library_ms": None,
        "rtow_227_spheres": on(pick(kern_bwd_sph, "f32-rtow")),
        "textured": on(pick(kern_bwd_tex, "f32-textured")),
        "simple_light": on(pick(kern_bwd_tex, "f32-simple_light")),
        "cornell_smoke": on(pick(kern_bwd_tex, "f32-smoke")),
        "bezier": on(pick(kern_bwd_bez, "f32-bezier")),
        "cornell_bezier": on(pick(kern_bwd_bez, "f32-cornell_bezier")),
        "points_chain": on(pick(kern_bwd_bez, "f32-points_chain")),
        "klein": on(pick(kern_bwd_kl, "f32-klein")),
        "cornell_klein": on(pick(kern_bwd_kl, "f32-cornell_klein")),
    }, {
        "name": "bounce_packed",
        "route": "cuda",
        "source": src + "bounce_packed.cu",
        "replaces": "scheme_raytrace_tpu/integrator/bounce.py:1900",
        "launches": pools["packed"]["launches"],
        **on(packed),
        "library_ms": None,
        "rtow_227_spheres": on(packed_sph),
        "textured": on(packed_tex["textured"][0]),
        "cornell_smoke": on(packed_tex["smoke"][0]),
        "bezier": on(packed_bez["bezier"][0]),
        "cornell_bezier": on(packed_bez["cornell_bezier"][0]),
        "klein": on(packed_kl["klein"][0]),
        "cornell_klein": on(packed_kl["cornell_klein"][0]),
    }, {
        "name": "bounce_persist",
        "route": "cuda",
        "source": src + "bounce_persist.cu",
        "replaces": "scheme_raytrace_tpu/integrator/persist.py:114",
        "launches": (pools["persistent"]["launches"]
                     + sph_persist["launches"]
                     + sum(pers["launches"] for _, pers, _ in later.values())),
        **on(chunk),
        "library_ms": None,
        "rtow_227_spheres": on(chunk_sph),
        "textured": on(packed_tex["textured"][1]),
        "cornell_smoke": on(packed_tex["smoke"][1]),
        "bezier": on(packed_bez["bezier"][1]),
        "cornell_bezier": on(packed_bez["cornell_bezier"][1]),
        "klein": on(packed_kl["klein"][1]),
        "cornell_klein": on(packed_kl["cornell_klein"][1]),
    }, {
        "name": "probe_ops",
        "route": "cuda",
        "source": src + "probe_ops.cu",
        "replaces": "tools/probe_pallas_ops.py:50",
        "launches": probes["launches"]["probe_ops"],
        **probes["k5"],
        "library_ms": None,
    }, {
        "name": "probe_loops",
        "route": "cuda",
        "source": src + "probe_loops.cu",
        "replaces": "tools/repro_mosaic_crash.py:19",
        "launches": probes["launches"]["probe_loops"],
        **probes["k6"],
        "library_ms": None,
    }]}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Smoke run of the PyTorch port on one NVIDIA card.")
    ap.add_argument("--phases", default=None, metavar="NAME[,NAME...]",
                    help="run only these phases (default: all); "
                         "the device and build phases always run")
    args = ap.parse_args(argv)
    selected = select_phases(args.phases)
    dev, smi = phase_device()
    whole = args.phases is None
    if not whole:
        log(f"[phases] a selection of {len(selected)} of {len(PHASES)} "
            f"phases: {', '.join(selected)}")
    results = {"build": timed("build", phase_build, selected)}
    for name in selected:
        results[name] = timed(name, PHASES[name], dev, results)
    log(f"[time] chip_smoke: {time.perf_counter() - START:.1f} s in all")
    if whole:
        table = kernel_table(results)
        log(smi)
        print(json.dumps(table), flush=True)
    else:
        # every selected phase passed (a failure raised before this line)
        log(f"[phases] the {len(selected)} selected phases passed; a "
            f"selection prints no kernel table")
        log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
