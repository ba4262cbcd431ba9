"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py [--phases NAME[,NAME...]]

Drives scheme_raytrace_torch's paths on the card: the forward render and
the fwd+bwd training step of the Cornell box with mixture-PDF light
sampling (BASELINE config 4), the forward render through the three strided
work pools, the op and loop probes, the sphere scenes up to the RTOW
final scene (227 spheres) forward and fwd+bwd, and the textured and smoke
scenes (hash-Perlin noise and marble, image texels, constant media) forward
and fwd+bwd, the bezier scenes and the klein scenes forward and fwd+bwd,
the general pool (BVH, russian roulette, material sort, 4,901 prims), the
differentiable wavefront (render_pass and its gradients), the sharded
paths of parallel/, the command line, the entry point and the
instruments of tools/, and the headline bench, in phases; any
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
     oracle), and one launch of the routed kernel per pool iteration or
     chunk (the card's f32 frames go to the persistent pool, K4);
  6. differentiable render against its references at the same size: a
     drained queue, the image equal to the FIFO pool's forward render's
     bitwise,
     deterministic gradients, one backward launch per forward launch, and
     in float64 the AD gradient against central finite differences;
  7. full-size forward: 512x512 spp16 depth 100 through the FIFO pool (K1),
     one warm-up then three chained timed renders (rays/s counted as exact
     path segments), and one routed render under torch.profiler for the
     device-time breakdown;
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
     and one render of each under torch.profiler; then (`pools-200`) the
     persistent pool's image against the FIFO pool's at the default frame,
     200x200 spp16, where g = gcd(m, n_pix) = 64 < m and the flush adds a
     chunk's rows by ranked rounds;
 12. probes: the op probe (K5) and the nine loop probes and the two
     extension loop forms (K6: the bezier probe's and the klein march's)
     against their plain versions, K6 one case a launch and every case in
     one launch (its `main`'s path); timed in turns, K5 against an empty
     kernel and a copy on its grid (the card's launch floor, and that of a
     launch that moves K5's bytes), K6's one launch against its eleven
     single-case launches, and each case alone;
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
     depth 100, forward through the FIFO pool (K1) and the persistent pool
     (K4, the routed frame) with equal segments, and the fwd+bwd step through
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
     through the FIFO and the persistent pools and fwd+bwd;
 29. the tile of threads a lane (kernel-tile): K1 and K2 at every tile width
     (1, 2, 4, 8) against the one-thread search (w = 1) on the eight scenes
     of the full-size paths and two tie plans (a Cornell wall and a sphere
     duplicated right behind themselves with another material), float32
     and float64: K1's 14 outputs and K2's 13 lane cotangents bit for bit
     on every lane, K2's dpk within its bound, two K2 launches at the
     chosen width bitwise equal, the duplicates never picked; then the
     widths' device times in float32, swept up and down.  Then K3 and K4
     (float32 only) at every width on the same ten plans' packed states:
     K3's 16 state rows bit for bit w = 1's on every lane, one K4 chunk of
     32 iterations bit for bit w = 1's and 32 K3 launches' (the state, every
     flush row, the segments), two chunks at the chosen width equal, the
     duplicates never picked; and their device times at 65,536 lanes, swept
     up and down, beside each variant's registers, spills, resident blocks
     an SM and the launch's waves.  The other phases run K1 and K2 at the
     width `bounce.tile_width` chooses, K3 at that width too, and K4 at
     `persist.tile_width`'s;
 30. K4 at one thread a lane (persist-w1): one chunk on the eight scenes'
     packed states, timed by CUDA events.  It calls only what the port had
     before K4 took a width, so a copy of this script at the root of an
     older tree times that tree's K4 alike, in turns with this one.
 31. the general pool (integrator/pool.render_pool, plain PyTorch, no
     kernel) against its references (general-check): its flush on the card
     bit for bit the lane-order sum, and per run below its float64 render at
     24x24 spp2 on the card against the same pool on the CPU (segments and
     iterations exact, the image within 1e-9), the material-sorted render
     bitwise the masked one;
 32-36. the general pool's five runs, float32 at 65,536 lanes and depth
     100, each a warm-up (one of its pool iterations profiled for launches
     and busy share) and one timed render from zeros, bitwise the warm-up, with
     segments, iterations and peak memory, and no kernel launched:
     `render --scene random --bvh sah` at the CLI's 200x200 (one chunk of 4
     passes; general-cli); the RTOW scene at 512^2 spp1 through the SAH and
     the median BVH, within 1e-5 of each other and within the parity bounds
     of the fused FIFO render (general-rtow); a grid of 4,901 spheres at
     512^2 spp1, brute and SAH (general-grid); Cornell with russian roulette
     at 512^2 spp16 (general-rr); RTOW 200^2 spp16 with the material-sorted
     shading, bitwise the masked (general-sort).  The BVH runs are cut in spp
     to fit the time limit.
 37. the differentiable wavefront (integrator/wavefront.py, render_pass,
     plain PyTorch, threefry keys, no kernel) against its references
     (wave-check): float64 on the card against the CPU on three scenes (the
     while mode's render_pass within 1e-9 with exact segments, the scan's
     gradients of every leaf and camera field within 1e-9); the six parity
     configs' float64 gradients against the goldens' grad_ad (1e-6) and
     their float32 gradients on the big workload (16x16 spp32, spp128 for
     config 5) against grad_ad_big within each config's f32_grad_rtol; the
     scan's image bitwise the while mode's, several passes in one wavefront
     bitwise one at a time; two identical float32 gradient runs, bitwise or
     the leaves that differ, beside the graph's accumulating backward nodes;
 38. the flagship entry's workload at full size (wave-full): BASELINE config
     4 at 512x512 spp1 depth 100, float32: render_pass in the while mode (a
     warm-up, its third bounce profiled, then three passes) and the
     differentiable training step (loss sum(mean^2)/numel, every leaf's and
     camera field's gradient, a warm-up and three steps chained by
     params -= 1e-6 grad, then steps at depths 2 and 4 profiled for the
     launches a bounce and the busy share), with segments, bounces and peak
     memory, and no kernel of K1-K6 launched.
 39. parallel/ over torch.distributed (parallel): NCCL takes one rank a
     card, so on one card the collectives run at world 1 over NCCL.
     render_pool_sharded (routed: the persistent pool) and
     render_pool_balanced (the FIFO pool) at Cornell 512x512 spp16 depth 100
     give render_pool_auto's and render_pool_fused's image and segments
     bitwise; the
     bodies of 4 virtual shards (the row-band pool at each band's first
     pixel, the balanced pool at each offset), run one after another
     through K1 and assembled by hand, give it too; train_step_fused at
     512x512 spp8 (K1 and K2) drains and gives render_diff_fused's step's
     new parameters bitwise, timed in turns with it, and the gradient
     all-reduce is timed by CUDA events; render_sharded and one
     train_step (the wavefront, no kernel) at 128x128 spp1 depth 100 give
     the unsharded wavefront's image and step on the shard's keys bitwise;
 40. the command line (cli): `python -m scheme_raytrace_torch render
     --scene cornell --light-sampling --nx 512 --ny 512 --spp 16 --chunk
     4` in a process of its own, its PPM bitwise render.write_ppm of the
     same four chunks rendered here, its saved state resumed here for a
     fifth chunk bitwise; `scenes` lists scenes.SCENES; `probe 100 100
     --light-sampling` prints finite numbers; `view` on port 0 for 3
     passes serves a PNG whose pixels are to_u8 of the published mean and
     answers a click probe.
 41. entry.py and the instruments of scheme_raytrace_torch/tools on the
     card (tools), each at the JAX tool's defaults with its seconds and its
     K1 / K2 launches: entry()'s render_pass (64x64 spp1 depth 8, finite)
     and dryrun_multichip(1) (NCCL world 1: render_sharded, train_step,
     train_step_fused drained); bench_scenes on Cornell (K4); bench_diff
     (256^2 spp4, 5 chained steps, K1 and K2); check_vjp_grads (the loss
     and every leaf's gradient through K2 against the plain step's VJP on
     the card: float32 within tests/test_parity.py's scale and bound,
     float64 within 1e-9); profile_diff_step's kernel / glue / full loops
     at 512^2 spp8; profile_hotpath's six stages and profile_scatter's
     flushes (CUDA events beside the host's enqueue time);
     diag_fwdbwd_variance at 5 reps; bench_bvh_crossover at N = 256 and
     1,024 (cut from 4,096 and 16,384 too); bench_material_sort;
     bench_shard_overhead; bench_scaling (world 1 and the cards, one here,
     each in processes of their own).
 42. the headline bench (bench): `python -m scheme_raytrace_torch.bench`,
     the root bench.py's twin, in a process of its own as a user runs it
     (Cornell 512x512 spp16 forward, spp8 fwd+bwd and 1024x1024 spp16
     forward, each a warm-up and 5 timed runs): exit 0, its last line
     with bench.py's keys and "card", the steps "persistent" (forward) and
     "cuda" (reverse), every rate positive, its warm-up 512^2 render's
     segments those of phase 7 (or the recorded 11,646,756), each
     measurement's spread logged; then one 1024^2 render here, its 4 row
     bands under torch.profiler (the routed kernel's launches, the busy
     share, the peak memory) and rendered again one at a time through the
     routed pool, each bitwise its rows of the frame.

Every kernel's bound is printed beside its time: the larger of its bytes
over 3.35 TB/s and a floor of its float operations over 67 TFLOP/s.  The
last two lines are the kernel table and the device line, as JSON; every
phase logs what it took (`[time]`).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ast
import concurrent.futures
import dataclasses
import inspect
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from scheme_raytrace_torch import parity, render, scenes
from scheme_raytrace_torch.camera import CAMERA_FIELDS, Camera
from scheme_raytrace_torch.config import SHADOW_EPS, RenderConfig
from scheme_raytrace_torch.core import rng
from scheme_raytrace_torch.integrator import (bounce, diff_fused, persist,
                                              pool, pool_fused, pool_packed,
                                              pool_strided, wavefront)
from scheme_raytrace_torch.scene import build, compile_scene
from scheme_raytrace_torch.scene import objects as ob
from scheme_raytrace_torch.tools import probe_loops, probe_ops
from scheme_raytrace_torch.tools.bench_bvh_crossover import (grid_scene,
                                                             grid_spec)
from scheme_raytrace_torch.utils import cuda_build, telemetry

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
KLEIN_TIME_T = 8    # the klein scenes' K4 and plain chunk timed at 8 steps
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


def smi_line():
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false)")
    smi = smi_line()
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


# The tie plans of the kernel-tile phase: a primitive duplicated right
# behind itself in pack order, with another material.  A lane that hits it
# meets both at one t, bit for bit, and the sweep must keep the first: a
# wrong pick changes the throughput (another albedo) or the scatter rule.
# Adjacent in pack order, the two fall on different threads of every tile
# width above 1.  `scenes_mod` and `ob_mod` are this package's scenes and
# objects, or a package with the same names (the CPU tests build the JAX
# package's twin of each plan with them).
TIE_ALBEDO = (0.1, 0.2, 0.7)


def cornell_tie_spec(scenes_mod=scenes, ob_mod=ob):
    """The Cornell box with its red wall (a rect in the plane x = 0)
    duplicated right behind itself in a blue-grey Lambertian."""
    spec = scenes_mod.cornell_box()
    objs = list(spec.objects)
    objs.insert(2, dataclasses.replace(
        objs[1], material=ob_mod.Lambertian(TIE_ALBEDO)))
    return scenes_mod.SceneSpec(objs, spec.camera_kwargs, spec.sky)


def spheres_tie_spec(scenes_mod=scenes, ob_mod=ob):
    """three_spheres with its centre sphere duplicated right behind itself
    in a fuzzy metal."""
    spec = scenes_mod.three_spheres()
    objs = list(spec.objects)
    objs.insert(2, dataclasses.replace(
        objs[1], material=ob_mod.Metal((0.8, 0.8, 0.8), 0.3)))
    return scenes_mod.SceneSpec(objs, spec.camera_kwargs, spec.sky)


# name -> (spec, the box the lane origins are drawn from (None: Cornell's
# cube), the box the lanes are aimed at): the aim box covers the duplicated
# primitive, so most lanes meet it
TIE_SCENES = {
    "cornell_tie": (cornell_tie_spec, None, ((0, 0, 0), (1, 555, 555))),
    "spheres_tie": (spheres_tie_spec, ((-2, -0.4, 0), (2, 1.5, 1)),
                    ((-0.4, -0.4, -1.4), (0.4, 0.4, -0.6))),
}


# phase -> the (kernels, scene) pairs whose variants it launches: what the
# build phase compiles ahead of the timed windows.  A variant is named by its
# plan's feature set, which the scene alone decides.
VARIANTS = {
    "kernel": [((K1,), scenes.cornell_box)],
    "kernel-bwd": [((K1, K2), scenes.cornell_box),
                   ((K1, K2), scenes.cornell_materials)],
    "golden": [((K1, K4), scenes.cornell_box)],
    "diff": [((K1, K2), scenes.cornell_box)],
    "full": [((K1,), scenes.cornell_box)],
    "profile": [((K1, K4), scenes.cornell_box)],
    "full-bwd": [((K1, K2), scenes.cornell_box)],
    "packed-kernel": [((K3,), scenes.cornell_box)],
    "persist-kernel": [((K3, K4), scenes.cornell_box)],
    "pools-full": [((K1, K3, K4), scenes.cornell_box)],
    "pools-200": [((K1, K4), scenes.cornell_box)],
    "probes": [(PROBES, None)],
    "kernel-spheres": [((K1,), scenes.test_scene), ((K1,), moving_spec),
                       ((K1,), rtow_spec)],
    "kernel-bwd-spheres": [((K1, K2), scenes.test_scene),
                           ((K1, K2), moving_spec), ((K1, K2), rtow_spec)],
    "packed-spheres": [((K3, K4), rtow_spec)],
    "golden-spheres": [((K1, K4), scenes.three_spheres),
                       ((K1, K4), rtow_spec)],
    "diff-spheres": [((K1, K2), scenes.three_spheres)],
    "full-spheres": [((K1, K2, K4), rtow_spec)],
    "kernel-textures": [((K1, K2), scenes.textured_scene),
                        ((K1, K2), scenes.test_scene2),
                        ((K1, K2), scenes.cornell_smoke)],
    "packed-textures": [((K3, K4), scenes.textured_scene),
                        ((K3, K4), scenes.cornell_smoke)],
    "golden-textures": [((K1, K4), scenes.textured_scene)],
    "diff-textures": [((K1, K2), scenes.textured_scene),
                      ((K1, K2), scenes.cornell_smoke)],
    "full-textures": [((K1, K2, K4), scenes.textured_scene),
                      ((K1, K2, K4), scenes.cornell_smoke)],
    "kernel-bezier": [((K1, K2), scenes.test_bezier),
                      ((K1, K2), scenes.cornell_bezier),
                      ((K1, K2), scenes.points_chain_scene)],
    "packed-bezier": [((K3, K4), scenes.test_bezier),
                      ((K3, K4), scenes.cornell_bezier)],
    "golden-bezier": [((K1, K4), scenes.test_bezier),
                      ((K1, K4), scenes.cornell_bezier)],
    "diff-bezier": [((K1, K2), scenes.test_bezier),
                    ((K1, K2), grad_bezier_spec)],
    "full-bezier": [((K1, K2, K4), scenes.test_bezier),
                    ((K1, K2, K4), scenes.cornell_bezier)],
    "kernel-klein": [((K1, K2), scenes.klein_scene),
                     ((K1, K2), scenes.cornell_klein)],
    "packed-klein": [((K3, K4), scenes.klein_scene),
                     ((K3, K4), scenes.cornell_klein)],
    "golden-klein": [((K1, K4), scenes.cornell_klein)],
    "diff-klein": [((K1, K2), scenes.cornell_klein)],
    "full-klein": [((K1, K2, K4), scenes.klein_scene),
                   ((K1, K2, K4), scenes.cornell_klein)],
    "kernel-tile": [((K1, K2, K3, K4), f) for f in (
        scenes.cornell_box, rtow_spec, scenes.textured_scene,
        scenes.cornell_smoke, scenes.test_bezier, scenes.cornell_bezier,
        scenes.klein_scene, scenes.cornell_klein, cornell_tie_spec,
        spheres_tie_spec)],
    "persist-w1": [((K4,), f) for f in (
        scenes.cornell_box, rtow_spec, scenes.textured_scene,
        scenes.cornell_smoke, scenes.test_bezier, scenes.cornell_bezier,
        scenes.klein_scene, scenes.cornell_klein)],
    "general-check": [],
    "general-cli": [],
    "general-rtow": [((K1, K4), rtow_spec)],
    "general-grid": [],
    "general-rr": [((K1, K4), scenes.cornell_box)],
    "general-sort": [],
    "wave-check": [],
    "wave-full": [],
    "parallel": [((K1, K2, K4), scenes.cornell_box)],
    "cli": [((K1, K4), scenes.cornell_box)],
    "tools": [((K1, K2, K4), scenes.cornell_box),
              ((K1, K4), lambda: grid_spec(256))],
    "bench": [((K1, K2, K4), scenes.cornell_box)],
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
    events alone (op rows on the host side and the device copies of the
    port's telemetry spans, user annotations, are not counted).  Without
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
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
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


def k2_dpk_bound(dtype, want_pk, dpk_tol=BWD_F64["dpk"]):
    """K2's stated dpk bound against a reference dpk, a slot at a time: in
    f64 `dpk_tol` of the largest slot, in f32 BWD_F32's atol (scaled by the
    largest slot, at least 1) and rtol."""
    top = float(want_pk.abs().max())
    if dtype == torch.float64:
        return dpk_tol * top
    return BWD_F32["atol"] * max(1.0, top) + BWD_F32["rtol"] * want_pk.abs()


def k2_bound(plan, pk, m, ins, scattering, klein_ops=0):
    """K2 in f32: the step's 19 inputs (70 B a lane), 13 cotangents in and
    13 out, pk and the texels once and one row of partials per 256 lanes
    (the fewest rows a launch writes, at one thread a lane); the replay of the forward and the adjoint of the scattering
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
        pk_lim = k2_dpk_bound(dtype, want_pk, dpk_tol)
        pk_bad = int(((got_pk - want_pk).abs() > pk_lim).sum())
    else:
        scale = torch.clamp(want[:, keep].abs().amax(1), min=1.0)
        lane_bad = (err > BWD_F32["atol"] * scale[:, None]
                    + BWD_F32["rtol"] * want.abs()).any(0) & keep
        pk_lim = k2_dpk_bound(dtype, want_pk)
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
    # launches the kernel and the sum of its partials over the blocks (a row
    # a block at the plan's tile width): the kernel's own time is the
    # wrapper's less that of the same sum alone.
    k_all = kernel_ms(lambda: bounce.step_cuda_bwd(*args))
    partials = bounce.bwd_partials(plan, M_BWD, bounce.tile_width(
        plan, bwd=True), dtype, dev).zero_()
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
    itself) with the bounds of tests/test_parity.py; one launch of the
    routed kernel (routed_kernel) per pool iteration or chunk."""
    kernel, per = routed_kernel(scene, cfg)
    start = launch_counts()[kernel]
    mean, state = render.render_image(scene, cam, cfg)
    launches = launch_counts()[kernel] - start
    start = launch_counts()[kernel]
    state2, segs, iters = render.render_with_stats(
        scene, cam, cfg, render.init_state(cfg))
    launches2 = launch_counts()[kernel] - start
    if not (launches * per == launches2 * per == iters):
        raise AssertionError(f"[{tag}] {kernel} launches {launches}/"
                             f"{launches2} x {per} != pool iterations {iters}")
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
        f"{kernel} launches {launches}; MAE {mae:.3e} (< 5e-3), pixels off "
        f"by > 0.05: "
        f"{outliers:.4%} (< 1%)")
    if not (mae < 5e-3 and outliers < 0.01):
        raise AssertionError(f"[{tag}] image outside the golden's bounds")


def phase_golden(dev):
    scene, cam = cornell(torch.float32, dev)
    check_golden("golden", scene, cam, CONFIG4, GOLDEN)


def spec_scene(spec, dtype, dev=None, bvh=None):
    """A SceneSpec compiled with its own sky (and a BVH when `bvh` names a
    builder); with no `dev` the scene and camera land on the card, the
    port's default."""
    scene = compile_scene(spec.objects, sky=spec.sky, dtype=dtype,
                          lights=spec.lights, bvh=bvh, device=dev)
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
    reset_counts()
    raw, _, segs, leftover, grads = fwd_bwd(scene, cam, cfg, n_iters, params,
                                            rest, mean)
    torch.cuda.synchronize()
    launches, bwd_launches = launch_counts()["K1"], launch_counts()["K2"]
    blocks = -(-n_iters // pool_fused.FLUSH_EVERY) * pool_fused.FLUSH_EVERY
    st, f_segs, _ = fifo_frame(scene, cam, cfg, render.init_state(cfg))
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
N_TIMED_WAVE = 2    # the wavefront's training steps (8-18 s each)


def run_full(tag, what, scene, cam, cfg, n_timed=N_TIMED):
    """The forward render through the FIFO pool (K1, fifo_frame; the card's
    f32 frames route to the persistent pool, which run_pools times beside
    it): one warm-up render from zeros, then n_timed chained renders.  Sets
    the launch counts just before and reads K1's just after."""
    reset_counts()                            # the FIFO pool's count starts
    total_iters = 0
    t0 = time.perf_counter()
    st, segs, iters = fifo_frame(scene, cam, cfg, render.init_state(cfg))
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
        st, segs, iters = fifo_frame(scene, cam, cfg, st)
        float(st.raw_sum[0, 0, 0])
        times.append(time.perf_counter() - t0)
        total_iters += iters
    launches = launch_counts()["K1"]
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
    """One forward render through render_with_stats (the routed pool) under
    torch.profiler: device time by kernel and the card's busy share of the
    render's wall time."""
    st = render.init_state(cfg)
    wall_ms, table = device_kernels(
        lambda: render.render_with_stats(scene, cam, cfg, st))
    return log_profile(tag, wall_ms, table,
                       ours=("bounce_step", "bounce_persist"))


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
    reset_counts()             # the main path's count starts
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
            before = launch_counts()["K1"]
            n_iters = diff_fused.calibrate_iters(build.combine(params, rest),
                                                 cam, cfg, slack=1.1)
            calib_launches += launch_counts()["K1"] - before
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
    launches, bwd_launches = launch_counts()["K1"], launch_counts()["K2"]
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
    log(f"[{tag}] K3 f32 m={M} w={bounce.tile_width(plan)} P={plan.size} "
        f"({live} live lanes): kernel vs "
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


def k3_chunk(plan, pk, sb, state, q, T, tile=None, ops=True):
    """T K3 launches (at `tile` threads a lane, the plan's width for None)
    from `state`, with the flush rows and segment counts the persistent
    kernel writes, derived on the card; and, with `ops`, the chunk's
    packed_texture_ops, summed over its iterations (the klein march's over
    all T iterations' lanes at once: one plain march of T m lanes), else
    0."""
    flush = torch.empty(T, 4, q["m"], dtype=torch.float32, device=state.device)
    segs = torch.empty(T, dtype=torch.int32, device=state.device)
    tex_ops, states = 0, []
    for t in range(T):
        item = state.view(torch.int32)[0]
        segs[t] = (item < q["n_work"]).sum()
        if ops:
            tex_ops += packed_texture_ops(plan, pk, sb, state, q, klein=False)
            states.append(state)
        state = bounce.step_packed_cuda(plan, pk, sb, state, **q, tile=tile)
        done = state[1] != 0.0
        flush.view(torch.int32)[t, 0] = torch.where(done, item % q["n_pix"],
                                                    -1)
        flush[t, 1:] = torch.where(done, state[10:13], 0.0)
    if ops and plan.n_kleins:
        tex_ops += klein_ops(plan, pk, packed_lanes(
            plan, sb, torch.cat(states, 1), q), KLEIN_NORMAL_OPS)[1]
    return (state, flush, segs), tex_ops


def same_chunk(got, want):
    """Whether two chunks (state, flush, segs) are equal bit for bit, each
    part on its own."""
    return [torch.equal(bits(g) if g.is_floating_point() else g,
                        bits(w) if w.is_floating_point() else w)
            for g, w in zip(got, want)]


def check_k4(tag, setup, state, atol=F32_TOL["atol"], chunk_ts=CHUNK_TS,
             time_t=None):
    """One K4 chunk bitwise against CHUNK_T K3 launches, K4 against
    chunk_plain, and times.  The plain chunk is timed by a CUDA event pair
    around one call (its host syncs and launch gaps included), not by the
    profiler, whose reading costs 0.11 ms an event: 34 s for textured's
    309,782 launches, minutes for the klein march's; its launches are not
    counted.  The returned times and bound are of a chunk of `time_t`
    iterations (CHUNK_T unless given): the klein's plain chunk of 32 takes
    over 30 s, so the klein scenes time chunks of KLEIN_TIME_T."""
    plan, pk, q, sb = setup
    T = persist.CHUNK_T
    time_t = T if time_t is None else time_t
    got = persist.chunk_cuda(plan, pk, sb, state, T=T, **q)
    want, tex_ops = k3_chunk(plan, pk, sb, state, q, T)
    torch.cuda.synchronize()
    same = same_chunk(got, want)
    log(f"[{tag}] one K4 chunk of T={T} at w={persist.tile_width(plan)} "
        f"against {T} K3 launches at w={bounce.tile_width(plan)} from the "
        f"same state: state, flush rows, segments bitwise equal: {same}; "
        f"segments {int(got[2].sum())}")
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
    for t_len in sorted(set(chunk_ts) | {time_t}):
        per_t[t_len] = kernel_ms(lambda: persist.chunk_cuda(
            plan, pk, sb, state, T=t_len, **q), 10)
    k_ms = per_t[time_t]
    # the chunk_plain calls above warmed it
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    persist.chunk_plain(plan, pk, sb, state, T=time_t, **q)
    e1.record()
    e1.synchronize()
    p_ms = e0.elapsed_time(e1)
    k3_ms = kernel_ms(lambda: bounce.step_packed_cuda(plan, pk, sb, state,
                                                      **q))
    log(f"[{tag}] device time per chunk: "
        + ", ".join(f"T={t} {ms:.4f} ms ({ms / t * 1e3:.2f} us/iteration)"
                    for t, ms in per_t.items())
        + f"; one K3 launch {k3_ms * 1e3:.2f} us; plain chunk_plain "
        f"T={time_t} {p_ms:.3f} ms (CUDA events around one call)")
    segs = got[2]
    if time_t != T:
        segs = persist.chunk_cuda(plan, pk, sb, state, T=time_t, **q)[2]
        tex_ops = k3_chunk(plan, pk, sb, state, q, time_t)[1]
    b_ms, b_by = packed_bound(plan, q, state, time_t, segs, tex_ops)
    log(f"[{tag}] K4 bound for this chunk of T={time_t}: {b_ms * 1e3:.2f} us "
        f"({b_by})")
    return dict(max_abs_err=max_err, ms=k_ms, plain_ms=p_ms, per_t=per_t,
                bound_ms=b_ms, bound_by=b_by, T=time_t)


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


POOLS = (("strided", pool_strided.render_pool_strided, "K1"),
         ("packed", pool_packed.render_pool_packed, "K3"),
         ("persistent", persist.render_pool_persistent, "K4"))


# The process counters of the kernels' launches (utils/telemetry) at the
# last reset_counts(): launch_counts() reads the launches since.
_COUNTS_AT = {}
KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6")


def launch_counts():
    """Every kernel wrapper's launches (K1-K6) since reset_counts()."""
    return {k: telemetry.counter(f"launches.{k}") - _COUNTS_AT.get(k, 0)
            for k in KERNELS}


def reset_counts():
    _COUNTS_AT.update((k, telemetry.counter(f"launches.{k}"))
                      for k in KERNELS)


def routed_kernel(scene, cfg):
    """The kernel a frame launches through render_with_stats and the pool
    iterations a launch: K4 and CHUNK_T where pool.routes_to_persistent
    sends the frame to the persistent pool, else K1 and 1 (the FIFO pool)."""
    if pool.routes_to_persistent(scene.device, cfg.torch_dtype, scene, cfg):
        return "K4", persist.CHUNK_T
    return "K1", 1


def fifo_frame(scene, cam, cfg, st):
    """render.render_with_stats through the FIFO pool (K1) whatever the
    route: the pool the strided pools and the reverse step are held to, on
    frames of one drain (up to pool.BAND_PIX pixels)."""
    raw, segs, iters = pool_fused.render_pool_fused(
        scene, cam, cfg, st.raw_sum.reshape(-1, 3), st.sample_count)
    return (render.RenderState(raw.reshape(cfg.ny, cfg.nx, 3),
                               st.sample_count + cfg.spp), segs, iters)


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
    # reproducible on the card: a second persistent render, bitwise, with
    # its kernels' launches timed by CUDA events
    with KernelEvents() as ev:
        again, _, _ = persist.render_pool_persistent(scene, cam, cfg, raw0, 0)
        events = ev.totals()
    k4_ms, k4_n = events[K4]
    plan = bounce.pool_plan(scene, cfg)
    log(f"[{tag}] persistent render: K4 at w={persist.tile_width(plan)} "
        f"{k4_ms:.3f} ms in {k4_n} chunks ({k4_ms / k4_n:.4f} ms a chunk), by "
        f"CUDA events around every launch")
    results["persistent"]["events"] = events
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


POOLS_200 = RenderConfig(nx=200, ny=200, spp=16, max_depth=100, seed=0,
                         light_sampling=True)


def phase_pools_200(dev):
    """The persistent pool's image against the FIFO pool's at the default
    frame, Cornell 200^2 spp16: m = 65,536 lanes and g = gcd(m, n_pix) = 64,
    so up to m / g = 1,024 lanes of a row finish one pixel and the flush
    adds by ranked rounds (pool_strided.Framebuffer), where at 512^2 it
    adds one index_add a row.  One render each from zeros, the counts set
    to 0 just before each and read just after."""
    scene, cam = cornell(torch.float32, dev)
    cfg = POOLS_200
    raw0 = torch.zeros(cfg.n_pixels, 3, device=dev)
    out = {}
    for name, fn, count in (
            ("FIFO", pool_fused.render_pool_fused, "K1"),
            ("persistent", persist.render_pool_persistent,
             "K4")):
        reset_counts()
        t0 = time.perf_counter()
        raw, segs, iters = fn(scene, cam, cfg, raw0, 0)
        float(raw[0, 0])
        secs = time.perf_counter() - t0
        launches = {k: v for k, v in launch_counts().items() if v}
        out[name] = dict(image=raw, segments=int(segs), iters=iters)
        log(f"[pools-200] {name}: {int(segs)} segments in {iters} iterations, "
            f"{secs * 1e3:.1f} ms (first render, builds cached); launches "
            f"{launches}")
        expect = iters // (persist.CHUNK_T if name == "persistent" else 1)
        if launches != {count: expect}:
            raise AssertionError(f"[pools-200] {name}: launches {launches}, "
                                 f"expected {count} = {expect}")
    ref, got = out["FIFO"]["image"], out["persistent"]["image"]
    m = pool_strided.pool_size(cfg, cfg.n_pixels * cfg.spp)
    fb = pool_strided.Framebuffer(raw0, m, cfg.spp)
    err = (got - ref).abs()
    lim = 1e-5 * float(ref.abs().max()) + 1e-5 * ref.abs()
    n_out = int((err > lim).sum())
    log(f"[pools-200] m={m}, g={math.gcd(m, cfg.n_pixels)}: the flush's "
        f"{fb.rounds(persist.CHUNK_T)} ranked rounds a chunk of "
        f"{persist.CHUNK_T} rows; persistent image against FIFO: max abs err "
        f"{float(err.max()):.3e}, entries outside rtol 1e-5 / atol 1e-5 "
        f"max|ref|: {n_out}")
    if out["FIFO"]["segments"] != out["persistent"]["segments"]:
        raise AssertionError("[pools-200] the persistent pool's segments are "
                             "not the FIFO pool's")
    if n_out or not torch.isfinite(got).all() or float(ref.max()) <= 0:
        raise AssertionError("[pools-200] the persistent image is off the "
                             "FIFO pool's")
    return {k: dict(segments=v["segments"], iters=v["iters"])
            for k, v in out.items()}


def phase_full_spheres(dev):
    """The sphere slice at full width: the RTOW final scene (227 spheres,
    most of them moving) at 512^2 spp8 depth 100, forward through
    the FIFO pool (K1) and through the persistent pool (K4, the routed
    frame) with equal segment counts, and the fwd+bwd step through
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
    the FIFO pool (K1) and the persistent pool (K4, the routed frame) with
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
    sampled) at 512^2 spp8 depth 100, forward through the FIFO pool
    (K1) and the persistent pool (K4, the routed frame) with equal segments and a
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
            lambda: fifo_frame(scene, cam, cfg, st0))
        profile_render(tag, scene, cam, cfg)
        pools = run_pools(tag, POOLS[2:], scene, cam, cfg, full, dev,
                          n_timed=n)
        ev_pers = pools["persistent"]["events"]
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
            chunk_ts=(), time_t=KLEIN_TIME_T)
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
    sampled) at 512^2 spp8 depth 100, forward through the FIFO pool
    (K1) and the persistent pool (K4, the routed frame) with equal segments and a
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
            lambda: fifo_frame(scene, cam, cfg, st0))
        profile_render(tag, scene, cam, cfg)
        pools = run_pools(tag, POOLS[2:], scene, cam, cfg, full, dev,
                          n_timed=n)
        ev_pers = pools["persistent"]["events"]
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


# ---------------------------------------------------------------------------
# The general pool (integrator/pool.render_pool): what bounce.supported
# rejects — BVH traversal, russian roulette, material sort, more than
# MAX_FUSED_PRIMS prims.  Plain PyTorch on the card; it launches none of
# K1-K6 (the JAX pool runs no Pallas kernel either).  Five runs, float32,
# the pool width auto (65,536 lanes), depth 100.
# ---------------------------------------------------------------------------

# Eager PyTorch spends about 15 us of host time a launch and the BVH walk
# about 57 launches a step, so a pool iteration takes 50-120 ms on RTOW and
# about 100 iterations drain even one pass (its depth-100 tail): the three
# BVH runs are cut in spp (never in width or depth) to fit the ~180 s these
# phases may add, as PERF.md records.
# 1. `render --scene random --bvh sah` at the CLI's defaults, 200x200, cut
#    from spp16 (four calls of `--chunk` 4 passes) to one call of 4 passes;
#    its 160,000 work items over 65,536 lanes make lanes i and i + 40,000
#    flush one pixel in one iteration.
GEN_CLI = RenderConfig(nx=200, ny=200, spp=4, max_depth=100, seed=0,
                       traversal="bvh")
GEN_CLI_CHUNKS = 1
# 2. the same scene at 512^2 (cut from spp8 to spp1) through the general
#    pool, SAH and median BVH, beside the fused FIFO render of the
#    brute-compiled scene.
GEN_RTOW = RenderConfig(nx=512, ny=512, spp=1, max_depth=100, seed=0,
                        traversal="bvh")
# 3. a scene over 4,096 prims: 70 x 70 spheres and the ground (4,901), brute
#    and SAH, at 512^2 (cut from spp8 to spp1).
GEN_GRID = RenderConfig(nx=512, ny=512, spp=1, max_depth=100, seed=0)
GRID_N = 70 * 70              # bench_bvh_crossover.grid_scene's n
# 4. Cornell, light sampled, russian roulette from depth 4, 512^2 spp16.
GEN_RR = RenderConfig(nx=512, ny=512, spp=16, max_depth=100, seed=0,
                      light_sampling=True, russian_roulette=True,
                      rr_start_depth=4)
# 5. RTOW 200^2 spp16 with the material-sorted shading, against the masked
#    shading.
GEN_SORT = RenderConfig(nx=200, ny=200, spp=16, max_depth=100, seed=0,
                        material_sort=True)
# Timed renders of each general run after its warm-up: cut from 3 to 2 (the
# general renders take 2-10 s each) to keep the whole script well inside its
# time limit with the bench phase.
N_TIMED_GENERAL = 1
# The card against the CPU, both float64 and plain PyTorch, per run's scene
# and options at 24^2 spp2: the same segments, the image within 1e-9.
GEN_SMALL = dict(nx=24, ny=24, spp=2, max_depth=100, seed=0, dtype="f64")


def general_render(scene, cam, cfg, chunks=1):
    """One render from zeros through render_with_stats: `chunks` chained
    calls of cfg.spp passes, as the CLI renders.  Returns (raw sum, segments,
    iterations); a value is fetched before it returns."""
    st = render.init_state(cfg)
    segs, iters = 0, 0
    for _ in range(chunks):
        st, s, i = render.render_with_stats(scene, cam, cfg, st)
        segs, iters = segs + int(s), iters + i
    float(st.raw_sum[0, 0, 0])
    return st.raw_sum, segs, iters


def profiled_render(scene, cam, cfg, chunks=1, first=3, n=1):
    """general_render with pool iterations first .. first + n - 1 of its
    first call under torch.profiler (a whole render holds too many launches
    to trace, and reading each event costs the host ~0.1 ms): returns the
    render's (raw, segments, iterations) and those iterations' device
    events an iteration and the card's busy share of their wall (None when
    the profiler saw no device time).  Wraps pool._step for the one
    render."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    orig = pool._step
    seen, box = [0], {}

    def step(*a, **k):
        seen[0] += 1
        if seen[0] == first:
            torch.cuda.synchronize()
            box["prof"] = profile(activities=[ProfilerActivity.CUDA])
            box["prof"].__enter__()
            box["t0"] = time.perf_counter()
        out = orig(*a, **k)
        if seen[0] == first + n - 1:
            torch.cuda.synchronize()
            box["wall"] = time.perf_counter() - box["t0"]
            box["prof"].__exit__(None, None, None)
        return out

    pool._step = step
    try:
        out = general_render(scene, cam, cfg, chunks)
    finally:
        pool._step = orig
    if "wall" not in box:
        return out, None
    ev = [e for e in box["prof"].events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1e6
    return out, dict(launches=len(ev) / n,
                     busy=busy / box["wall"] if ev else None,
                     iter_ms=box["wall"] * 1e3 / n)


def run_general(tag, what, scene, cam, cfg, chunks=1, n_timed=N_TIMED_GENERAL):
    """A general-pool run: a warm-up render from zeros (one of its steady
    pool iterations profiled for its launches and the card's busy share),
    then n_timed renders from zeros, each image bitwise the warm-up's;
    walls (minimum, median, maximum), exact segments, iterations and peak
    memory.  No kernel of K1-K6 may launch."""
    if bounce.supported(scene, cfg):
        raise AssertionError(f"[{tag}] bounce.supported takes this scene: "
                             f"it would not reach the general pool")
    reset_counts()                            # the main path's counts start
    t0 = time.perf_counter()
    (image, segs, iters), prof = profiled_render(scene, cam, cfg, chunks)
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(n_timed):
        t0 = time.perf_counter()
        img, s, i = general_render(scene, cam, cfg, chunks)
        times.append(time.perf_counter() - t0)
        if (s, i) != (segs, iters) or not torch.equal(img, image):
            raise AssertionError(f"[{tag}] a second render differs: segments "
                                 f"{s} / {segs}, iterations {i} / {iters}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = launch_counts()
    mean = (image / (cfg.spp * chunks)).cpu().numpy()
    med = statistics.median(times)
    log(f"[{tag}] {smi_line()}: {cfg.nx}x{cfg.ny} spp{cfg.spp * chunks}"
        f"{f' in {chunks} calls' if chunks > 1 else ''} depth{cfg.max_depth} "
        f"{what}: m={min(cfg.resolve_pool_rays(), cfg.n_pixels * cfg.spp)} "
        f"segments {segs} in {iters} pool iterations; warm-up "
        f"{warm * 1e3:.1f} ms (one iteration profiled); times_ms "
        f"{[round(t * 1e3, 2) for t in times]}; "
        f"{spread(times)} -> {segs / med:.4e} rays/s; every render bitwise "
        f"the warm-up's; peak memory {peak:.3f} GiB; kernel launches "
        f"{counts}")
    if prof is not None:
        log(f"[{tag}] the warm-up's pool iteration 3 under the profiler: "
            f"{prof['launches']:.0f} device launches an iteration, "
            f"{prof['iter_ms']:.2f} ms an iteration, busy "
            f"{prof['busy']:.1%}" if prof["busy"] is not None else
            f"[{tag}] the profiler recorded no device time: not measured")
    if any(counts.values()):
        raise AssertionError(f"[{tag}] the general pool launched a kernel: "
                             f"{counts}")
    if not np.isfinite(mean).all() or mean.max() <= 0.0:
        raise AssertionError(f"[{tag}] frame is not finite or is black")
    log(f"[{tag}] frame mean {mean.mean():.4f} max {mean.max():.3f}")
    return dict(raw=image, mean=mean, segments=segs, iters=iters,
                times=times, median_s=med, peak_gib=peak, prof=prof)


def check_flush(dev):
    """The general pool's flush on the card (`pool.flush_add_`: rounds of
    index_add_ into unique rows) against the CPU's serial index_add_ in lane
    order, bit for bit, on values whose sum depends on the order: the CLI's
    duplicates (lane i and i + 40,000) and 64-fold ones, with a third of
    the lanes not done."""
    g = torch.Generator().manual_seed(3)
    m = M
    draw = lambda *shape: ((torch.rand(*shape, generator=g) - 0.5)
                           * torch.exp(8.0 * torch.randn(*shape, generator=g)))
    for n_pix in (40000, 1024):
        pix = torch.arange(m) % n_pix
        done = torch.rand(m, generator=g) < 2 / 3
        val = torch.where(done[:, None], draw(m, 3), 0.0)
        raw0 = draw(n_pix, 3)                       # earlier passes
        want = raw0.clone().index_add_(0, pix, val)
        rev = raw0.clone().index_add_(0, pix.flip(0), val.flip(0))
        buf = torch.cat([raw0, torch.zeros(m, 3)]).to(dev)
        got = pool.flush_add_(buf, pix.to(dev), val.to(dev),
                              done.to(dev))[:n_pix].cpu()
        log(f"[general-flush] {m} lanes over {n_pix} pixels: the card's "
            f"flush equals the lane-order add bitwise: "
            f"{torch.equal(got, want)}; pixels where lane order matters "
            f"(the reversed add differs): {int((rev != want).any(1).sum())}")
        if not torch.equal(got, want) or not (rev != want).any():
            raise AssertionError("[general-flush] the card's flush is not "
                                 "the lane-order add")


def check_general_small(dev):
    """Each run's scene and options at 24^2 spp2 depth 100 in float64: the
    general pool on the card against the same pool on the CPU (plain
    PyTorch both), segments and iterations exact and the image within
    1e-9; the material-sorted render bitwise the masked one on the card."""
    rtow, grid = scenes.random_scene(seed=0), grid_spec(GRID_N)
    cases = (("rtow-sah", rtow, "sah", dict(traversal="bvh")),
             ("rtow-median", rtow, "median", dict(traversal="bvh")),
             ("grid-brute", grid, None, {}),
             ("grid-sah", grid, "sah", dict(traversal="bvh")),
             ("cornell-rr", scenes.cornell_box(), None,
              dict(light_sampling=True, russian_roulette=True)),
             ("rtow-sort", rtow, None, dict(material_sort=True)))
    for name, spec, bvh, kw in cases:
        cfg = RenderConfig(**GEN_SMALL, **kw)
        out = {}
        for where in (dev, "cpu"):
            scene, cam = spec_scene(spec, torch.float64, where, bvh)
            raw, segs, iters = pool.render_pool_auto(
                scene, cam, cfg, torch.zeros(cfg.n_pixels, 3,
                                             dtype=torch.float64,
                                             device=where), 0)
            out[str(where)] = (raw.cpu(), int(segs), iters)
        (g, gs, gi), (c, cs, ci) = out[str(dev)], out["cpu"]
        err = float((g - c).abs().max())
        log(f"[general-small] {name}: card / CPU segments {gs} / {cs}, "
            f"iterations {gi} / {ci}, max |image difference| {err:.3e}")
        if (gs, gi) != (cs, ci) or not torch.allclose(g, c, rtol=1e-9,
                                                      atol=1e-9):
            raise AssertionError(f"[general-small] {name}: the card's general "
                                 f"pool differs from the CPU's")
    for dtype in (torch.float64, torch.float32):
        scene, cam = spec_scene(rtow, dtype, dev)
        cfg = RenderConfig(**{**GEN_SMALL, "dtype": dtype_name(dtype)})
        z = torch.zeros(cfg.n_pixels, 3, dtype=dtype, device=dev)
        a = pool.render_pool(scene, cam, cfg, z, 0)
        b = pool.render_pool(scene, cam, cfg.replace(material_sort=True), z,
                             0)
        same = torch.equal(a[0], b[0]) and int(a[1]) == int(b[1])
        log(f"[general-small] rtow {dtype_name(dtype)}: the material-sorted "
            f"render equals the masked one bitwise: {same}")
        if not same:
            raise AssertionError("[general-small] shade_sorted differs from "
                                 "shade on the card")


def phase_general_check(dev):
    check_flush(dev)
    check_general_small(dev)


def phase_general_cli(dev):
    """Run 1: `render --scene random --bvh sah` at the CLI's defaults."""
    scene, cam = spec_scene(scenes.random_scene(seed=0), torch.float32, dev,
                            "sah")
    return run_general("general-cli", "random, SAH BVH", scene, cam, GEN_CLI,
                       chunks=GEN_CLI_CHUNKS)


def phase_general_rtow(dev):
    """Run 2: the RTOW scene at 512^2 through the general pool with the SAH
    and the median BVH, against each other (within 1e-5) and against the
    fused FIFO render of the brute-compiled scene (tests/test_parity.py's
    bounds; segments within tests/test_bounce.py's 0.01 s + 50)."""
    spec = scenes.random_scene(seed=0)
    out = {}
    for bvh in ("sah", "median"):
        scene, cam = spec_scene(spec, torch.float32, dev, bvh)
        out[bvh] = run_general(f"general-rtow-{bvh}", f"RTOW, {bvh} BVH",
                               scene, cam, GEN_RTOW)
    d = np.abs(out["sah"]["mean"] - out["median"]["mean"]).max()
    log(f"[general-rtow] SAH against median: max |difference| {d:.3e} "
        f"(< 1e-5)")
    if not d < 1e-5:
        raise AssertionError("[general-rtow] the SAH and median images differ")
    scene, cam = spec_scene(spec, torch.float32, dev)
    fused_cfg = GEN_RTOW.replace(traversal="brute")
    reset_counts()
    st, fsegs, fiters = render.render_with_stats(scene, cam, fused_cfg,
                                                 render.init_state(fused_cfg))
    kernel, per = routed_kernel(scene, fused_cfg)
    if launch_counts()[kernel] * per != fiters:
        raise AssertionError(f"[general-rtow] the fused render did not run "
                             f"{kernel}")
    fmean = (st.raw_sum / fused_cfg.spp).cpu().numpy()
    diff = np.abs(out["sah"]["mean"] - fmean)
    mae, outliers = diff.mean(), (diff.max(axis=-1) > 0.05).mean()
    gsegs, fsegs = out["sah"]["segments"], int(fsegs)
    log(f"[general-rtow] general (SAH) against the fused render "
        f"({fiters} iterations, {kernel}): MAE {mae:.3e} (< 5e-3), pixels "
        f"off by > "
        f"0.05: {outliers:.4%} (< 1%); segments {gsegs} / {fsegs} "
        f"(|difference| {abs(gsegs - fsegs)} <= {0.01 * gsegs + 50:.0f})")
    if not (mae < 5e-3 and outliers < 0.01
            and abs(gsegs - fsegs) <= 0.01 * gsegs + 50):
        raise AssertionError("[general-rtow] the general pool is off the "
                             "fused render")
    return out


def phase_general_grid(dev):
    """Run 3: 4,901 prims (70 x 70 spheres and the ground) through the brute
    general pool and the SAH BVH, compared as
    tests/test_bvh.py::test_grid_scene_image_identical_brute_vs_bvh does
    (mean |difference| < 2e-3, under 2% of pixels off by > 0.05)."""
    out = {}
    for name, bvh, cfg in (("brute", None, GEN_GRID),
                           ("sah", "sah", GEN_GRID.replace(traversal="bvh"))):
        scene, cam = grid_scene(GRID_N, bvh, device=dev)
        out[name] = run_general(f"general-grid-{name}",
                                f"grid of {scene.sph_r.shape[0]} spheres, "
                                f"{name}", scene, cam, cfg)
    diff = np.abs(out["brute"]["mean"] - out["sah"]["mean"])
    mae, outliers = diff.mean(), (diff.max(axis=-1) > 0.05).mean()
    ratio = out["sah"]["median_s"] / out["brute"]["median_s"]
    log(f"[general-grid] SAH against brute: mean |difference| {mae:.3e} "
        f"(< 2e-3), max {diff.max():.3e}, pixels off by > 0.05 "
        f"{outliers:.4%} (< 2%); wall SAH / brute {ratio:.3f}")
    if not (mae < 2e-3 and outliers < 0.02):
        raise AssertionError("[general-grid] the SAH image is off the brute "
                             "image")
    return out


def phase_general_rr(dev):
    """Run 4: Cornell, light sampled, with russian roulette; its frame mean
    against the fused render's without (an unbiased estimator of the same
    image: within 2%), with fewer segments."""
    scene, cam = spec_scene(scenes.cornell_box(), torch.float32, dev)
    out = run_general("general-rr", "Cornell, russian roulette", scene, cam,
                      GEN_RR)
    plain = GEN_RR.replace(russian_roulette=False)
    st, segs, _ = render.render_with_stats(scene, cam, plain,
                                           render.init_state(plain))
    ref = float((st.raw_sum / plain.spp).mean())
    rel = abs(float(out["mean"].mean()) - ref) / ref
    log(f"[general-rr] frame mean {float(out['mean'].mean()):.5f} against "
        f"{ref:.5f} without roulette (relative {rel:.3e}, < 2e-2); segments "
        f"{out['segments']} against {int(segs)}")
    if not (rel < 2e-2 and out["segments"] < int(segs)):
        raise AssertionError("[general-rr] the roulette render is off")
    return out


def phase_general_sort(dev):
    """Run 5: RTOW with the material-sorted shading, timed, and its image
    bitwise the masked shading's: one render of the general pool called
    directly (render_pool_auto sends RTOW without the sort to the fused
    pool), also timed."""
    scene, cam = spec_scene(scenes.random_scene(seed=0), torch.float32,
                            dev)
    out = run_general("general-sort", "RTOW, material sort", scene, cam,
                      GEN_SORT)
    masked_cfg = GEN_SORT.replace(material_sort=False)
    t0 = time.perf_counter()
    raw, segs, iters = pool.render_pool(
        scene, cam, masked_cfg,
        torch.zeros(masked_cfg.n_pixels, 3, device=dev), 0)
    float(raw[0, 0])
    wall = time.perf_counter() - t0
    same = (torch.equal(out["raw"].reshape(-1, 3), raw)
            and out["segments"] == int(segs) and out["iters"] == iters)
    log(f"[general-sort] sorted against masked shading: bitwise {same}; "
        f"median wall sorted {out['median_s'] * 1e3:.2f} ms, one masked "
        f"render {wall * 1e3:.2f} ms ({int(segs)} segments, {iters} "
        f"iterations)")
    if not same:
        raise AssertionError("[general-sort] the sorted render differs")
    return out, wall


# ---------------------------------------------------------------------------
# The differentiable wavefront (integrator/wavefront.py, render.render_pass,
# render.render_passes): plain PyTorch on the card, threefry keys, no kernel
# (the JAX wavefront runs no Pallas kernel either).  The flagship entry's
# path (`__graft_entry__.entry()` runs render_pass) and the path of the
# parity harness's gradient goldens.
# ---------------------------------------------------------------------------

# wave-check: the card against the CPU, float64, at small sizes: the while
# mode's render_pass (image within 1e-9, exact segments) and the scan's
# gradients of every leaf and camera field (within 1e-9 of the largest
# |gradient| floor, test_parity.py's scale rule)
WAVE_SMALL = (
    ("cornell", scenes.cornell_box,
     dict(nx=16, ny=16, max_depth=8, light_sampling=True)),
    ("cornell_smoke", scenes.cornell_smoke,
     dict(nx=8, ny=8, max_depth=8, light_sampling=True)),
    ("cornell_klein", scenes.cornell_klein, dict(nx=8, ny=8, max_depth=8)),
)
WAVE_GRAD = dict(nx=8, ny=8, spp=1, max_depth=2, seed=0, dtype="f64",
                 differentiable=True)
WAVE_F64_GOLDEN_RTOL = 1e-6       # the card's f64 AD against grad_ad
# two identical f32 gradient runs, and the scan against the while mode
WAVE_REPEAT = RenderConfig(nx=64, ny=64, spp=1, max_depth=8, seed=0,
                           light_sampling=True, differentiable=True)
WAVE_SCAN = RenderConfig(nx=64, ny=64, spp=1, max_depth=100, seed=0,
                         light_sampling=True)
# wave-full: BASELINE config 4 at its nominal 512^2, spp1, depth 100, f32
WAVE_FULL = RenderConfig(nx=512, ny=512, spp=1, max_depth=100, seed=0,
                         light_sampling=True)
# autograd nodes whose CUDA backward adds into a gathered tensor: through
# float atomics (index_add_, scatter_add_) or a sort (index_put_ with
# accumulate=True, embedding's segments: core/vecmath.take)
ACCUMULATING_NODES = {
    "EmbeddingBackward0": "embedding_dense_backward (sorted segments)",
    "IndexBackward0": "index_put_(accumulate=True)",
    "IndexSelectBackward0": "index_add_ (atomicAdd)",
    "GatherBackward0": "scatter_add_ (atomicAdd)",
    "TakeAlongDimBackward0": "scatter_add_ (atomicAdd)",
}


def wave_grads(scene, cam, cfg, loss_fn=None, walk=False):
    """Every float leaf's and camera field's gradient of a differentiable
    render (the mean image's mean, or loss_fn(mean)): (loss, {name:
    gradient}, and with `walk` the graph's accumulating nodes {name:
    count})."""
    params, rest = build.partition(scene)
    params = {k: v.detach().clone().requires_grad_()
              for k, v in params.items()}
    c = Camera(**{f: getattr(cam, f).detach().clone().requires_grad_()
                  for f in CAMERA_FIELDS})
    mean, _ = render.render_image(build.combine(params, rest), c, cfg)
    loss = mean.mean() if loss_fn is None else loss_fn(mean)
    nodes, seen, todo = {}, set(), [loss.grad_fn] if walk else []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        name = type(fn).__name__
        if name in ACCUMULATING_NODES:
            nodes[name] = nodes.get(name, 0) + 1
        todo.extend(f for f, _ in fn.next_functions)
    leaves = list(params.values()) + [getattr(c, f) for f in CAMERA_FIELDS]
    names = list(params) + [f"camera:{f}" for f in CAMERA_FIELDS]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss, {n: (torch.zeros_like(x) if g is None else g).cpu().double()
                  for n, x, g in zip(names, leaves, grads)}, nodes


def rel_to_floor(got, want):
    """|got - want| over max(|want|, 5% of the largest |want|): the scale
    rule of tests/test_parity.py:85, over every named gradient at once."""
    top = max(float(w.abs().max()) for w in want.values() if w.numel())
    return {k: float(((got[k] - w).abs()
                      / torch.clamp(w.abs(), min=0.05 * top + 1e-300)).max())
            if w.numel() else 0.0 for k, w in want.items()}, top


def wave_pass(scene, cam, cfg, pass_idx=0):
    """The while mode's pass `pass_idx`: its RayState (radiance, segments,
    bounces run) through render._trace_passes, the pass's keys as
    render_pass derives them."""
    dev = scene.device
    key = rng.fold_in(rng.root_key(cfg.seed, dev), pass_idx)
    return render._trace_passes(scene, cam, cfg, key, cfg.torch_dtype)


def check_wave_small(dev):
    """Per WAVE_SMALL scene, float64, the card against the CPU: the while
    mode's pass (image within 1e-9, segments and bounces exact) and the
    scan's gradients at 8^2 depth 2 (within 1e-9 of the floor)."""
    for name, spec_fn, kw in WAVE_SMALL:
        spec = spec_fn()
        cfg = RenderConfig(spp=1, seed=0, dtype="f64", **kw)
        gcfg = RenderConfig(**WAVE_GRAD,
                            light_sampling=kw.get("light_sampling", False))
        out = {}
        for where in (dev, "cpu"):
            scene, cam = spec_scene(spec, torch.float64, where)
            st = wave_pass(scene, cam, cfg)
            _, grads, _ = wave_grads(scene, cam, gcfg)
            out[str(where)] = (st.radiance.cpu(), int(st.segments), st.depth,
                               grads)
        (g, gs, gd, gg), (c, cs, cd, cg) = out[str(dev)], out["cpu"]
        err = float((g - c).abs().max())
        rel, top = rel_to_floor(gg, cg)
        worst = max(rel, key=rel.get)
        log(f"[wave-check] {name} f64 {cfg.nx}x{cfg.ny} depth"
            f"{cfg.max_depth}: card / CPU segments {gs} / {cs}, bounces "
            f"{gd} / {cd}, max |image difference| {err:.3e}; gradients of "
            f"{len(rel)} leaves at 8x8 depth 2: worst {worst} "
            f"{rel[worst]:.3e} of the floor (largest |gradient| {top:.4e})")
        if ((gs, gd) != (cs, cd) or not torch.allclose(g, c, rtol=1e-9,
                                                      atol=1e-9)
                or rel[worst] >= 1e-9
                or not all(bool(torch.isfinite(x).all())
                           for x in gg.values())):
            raise AssertionError(f"[wave-check] {name}: the card's wavefront "
                                 f"differs from the CPU's")


def check_wave_goldens(dev):
    """The six parity configs on the card: f64 AD on the small workload
    against grad_ad, and f32 AD on the big one (16^2 spp32, spp128 for
    config 5) against grad_ad_big within each config's f32_grad_rtol
    (tests/test_parity.py::test_gradients_match_f64_oracle)."""
    out = {}
    for pc in parity.PARITY_CONFIGS:
        g = np.load(os.path.join(ROOT, parity.GOLDEN_DIR, f"{pc.name}.npz"))
        t0 = time.perf_counter()
        ad64 = parity.probe_gradients(pc, torch.float64, "ad", device=dev)
        t1 = time.perf_counter()
        ad32 = parity.probe_gradients(pc, torch.float32, "ad", big=True,
                                      device=dev)
        t2 = time.perf_counter()
        scale64 = np.maximum(np.abs(g["grad_ad"]),
                             0.05 * np.abs(g["grad_ad"]).max() + 1e-7)
        rel64 = np.abs(ad64 - g["grad_ad"]) / scale64
        ref = g["grad_ad_big"]
        scale = np.maximum(np.abs(ref), 0.05 * np.abs(ref).max() + 1e-7)
        rel32 = np.abs(ad32 - ref) / scale
        log(f"[wave-check] {pc.name}: f64 AD {ad64.tolist()} against "
            f"grad_ad, worst {rel64.max():.3e} ({t1 - t0:.2f} s); f32 AD "
            f"16x16 spp{pc.grad_spp_big} {ad32.tolist()} against "
            f"grad_ad_big {ref.tolist()}: rel {rel32.round(4).tolist()} "
            f"(bound {pc.f32_grad_rtol}; {t2 - t1:.2f} s)")
        if (not np.isfinite(ad32).all() or rel64.max() >= WAVE_F64_GOLDEN_RTOL
                or (rel32 >= pc.f32_grad_rtol).any()):
            raise AssertionError(f"[wave-check] {pc.name}: the card's "
                                 f"gradients miss the goldens")
        out[pc.name] = dict(rel64=float(rel64.max()),
                            rel32=rel32.tolist(), f32_s=t2 - t1)
    return out


def check_wave_modes(dev):
    """f32 on the card: the scan's image bitwise the while mode's (64^2
    depth 100), and several passes in one wavefront bitwise one at a
    time."""
    scene, cam = spec_scene(scenes.cornell_box(), torch.float32, dev)
    wh = wave_pass(scene, cam, WAVE_SCAN)
    sc = wave_pass(scene, cam, WAVE_SCAN.replace(differentiable=True))
    same = (torch.equal(wh.radiance, sc.radiance)
            and int(wh.segments) == int(sc.segments))
    log(f"[wave-check] scan against while, f32 {WAVE_SCAN.nx}x"
        f"{WAVE_SCAN.ny} depth {WAVE_SCAN.max_depth}: bitwise {same}; segments {int(wh.segments)}; bounces {wh.depth} (while) / "
        f"{sc.depth} (scan)")
    cfg = RenderConfig(nx=16, ny=16, spp=6, max_depth=8, seed=0,
                       light_sampling=True, differentiable=True)
    st0 = render.init_state(cfg, device=scene.device)
    batched, _ = render.render_passes(scene, cam, cfg, st0)
    seq = st0
    for _ in range(cfg.spp):
        seq = render.render_pass(scene, cam, cfg, seq, seq.sample_count)
    one = torch.equal(batched.raw_sum, seq.raw_sum)
    log(f"[wave-check] {cfg.spp} passes in one wavefront against one at a "
        f"time, f32 16x16: bitwise {one}")
    if not (same and one):
        raise AssertionError("[wave-check] the wavefront's modes differ")


def check_wave_repeat(dev):
    """Two identical f32 gradient runs (WAVE_REPEAT, Cornell): bitwise
    equal, or the leaves that differ and by how much, beside the graph's
    nodes whose backward accumulates into a gathered tensor."""
    scene, cam = spec_scene(scenes.cornell_box(), torch.float32, dev)
    _, a, nodes = wave_grads(scene, cam, WAVE_REPEAT, walk=True)
    _, b, _ = wave_grads(scene, cam, WAVE_REPEAT)
    differ = {k: float((a[k] - b[k]).abs().max()) for k in a
              if not torch.equal(a[k], b[k])}
    named = {k: f"{n} x {ACCUMULATING_NODES[k]}" for k, n in nodes.items()}
    log(f"[wave-check] two f32 gradient runs ({WAVE_REPEAT.nx}x"
        f"{WAVE_REPEAT.ny} depth {WAVE_REPEAT.max_depth}, {len(a)} leaves): bitwise equal: {not differ}; leaves that differ (max "
        f"|difference|): {differ or 'none'}; accumulating backward nodes "
        f"in the graph: {named}")
    return dict(differ=differ, nodes=nodes)


def phase_wave_check(dev):
    reset_counts()
    check_wave_small(dev)
    goldens = check_wave_goldens(dev)
    check_wave_modes(dev)
    repeat = check_wave_repeat(dev)
    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"[wave-check] a kernel launched: {counts}")
    return dict(goldens=goldens, repeat=repeat)


def profiled_bounce(fn, which=3):
    """Run fn() with the `which`-th wavefront bounce under torch.profiler:
    (fn's result, that bounce's device launches, its wall ms and the card's
    busy share of it).  Wraps wavefront._bounce for the call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    orig, seen, box = wavefront._bounce, [0], {}

    def bounce_fn(*a, **k):
        seen[0] += 1
        if seen[0] != which:
            return orig(*a, **k)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = orig(*a, **k)
            torch.cuda.synchronize()
            box["wall"] = time.perf_counter() - t0
        box["ev"] = [e for e in prof.events()
                     if e.device_type == DeviceType.CUDA]
        return out

    wavefront._bounce = bounce_fn
    try:
        out = fn()
    finally:
        wavefront._bounce = orig
    ev = box["ev"]
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1e6
    return out, len(ev), box["wall"] * 1e3, (busy / box["wall"] if ev
                                             else None)


def profiled_step(step):
    """One call of step() under torch.profiler (device events only): its
    device launches, wall ms, the card's busy share and {kernel name:
    (device us, launches)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    table = {}
    for e in ev:
        us, k = table.get(e.name, (0.0, 0))
        table[e.name] = (us + e.time_range.elapsed_us(), k + 1)
    busy = sum(us for us, _ in table.values()) / 1e6
    return len(ev), wall * 1e3, (busy / wall if ev else None), table


def wave_render(scene, cam, cfg):
    """render_pass in the while mode, the flagship entry's call: a warm-up
    (its third bounce profiled), then N_TIMED passes chained from zeros."""
    reset_counts()
    t0 = time.perf_counter()
    first, launches, b_ms, busy = profiled_bounce(
        lambda: wave_pass(scene, cam, cfg))
    float(first.radiance[0, 0])
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    st, times = render.init_state(cfg, device=scene.device), []
    for i in range(N_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = render.render_pass(scene, cam, cfg, st, i)
        float(st.raw_sum[0, 0, 0])
        times.append(time.perf_counter() - t0)
        if i == 0:
            frame0 = st.raw_sum.clone()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = launch_counts()
    segs, med = int(first.segments), statistics.median(times)
    same = torch.equal(frame0.reshape(-1, 3), first.radiance)
    mean = (st.raw_sum / N_TIMED).cpu().numpy()
    log(f"[wave-full] render_pass, while mode, {cfg.nx}x{cfg.ny} depth"
        f"{cfg.max_depth} f32 ({smi_line()}): pass 0 {segs} segments in "
        f"{first.depth} bounces; warm-up {warm * 1e3:.1f} ms (bounce 3 "
        f"profiled); times_ms {[round(t * 1e3, 2) for t in times]}; "
        f"{spread(times)} -> {segs / med:.4e} rays/s; bounce 3: {launches} "
        f"device launches, {b_ms:.2f} ms, busy "
        f"{'not measured' if busy is None else f'{busy:.1%}'}; peak memory "
        f"{peak:.3f} GiB; the timed pass 0 bitwise the warm-up: {same}; "
        f"kernel launches {counts}")
    if any(counts.values()) or not same:
        raise AssertionError("[wave-full] render_pass launched a kernel or "
                             "changed between calls")
    if not np.isfinite(mean).all() or mean.max() <= 0.0:
        raise AssertionError("[wave-full] frame is not finite or is black")
    log(f"[wave-full] frame mean {mean.mean():.4f} max {mean.max():.3f}")
    return dict(segments=segs, bounces=first.depth, times=times,
                median_s=med, launches=launches, bounce_ms=b_ms, busy=busy,
                peak_gib=peak)


def wave_step(scene, cam, cfg):
    """The differentiable training step: the scan's render of cfg, loss
    sum(mean^2)/numel, every float leaf's and camera field's gradient; a
    warm-up, then N_TIMED_WAVE steps chained by params -= 1e-6 grad.  Then
    steps at depths 2 and 4 under the profiler: launches a bounce (their
    difference over 2 bounces) and the busy share."""
    loss_fn = lambda mean: (mean ** 2).sum() / mean.numel()
    reset_counts()

    def step(scene, cam, cfg=cfg):
        loss, grads, _ = wave_grads(scene, cam, cfg, loss_fn)
        return float(loss.detach()), grads

    t0 = time.perf_counter()
    _, grads = step(scene, cam)
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(N_TIMED_WAVE):
        params, rest = build.partition(scene)
        scene = build.combine({k: v - 1e-6 * grads[k].to(v)
                               for k, v in params.items()}, rest)
        cam = Camera(**{f: getattr(cam, f) - 1e-6 * grads[
            f"camera:{f}"].to(getattr(cam, f)) for f in CAMERA_FIELDS})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, grads = step(scene, cam)
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = launch_counts()
    st = wave_pass(scene, cam, cfg)
    segs = int(st.segments)
    prof = {d: profiled_step(lambda d=d: step(
        scene, cam, cfg.replace(max_depth=d))) for d in (2, 4)}
    per_bounce = (prof[4][0] - prof[2][0]) / 2
    log_profile("wave-full step depth 4", prof[4][1], prof[4][3])
    med = statistics.median(times)
    log(f"[wave-full] training step, scan, {cfg.nx}x{cfg.ny} depth"
        f"{cfg.max_depth} f32: {cfg.max_depth + 1} bounces, {segs} live "
        f"segments; warm-up {warm * 1e3:.1f} ms; times_ms "
        f"{[round(t * 1e3, 2) for t in times]}; {spread(times)} -> "
        f"{segs / med:.4e} fwd+bwd rays/s; peak memory {peak:.3f} GiB; "
        f"profiled steps at depth 2 / 4: {prof[2][0]} / {prof[4][0]} device "
        f"launches ({per_bounce:.0f} a bounce, forward, recompute and "
        f"backward), {prof[2][1]:.1f} / {prof[4][1]:.1f} ms, busy "
        f"{'not measured' if prof[4][2] is None else f'{prof[4][2]:.1%}'} "
        f"at depth 4; kernel launches {counts}")
    if any(counts.values()):
        raise AssertionError(f"[wave-full] the step launched a kernel: "
                             f"{counts}")
    if not all(bool(torch.isfinite(g).all()) for g in grads.values()):
        raise AssertionError("[wave-full] gradients are not finite")
    touched = sorted(k for k, g in grads.items() if bool((g != 0).any()))
    log(f"[wave-full] every leaf's gradient finite; nonzero for {touched}")
    return dict(segments=segs, times=times, median_s=med, peak_gib=peak,
                per_bounce=per_bounce, busy=prof[4][2])


def phase_wave_full(dev):
    scene, cam = spec_scene(scenes.cornell_box(), torch.float32, dev)
    out = wave_render(scene, cam, WAVE_FULL)
    out["step"] = wave_step(scene, cam,
                            WAVE_FULL.replace(differentiable=True))
    return out


# ---------------------------------------------------------------------------
# parallel: parallel/ over torch.distributed on one card.  NCCL takes one
# rank a card, so the collectives run at world 1 over NCCL: each gives back
# its input, and every sharded entry point must equal its unsharded twin bit
# for bit.  What world 1 cannot reach (a band's first pixel past 0, an
# interleave's stride past 1) runs as the bodies of a virtual 4 shards, one
# after another on the card, assembled by hand.  One card measures no
# scaling over ranks.
# ---------------------------------------------------------------------------

PAR_FWD = FULL                     # Cornell 512^2 spp16 depth 100, light
PAR_BWD = FULL_BWD                 # Cornell 512^2 spp8 depth 100, light
PAR_SHARDS = 4                     # the virtual shards of the bodies
PAR_WAVE = RenderConfig(nx=128, ny=128, spp=1, max_depth=100, seed=0,
                        light_sampling=True)
PAR_LR = 1e-6


def same_pool(tag, got, want):
    """(raw, segments, iters) of a sharded render against the unsharded
    one: image and segments bit for bit; iterations logged."""
    raw, segs, iters = got
    same = (torch.equal(raw.reshape(-1, 3), want[0].reshape(-1, 3))
            and int(segs) == int(want[1]))
    log(f"[parallel] {tag}: image and segments bitwise the unsharded "
        f"render's: {same} (segments {int(segs)} / {int(want[1])}, "
        f"iterations {iters} / {want[2]})")
    if not same:
        raise AssertionError(f"[parallel] {tag} differs from the unsharded "
                             f"render")


def par_pools(mesh, scene, cam):
    """The two sharded forward pools against the unsharded frame of their
    pool: render_pool_sharded (routed as render_pool_auto routes the frame,
    on the card in f32 to the persistent pool, K4) against
    render_pool_auto, render_pool_balanced (the FIFO pool, K1) against
    render_pool_fused; and the bodies of PAR_SHARDS virtual shards of the
    FIFO pool assembled by hand."""
    from scheme_raytrace_torch.parallel import (render_pool_balanced,
                                                render_pool_sharded)
    cfg, dev = PAR_FWD, scene.device
    zeros = lambda n: torch.zeros(n, 3, device=dev)
    routed = pool.render_pool_auto(scene, cam, cfg, zeros(cfg.n_pixels), 0)
    want = pool_fused.render_pool_fused(scene, cam, cfg, zeros(cfg.n_pixels),
                                        0)
    kernel, per = routed_kernel(scene, cfg)
    reset_counts()                            # the main path's counts start
    got = {"sharded": render_pool_sharded(scene, cam, cfg, mesh),
           "balanced": render_pool_balanced(scene, cam, cfg, mesh)}
    counts = launch_counts()
    same_pool("render_pool_sharded, world 1", got["sharded"], routed)
    same_pool("render_pool_balanced, world 1", got["balanced"], want)
    log(f"[parallel] the two sharded renders' kernel launches: {counts}")
    expect = {"K1": want[2]}                  # the balanced pool's
    expect[kernel] = expect.get(kernel, 0) + routed[2] // per
    if {k: v for k, v in counts.items() if v} != expect:
        raise AssertionError(f"[parallel] the sharded pools' launches "
                             f"{counts}, expected {expect}")
    runs = {"render_pool_auto": lambda: pool.render_pool_auto(
                scene, cam, cfg, zeros(cfg.n_pixels), 0),
            "render_pool_sharded": lambda: render_pool_sharded(
                scene, cam, cfg, mesh),
            "render_pool_balanced": lambda: render_pool_balanced(
                scene, cam, cfg, mesh)}
    times = {name: [] for name in runs}
    for _ in range(N_TIMED):
        for name, fn in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            int(fn()[1])
            times[name].append(time.perf_counter() - t0)
    log(f"[parallel] {smi_line()}: {cfg.nx}x{cfg.ny} spp{cfg.spp} depth"
        f"{cfg.max_depth} f32, in turns: " + "; ".join(
            f"{name} {spread(t)}" for name, t in times.items()))
    lp = cfg.n_pixels // PAR_SHARDS
    bands = [pool_fused.render_pool_fused(scene, cam, cfg, zeros(lp), 0,
                                          pix0=s * lp)
             for s in range(PAR_SHARDS)]
    combs = [pool_fused.render_pool_fused(scene, cam, cfg,
                                          zeros(cfg.n_pixels), 0,
                                          item_stride=PAR_SHARDS,
                                          item_offset=s)
             for s in range(PAR_SHARDS)]
    for name, parts, raw in (
            ("row bands", bands, torch.cat([b[0] for b in bands])),
            ("interleaved", combs, sum(c[0] for c in combs))):
        segs = [int(p[1]) for p in parts]
        log(f"[parallel] {PAR_SHARDS} {name}' bodies: segments {segs} "
            f"(max / min {max(segs) / min(segs):.3f}), iterations "
            f"{[p[2] for p in parts]}")
        same_pool(f"{PAR_SHARDS} {name} assembled", (raw, sum(segs), max(
            p[2] for p in parts)), want)
    return counts["K1"], counts["K4"]


def par_fused_step(mesh, scene, cam):
    """train_step_fused at 512^2 spp8 against render_diff_fused's step on
    the same trip count: leftover 0, new parameters bit for bit; a warm-up
    and N_TIMED steps of each in turns; the all-reduce of the gradient
    bucket by CUDA events."""
    import torch.distributed as dist
    from scheme_raytrace_torch.parallel import (calibrate_iters_sharded,
                                                train_step_fused)
    cfg = PAR_BWD
    n_iters = calibrate_iters_sharded(scene, cam, cfg, mesh, slack=1.1)
    params, rest = build.partition(scene)
    target = torch.zeros(cfg.ny, cfg.nx, 3, device=scene.device)

    def unsharded():
        loss_fn = lambda raw: torch.sum(
            ((raw / cfg.spp).reshape(cfg.ny, cfg.nx, 3) - target) ** 2) / (
                cfg.ny * cfg.nx * 3)
        _, loss, _, leftover, grads = fwd_bwd(scene, cam, cfg, n_iters,
                                              params, rest, loss_fn)
        return ({k: v.detach() - PAR_LR * grads[k]
                 for k, v in params.items()}, loss, leftover)

    sharded = lambda: train_step_fused(params, rest, cam, cfg, target, mesh,
                                       n_iters, lr=PAR_LR)
    reset_counts()                            # the main path's counts start
    new, loss, leftover = sharded()
    float(loss)
    counts = launch_counts()
    ref, ref_loss, ref_left = unsharded()
    same = all(torch.equal(new[k], ref[k]) for k in ref)
    log(f"[parallel] train_step_fused {cfg.nx}x{cfg.ny} spp{cfg.spp} depth"
        f"{cfg.max_depth} f32, world 1 {dist.get_backend(mesh.group)}: "
        f"n_iters {n_iters}, leftover {int(leftover)} (unsharded "
        f"{int(ref_left)}), loss {float(loss):.6e} / {float(ref_loss):.6e}; "
        f"new parameters bitwise the unsharded step's: {same}; launches "
        f"forward {counts['K1']} backward {counts['K2']}")
    if int(leftover) != 0 or not same or float(loss) != float(ref_loss):
        raise AssertionError("[parallel] train_step_fused differs from the "
                             "unsharded step or did not drain")
    block = -(-n_iters // pool_fused.FLUSH_EVERY) * pool_fused.FLUSH_EVERY
    if not counts["K1"] == counts["K2"] == block:
        raise AssertionError(f"[parallel] launches {counts} != {block}")
    times = {"sharded": [], "unsharded": []}
    for _ in range(N_TIMED):
        for name, fn in (("sharded", sharded), ("unsharded", unsharded)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(fn()[1])
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    bucket = torch.cat([v.reshape(-1) for v in params.values()])
    ar_ms = kernel_ms(lambda: dist.all_reduce(bucket, group=mesh.group))
    log(f"[parallel] {smi_line()}: train_step_fused {spread(times['sharded'])}"
        f"; render_diff_fused step {spread(times['unsharded'])} (in turns); "
        f"the gradient all-reduce of {bucket.numel()} floats "
        f"({bucket.numel() * 4 + 4} B with the loss) {ar_ms * 1e3:.2f} us "
        f"by CUDA events")
    return dict(launches=counts["K1"], bwd_launches=counts[
        "K2"], times=times, allreduce_ms=ar_ms)


def par_wave(mesh, scene, cam):
    """render_sharded and one train_step (the wavefront, no kernel) against
    the unsharded wavefront on the shard's keys (rows = ny, shard 0):
    bitwise."""
    from scheme_raytrace_torch.parallel import render as prender
    cfg = PAR_WAVE
    reset_counts()
    t0 = time.perf_counter()
    img = prender.render_sharded(scene, cam, cfg, mesh)
    float(img[0, 0, 0])
    t_render = time.perf_counter() - t0
    want = prender._mean_image_local(scene, cam, cfg, cfg.ny,
                                     cfg.torch_dtype, 0)
    params, rest = build.partition(scene)
    target = torch.zeros_like(want)
    t0 = time.perf_counter()
    new, loss = prender.train_step(params, rest, cam, cfg, target, mesh,
                                   lr=PAR_LR)
    float(loss)
    t_step = time.perf_counter() - t0
    counts = launch_counts()
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in params.items()}
    dcfg = cfg.replace(differentiable=True)
    mean = prender._mean_image_local(build.combine(leaves, rest), cam, dcfg,
                                     cfg.ny, cfg.torch_dtype, 0)
    ref_loss = torch.sum((mean - target) ** 2) / (cfg.ny * cfg.nx * 3)
    grads = torch.autograd.grad(ref_loss, list(leaves.values()),
                                allow_unused=True)
    ref_loss = ref_loss.detach()
    ref = {k: v.detach() - PAR_LR * (torch.zeros_like(v) if g is None else g)
           for (k, v), g in zip(leaves.items(), grads)}
    same_img = torch.equal(img, want)
    same_step = (all(torch.equal(new[k], ref[k]) for k in ref)
                 and float(loss) == float(ref_loss))
    log(f"[parallel] {smi_line()}: render_sharded {cfg.nx}x{cfg.ny} spp"
        f"{cfg.spp} depth{cfg.max_depth} f32 {t_render * 1e3:.1f} ms, "
        f"bitwise the unsharded wavefront's: {same_img}; train_step "
        f"{t_step * 1e3:.1f} ms, new parameters bitwise: {same_step}; "
        f"kernel launches {counts}")
    if not same_img or not same_step or any(counts.values()):
        raise AssertionError("[parallel] the sharded wavefront differs or "
                             "launched a kernel")
    if not bool(torch.isfinite(img).all()) or float(img.max()) <= 0.0:
        raise AssertionError("[parallel] render_sharded is not finite or "
                             "black")


def phase_parallel(dev):
    import torch.distributed as dist
    from scheme_raytrace_torch.parallel import distributed as pdist
    with pdist.single_process(dev) as mesh:
        log(f"[parallel] world {mesh.size}, backend "
            f"{dist.get_backend(mesh.group)}, rank {mesh.rank} on "
            f"{mesh.device}: NCCL takes one rank a card, so on one card the "
            f"collectives run at world 1 (no scaling over ranks measured)")
        scene, cam = cornell(torch.float32, dev)
        fwd, fwd_k4 = par_pools(mesh, scene, cam)
        step = par_fused_step(mesh, scene, cam)
        par_wave(mesh, scene, cam)
    return dict(launches=fwd + step["launches"], persist_launches=fwd_k4,
                bwd_launches=step["bwd_launches"], step=step)


# ---------------------------------------------------------------------------
# cli: python -m scheme_raytrace_torch on the card.  `render` runs as a user
# runs it, in a process of its own; `scenes`, `probe`, the resume and `view`
# run in this process through the same parser.
# ---------------------------------------------------------------------------

CLI_RENDER = ["--scene", "cornell", "--light-sampling", "--nx", "512",
              "--ny", "512", "--chunk", "4"]
CLI_PROBE = ["probe", "100", "100", "--light-sampling"]
CLI_VIEW = ["view", "--scene", "cornell", "--light-sampling", "--port", "0",
            "--spp", "3"]


def png_rgb(data):
    """The RGB8 pixels of the viewer's unfiltered PNG."""
    import zlib
    w, h = (int.from_bytes(data[i:i + 4], "big") for i in (16, 20))
    at, idat = 8, b""
    while at < len(data):
        n = int.from_bytes(data[at:at + 4], "big")
        if data[at + 4:at + 8] == b"IDAT":
            idat += data[at + 8:at + 8 + n]
        at += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    return rows[:, 1:].reshape(h, w, 3)


def chunks_in_process(built, n, state=None):
    """n chunks of the CLI's build (cli._build: scene, camera and chunk
    config) through render_with_stats, as the CLI chains them."""
    _, scene, cam, cfg = built
    state = state or render.init_state(cfg, device=scene.device)
    for _ in range(n):
        state, _, _ = render.render_with_stats(scene, cam, cfg, state)
    return state


def ppm_of(state, path):
    done = int(state.sample_count)
    render.write_ppm(path, state.raw_sum.cpu().numpy() / max(done, 1))
    with open(path) as f:
        return f.read()


def cli_out(argv):
    """Standard output of the CLI's main(argv) in this process."""
    import contextlib
    import io
    from scheme_raytrace_torch.__main__ import main as cli_main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main(argv)
    return buf.getvalue()


def cli_view(dev):
    """`view` on port 0 for 3 passes: the served PNG is to_u8
    of the published mean (display rows), a click probe answers."""
    import urllib.request
    from scheme_raytrace_torch import __main__ as cli
    from scheme_raytrace_torch.viewer import Viewer
    args = cli.parser().parse_args(CLI_VIEW)
    _, scene, cam, cfg = cli._build(args)
    v = Viewer(scene, cam, cfg, scene_name=args.scene,
               spp_target=args.spp, out=os.path.join(ROOT, "build",
                                                     "view.ppm"),
               host=args.host, port=args.port, chunk=args.chunk)
    v.start_server()
    base = f"http://{args.host}:{v.port}"
    get = lambda p: urllib.request.urlopen(base + p, timeout=60).read()
    try:
        t0 = time.perf_counter()
        state = v.render_loop()
        wall = time.perf_counter() - t0
        status = json.loads(get("/status"))
        frame = png_rgb(get("/frame.png"))
        mean = v._mean
        probe = json.loads(get("/probe?x=100&y=100"))
    finally:
        v.stop()
    same = np.array_equal(frame, render.to_u8(mean)[::-1])
    log(f"[cli] view {cfg.nx}x{cfg.ny} depth{cfg.max_depth} on port "
        f"{v.port}: {status['samples']} passes in {wall * 1e3:.1f} ms "
        f"({smi_line()}), {status['rays_per_s']:.4e} rays/s the last; the "
        f"PNG is to_u8 of the published mean: {same}; probe (100, 100): "
        f"{probe}")
    if (not same or status["samples"] != args.spp
            or int(state.sample_count) != args.spp
            or not np.allclose(probe["mean_radiance"],
                               mean[probe["y"], probe["x"]])):
        raise AssertionError("[cli] the viewer's page disagrees with its "
                             "render")


def phase_cli(dev):
    """`render` in a process of its own against the same four chunks in
    this one (PPM bitwise); its saved state resumed for one more chunk
    (bitwise the in-process fifth chunk); `scenes`, `probe`, `view`."""
    out_dir = os.path.join(ROOT, "build", "cli")
    os.makedirs(out_dir, exist_ok=True)
    ppm, st = (os.path.join(out_dir, n) for n in ("render.ppm", "state.npz"))
    argv = ["render", *CLI_RENDER, "--spp", "16", "--out", ppm,
            "--save-state", st]
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "scheme_raytrace_torch",
                          *argv], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    wall = time.perf_counter() - t0
    log(f"[cli] python -m scheme_raytrace_torch {' '.join(argv[:-4])}: exit "
        f"{run.returncode} in {wall:.1f} s ({smi_line()}), process start "
        f"included:\n" + run.stdout.strip() + ("\n" + run.stderr[-2000:]
                                               if run.returncode else ""))
    if (run.returncode != 0
            or f"device={torch.device(dev).type}" not in run.stdout):
        raise AssertionError("[cli] render failed or did not run on the card")
    from scheme_raytrace_torch import __main__ as cli
    built = cli._build(cli.parser().parse_args(argv))
    state = chunks_in_process(built, 4)
    same = ppm_of(state, ppm + ".want") == open(ppm).read()
    log(f"[cli] its PPM equals render.write_ppm of the same four chunks "
        f"rendered in this process: {same}")
    reset_counts()                            # the main path's counts start
    out = cli_out(["render", *CLI_RENDER, "--spp", "20", "--resume", st,
                   "--out", ppm + ".resumed"])
    kernel, _ = routed_kernel(built[1], built[3])
    launches = launch_counts()[kernel]
    resumed = ppm_of(chunks_in_process(built, 1, state),
                     ppm + ".want5") == open(ppm + ".resumed").read()
    log(f"[cli] --resume of its state for one more chunk ({launches} "
        f"{kernel} launches) equals the fifth chunk in this process: "
        f"{resumed}:\n{out.strip()}")
    listed = cli_out(["scenes"]).split()
    probe = cli_out(CLI_PROBE)
    nums = [float(x) for line in probe.splitlines() if "mean" in line
            for x in line.replace("(", " ").replace(")", " ").replace(
                ",", " ").split() if x[0].isdigit() or x[0] == "-"]
    log(f"[cli] scenes: {listed}\n{probe.strip()}")
    if (not same or not resumed or launches == 0
            or listed != list(scenes.SCENES) or len(nums) != 4
            or not np.isfinite(nums).all()):
        raise AssertionError("[cli] a subcommand disagrees with its "
                             "in-process render")
    cli_view(dev)
    return dict(launches=launches if kernel == "K1" else 0,
                persist_launches=launches if kernel == "K4" else 0)


# ---------------------------------------------------------------------------
# tools: entry.py and the instruments of scheme_raytrace_torch/tools on the
# card, each through the functions a user's command runs, at the JAX tools'
# defaults; each prints its own lines.  Their assertions (drained steps,
# shapes, finite losses, check_vjp_grads' bound) fail the phase.
# ---------------------------------------------------------------------------

# cut from (..., 4096, 16384): PERF.md.  4,096 spheres (4,097 prims, the
# general pool's route) took 35-48 s of the phase, most of it the SAH walk;
# the general-grid phase drives that route over 4,901 prims.
TOOLS_CROSSOVER = (256, 1024)


def phase_tools(dev):
    """entry(), dryrun_multichip(1) and the tools, one after another, each
    with its seconds and its K1 / K2 launches (the counts set to 0 just
    before the first and read just after the last)."""
    from scheme_raytrace_torch import entry
    from scheme_raytrace_torch.tools import (
        bench_bvh_crossover, bench_diff, bench_material_sort, bench_scaling,
        bench_scenes, bench_shard_overhead, check_vjp_grads,
        diag_fwdbwd_variance, profile_diff_step, profile_hotpath,
        profile_scatter)

    def flagship():
        fn, args = entry.entry()
        st = fn(*args)
        ok = (tuple(st.raw_sum.shape) == (64, 64, 3)
              and bool(torch.isfinite(st.raw_sum).all())
              and float(st.raw_sum.max()) > 0.0
              and int(st.sample_count) == 1)
        log(f"[tools] entry(): render_pass 64x64 spp1 depth8 on "
            f"{st.raw_sum.device}: frame mean {float(st.raw_sum.mean()):.4f}"
            f", finite, sample_count {int(st.sample_count)}: {ok}")
        if not ok:
            raise AssertionError("[tools] entry()'s pass is not a finite "
                                 "64x64 frame")

    def scenes_cornell():
        r = bench_scenes.bench_one("cornell")
        if r["impl"] != "persistent":             # the routed frame: K4
            raise AssertionError(f"[tools] bench_scenes ran {r['impl']}")
        return r

    def crossover():
        rows = bench_bvh_crossover.run(TOOLS_CROSSOVER)
        # n spheres and the ground: the routed frame's K4 up to
        # MAX_FUSED_PRIMS prims
        if any({"brute", "bvh"} - set(r) or r["impl"] != (
                "persistent" if n + 1 <= bounce.MAX_FUSED_PRIMS
                else "general")
               for n, r in rows.items()):
            raise AssertionError(f"[tools] bench_bvh_crossover: {rows}")
        return rows

    runs = (("entry", flagship),
            ("dryrun_multichip", lambda: entry.dryrun_multichip(1)),
            ("bench_scenes", scenes_cornell),
            ("bench_diff", bench_diff.run),
            ("check_vjp_grads", check_vjp_grads.run),
            ("profile_diff_step", profile_diff_step.run),
            ("profile_hotpath", profile_hotpath.run),
            ("profile_scatter", profile_scatter.run),
            ("diag_fwdbwd_variance", lambda: diag_fwdbwd_variance.run(5)),
            ("bench_bvh_crossover", crossover),
            ("bench_material_sort", bench_material_sort.run),
            ("bench_shard_overhead", bench_shard_overhead.run),
            ("bench_scaling", bench_scaling.run))
    out = {}
    reset_counts()                            # the tools' counts start
    for name, fn in runs:
        before = launch_counts()
        t0 = time.perf_counter()
        log(f"[tools] --- {name}")
        result = fn()
        counts = launch_counts()
        k1 = counts["K1"] - before["K1"]
        k2 = counts["K2"] - before["K2"]
        log(f"[tools] {name}: {time.perf_counter() - t0:.1f} s, "
            f"bounce_step launches {k1}, bounce_step_bwd launches {k2}")
        out[name] = dict(result=result, launches=k1, bwd_launches=k2)
    counts = launch_counts()
    log(f"[tools] {smi_line()}: the tools launched bounce_step "
        f"{counts['K1']} and bounce_step_bwd {counts['K2']}"
        f" times; {counts}")
    if counts["K1"] == 0 or counts["K2"] == 0:
        raise AssertionError("[tools] K1 or K2 was never launched")
    return dict(launches=counts["K1"],
                bwd_launches=counts["K2"], runs=out)


# ---------------------------------------------------------------------------
# bench: the headline bench's twin (scheme_raytrace_torch/bench.py) in a
# process of its own, as a user runs it, then one render of its 1024^2
# frame in this process: the row bands under the profiler and by hand.
# ---------------------------------------------------------------------------

BENCH_1024 = FULL.replace(nx=1024, ny=1024)   # 4 row bands of 256 rows
PROFILE_TRIES = 3   # profiles of the 1024^2 render until one has every launch
RECORDED_FULL = (11646756, 224)     # PERF.md's Cornell 512^2 warm-up render
BENCH_METRIC = "rays/s (path segments, Cornell 512x512 light-sampled)"


def bench_keys():
    """The keys of the dict the root bench.py prints (read from its source,
    which is not imported), then "card"."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys] + ["card"]
    raise AssertionError("[bench] bench.py prints no dict")


def bench_line(err, label):
    """The times (s), segments and iterations of a `bench[label]:` line."""
    line = next(ln for ln in err.splitlines()
                if ln.startswith(f"bench[{label}]:"))
    times = [float(t) / 1e3 for t in
             re.search(r"times_ms=\[([^\]]*)\]", line)[1].split(",")]
    head, _, tail = line.partition("warm-up")
    nums = {k: int(v) for k, v in
            re.findall(r"\b(segs|iters|n_iters)=(\d+)", head)}
    warm = re.search(r"segs=(\d+) iters=(\d+)", tail)
    return dict(times=times, warm=warm and (int(warm[1]), int(warm[2])),
                **nums)


def bench_child():
    """`python -m scheme_raytrace_torch.bench` in a process of its own: its
    exit code, its last line's keys and values, its three measurements'
    spreads; returns its JSON line and its log's numbers by label."""
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "scheme_raytrace_torch.bench"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    wall = time.perf_counter() - t0
    log(f"[bench] python -m scheme_raytrace_torch.bench: exit "
        f"{run.returncode} in {wall:.1f} s ({smi_line()}), process start "
        f"and kernel loads included:\n" + run.stderr.strip() + "\n"
        + run.stdout.strip())
    if run.returncode != 0:
        raise AssertionError("[bench] the bench failed")
    out = json.loads(run.stdout.strip().splitlines()[-1])
    lines = {label: bench_line(run.stderr, label)
             for label in ("fwd", "fwd+bwd", "fwd-1024")}
    for label, ln in lines.items():
        t = ln["times"]
        log(f"[bench] {label}: {len(t)} timed runs, {spread(t)}, spread "
            f"(max - min) / min {(max(t) - min(t)) / min(t):.1%}; segments "
            f"{ln['segs']}")
    rates = ("value", "fwd_bwd_rays_per_s", "fwd_1024_rays_per_s")
    bad = [k for k in rates if not (out[k] or 0) > 0]
    if (list(out) != bench_keys() or bad or out["metric"] != BENCH_METRIC
            or (out["step_impl"], out["fwd_bwd_step_impl"])
            != ("persistent", "cuda")
            or out["n_chips"] != torch.cuda.device_count()
            or out["card"] != smi_line()):
        raise AssertionError(f"[bench] its line is not bench.py's on the "
                             f"card (keys {list(out)}, rates not positive "
                             f"{bad}): {out}")
    return out, lines


def phase_bench(dev, full):
    """The bench's twin as a user runs it (its warm-up 512^2 render's
    segments equal to the `full` phase's FIFO render's, or to the recorded
    count without it: the routed persistent pool traces the same paths in
    another number of iterations), then one 1024^2 spp16 render through
    render_with_stats under the profiler (the counts set to 0 just before
    and read just after; profiled again, up to PROFILE_TRIES times, while
    the trace lacks some of the routed kernel's launches): its launches,
    the busy share and the peak memory; its 4 bands rendered again one by
    one through the routed pool, each bitwise its rows of the frame."""
    out, lines = bench_child()
    want = (full["first"]["segments"] if full else RECORDED_FULL[0])
    warm = lines["fwd"]["warm"]
    log(f"[bench] its 512^2 warm-up render: {warm[0]} segments in {warm[1]} "
        f"iterations; the {'full phase' if full else 'recorded count'}: "
        f"{want} segments")
    if warm[0] != want:
        raise AssertionError("[bench] the warm-up render's count differs")

    scene, cam = cornell(torch.float32, dev)
    cfg = BENCH_1024
    kernel, per = routed_kernel(scene, cfg)
    name = {"K1": K1, "K4": K4}[kernel]
    band_fn = {"K1": pool_fused.render_pool_fused,
               "K4": persist.render_pool_persistent}[kernel]
    n_pix = cfg.n_pixels
    band_pix = pool._band_rows(cfg.ny, cfg.nx) * cfg.nx
    n_bands = n_pix // band_pix
    # what earlier phases still hold is not the render's
    held = torch.cuda.memory_allocated()
    for attempt in range(1, PROFILE_TRIES + 1):
        got = []
        reset_counts()                        # the main path's count starts
        torch.cuda.reset_peak_memory_stats()
        # a warm-up render, then one under the profiler (the card alone)
        wall_ms, table = device_kernels(lambda: got.append(
            render.render_with_stats(scene, cam, cfg, render.init_state(cfg))),
            host_ops=False)
        launches = launch_counts()[kernel]
        peak = torch.cuda.max_memory_allocated() - held
        st, segs, iters = got[-1]
        seen = sum(k for n, (_, k) in table.items() if name in n)
        if round(seen) * per == iters:
            break
        # the profiler's trace of ~54,000 kernels now and then lacks a few
        # iterations' device events (948 and 944 of 952 K1 launches in two
        # whole runs of this script on an H100): that trace cannot give the
        # count or the busy share, so the render is profiled again
        log(f"[bench] profile {attempt}: the profiler recorded {seen:.0f} of "
            f"{iters // per} {kernel} launches (the wrapper counted "
            f"{launches} over the warm-up and this render): a trace short of "
            f"device events")
    segs = int(segs)
    busy = log_profile("bench", wall_ms, table, ours=(name,))
    raw = st.raw_sum.reshape(-1, 3)
    bands = []
    for b in range(n_bands):
        sl = slice(b * band_pix, (b + 1) * band_pix)
        r_b, s_b, i_b = band_fn(
            scene, cam, cfg, torch.zeros(band_pix, 3, device=dev), 0,
            pix0=b * band_pix, total_pix=n_pix)
        bands.append(dict(iters=i_b, segments=int(s_b),
                          same=torch.equal(r_b, raw[sl]),
                          ok=bool(torch.isfinite(raw[sl]).all())
                          and float(raw[sl].max()) > 0.0))
    log(f"[bench] {cfg.nx}x{cfg.ny} spp{cfg.spp} depth{cfg.max_depth} "
        f"({smi_line()}): {n_bands} bands of {band_pix} pixels; {segs} "
        f"segments in {iters} iterations; {launches} {name} launches "
        f"over the warm-up and the profiled render ({seen:.0f} in the "
        f"profiled one by the profiler); {wall_ms:.1f} ms under the "
        f"profiler, busy {'not measured' if busy is None else f'{busy:.1%}'}"
        f"; peak memory {peak / 2 ** 30:.3f} GiB above the "
        f"{held / 2 ** 30:.3f} GiB held before; the bands by hand: "
        f"iterations {[b['iters'] for b in bands]}, segments "
        f"{[b['segments'] for b in bands]}, bitwise the frame's rows "
        f"{[b['same'] for b in bands]}, finite and not black "
        f"{[b['ok'] for b in bands]}")
    if (n_bands != 4 or launches * per != 2 * iters
            or round(seen) * per != iters
            or not all(b["same"] and b["ok"] for b in bands)
            or sum(b["iters"] for b in bands) != iters
            or sum(b["segments"] for b in bands) != segs):
        raise AssertionError("[bench] the 1024^2 render's bands disagree")
    return dict(line=out, lines=lines,
                launches=launches if kernel == "K1" else 0,
                persist_launches=launches if kernel == "K4" else 0,
                segments=segs, iters=iters, busy=busy, peak=peak)


# The scenes of the kernel-tile phase: the eight scenes of the full-size
# paths and the two tie plans, each with its kernel phase's lanes.
PATH_SCENES = ("cornell", "rtow", "textured", "cornell_smoke", "bezier",
               "cornell_bezier", "klein", "cornell_klein")
TILE_SCENES = PATH_SCENES + ("cornell_tie", "spheres_tie")


def tile_scene(name, dtype, dev):
    """(scene, camera, config, lane box) of a TILE_SCENES entry at its
    full-size configuration; the box is lane_inputs' and packed_state's
    box and aim keywords, None for a klein scene (klein_rays)."""
    kw = {}
    if name == "cornell":
        (scene, cam), cfg = cornell(dtype, dev), FULL
    elif name == "rtow":
        scene, cam, box, _ = sphere_scene("rtow", dtype, dev)
        cfg, kw = RTOW, dict(box=box)
    elif name in ("textured", "cornell_smoke"):
        scene, cam, cfg, box, _ = texture_scene(
            "smoke" if name == "cornell_smoke" else name, dtype, dev)
        kw = dict(box=box)
    elif name in BEZIER_SCENES:
        scene, cam, cfg, box, aim, _ = bezier_scene(name, dtype, dev)
        kw = dict(box=box, aim=aim)
    elif name in KLEIN_SCENES:
        scene, cam, cfg, _ = klein_setup(name, dtype, dev)
        kw = None
    else:
        spec_fn, box, aim = TIE_SCENES[name]
        scene, cam = spec_scene(spec_fn(), dtype, dev)
        cfg = FULL.replace(light_sampling=name == "cornell_tie")
        kw = dict(box=box, aim=aim)
    return scene, cam, cfg, kw


def tile_case(name, dtype, dev):
    """(plan, pk, inputs) of a TILE_SCENES entry at its full-size
    configuration; inputs(m, seed) draws m lanes as the scene's kernel phase
    draws them (Cornell's cube, a sphere scene's box, rays aimed into the
    curves' box, at the fractal, or at a tie plan's duplicated primitive)."""
    scene, cam, cfg, kw = tile_scene(name, dtype, dev)
    plan = bounce.pool_plan(scene, cfg)
    pk = bounce.pack(scene, cam, plan, dtype)

    def inputs(m, seed):
        if kw is None:
            return klein_inputs(m, cfg, dtype, dev, scene, seed=seed)
        return lane_inputs(m, cfg, dtype, dev, seed=seed, **kw)
    return plan, pk, inputs


def packed_tile_case(name, dev, m=M):
    """(setup, state) of a TILE_SCENES entry for the packed kernels: its
    full-size f32 plan and queue (packed_setup, at m lanes), and state(seed),
    a packed state of m lanes whose rays are drawn as the kernel phases draw
    them (packed_state with the scene's lane box, klein_packed_state)."""
    scene, cam, cfg, kw = tile_scene(name, torch.float32, dev)
    plan, pk, q, sb = packed_setup(dev, scene, cam, cfg)
    q = dict(q, m=m)

    def state(seed):
        if kw is None:
            return klein_packed_state(m, q["n_work"], plan.max_depth, dev,
                                      scene, seed=seed)
        return packed_state(m, q["n_work"], plan.max_depth, dev, seed=seed,
                            **kw)
    return (plan, pk, q, sb), state


def bits(x):
    """A float tensor's bits, for comparisons bit for bit (NaN included)."""
    return x.view(torch.int64 if x.dtype == torch.float64 else torch.int32)




def tie_alone(name, dtype, dev):
    """(plan, pk) of a tie plan without its duplicate, at the tie plan's
    configuration."""
    spec = {"cornell_tie": scenes.cornell_box,
            "spheres_tie": scenes.three_spheres}[name]()
    s0, c0 = spec_scene(spec, dtype, dev)
    p0 = bounce.pool_plan(s0, FULL.replace(
        light_sampling=name == "cornell_tie"))
    return p0, bounce.pack(s0, c0, p0, dtype)


def phase_kernel_tile(dev, build):
    """K1 and K2 at every tile width against the one-thread search (w = 1)
    on TILE_SCENES, float32 and float64: K1's 14 outputs and K2's 13 lane
    cotangents bit for bit on every lane, K2's dpk within its stated bound
    of w = 1's, two K2 launches at the chosen width bitwise equal; the tie
    plans' duplicated primitive never wins.  Then, in float32, the widths'
    device times (CUDA events), swept up and down.  Then K3 and K4 on the
    same plans' packed states (packed_tile), with `build`'s registers."""
    sweep = {}
    for dtype in (torch.float32, torch.float64):
        for name in TILE_SCENES:
            tag = f"{dtype_name(dtype)}-{name}"
            plan, pk, inputs = tile_case(name, dtype, dev)
            w1, w2 = bounce.tile_width(plan), bounce.tile_width(plan, bwd=True)
            ins = inputs(M, 0)
            k1 = {w: flat(bounce.step_cuda(plan, pk, *ins, tile=w))
                  for w in bounce.TILE_WIDTHS}
            ref = k1[1]
            for w, got in k1.items():
                bad = ((bits(got[0]) != bits(ref[0])).any(0)
                       | (got[1] != ref[1]))
                if bad.any():
                    raise AssertionError(f"[kernel-tile] {tag}: K1 at w={w} "
                                         f"differs from w=1 on "
                                         f"{int(bad.sum())} lanes")
            if name in TIE_SCENES:
                # the duplicate (another material) is never the winner: the
                # kernel on the plan without it gives the same lanes
                p0, pk0 = tie_alone(name, dtype, dev)
                alone = flat(bounce.step_cuda(p0, pk0, *ins))
                same = (torch.equal(bits(alone[0]), bits(ref[0]))
                        and torch.equal(alone[1], ref[1]))
                n_hit = int(bounce.hit_record(p0, pk0, *ins[:4],
                                              *ins[5:9])[3]["hit"].sum())
                log(f"[kernel-tile] {tag}: {n_hit} of {M} lanes hit; the "
                    f"kernel equals itself on the plan without the duplicate: "
                    f"{same}")
                if not same:
                    raise AssertionError(f"[kernel-tile] {tag}: a tie kept "
                                         f"the duplicate")
            bins = inputs(M_BWD, 3)
            r = np.random.default_rng(103)
            cts = bounce.split_lanes([torch.tensor(x, dtype=dtype, device=dev)
                                      for x in r.normal(size=(13, M_BWD))])
            k2 = {w: lanes_of(bounce.step_cuda_bwd(plan, pk, *bins, *cts,
                                                   tile=w))
                  for w in bounce.TILE_WIDTHS}
            again = lanes_of(bounce.step_cuda_bwd(plan, pk, *bins, *cts))
            torch.cuda.synchronize()
            ref_pk, ref_lanes = k2[1]
            lim = k2_dpk_bound(dtype, ref_pk, 1e-10 if plan.n_kleins
                               else BWD_F64["dpk"])
            worst = 0.0
            for w, (g_pk, g_lanes) in k2.items():
                n_lane = int((bits(g_lanes) != bits(ref_lanes)).any(0).sum())
                share = float(((g_pk - ref_pk).abs() / lim).max())
                worst = max(worst, share)
                if n_lane or share > 1.0:
                    raise AssertionError(
                        f"[kernel-tile] {tag}: K2 at w={w}: {n_lane} lanes "
                        f"differ from w=1, dpk at {share:.3g} of its bound")
            if not (torch.equal(bits(again[0]), bits(k2[w2][0]))
                    and torch.equal(bits(again[1]), bits(k2[w2][1]))):
                raise AssertionError(f"[kernel-tile] {tag}: two K2 launches "
                                     f"at w={w2} differ")
            log(f"[kernel-tile] {tag}: K1 at w = 2, 4, 8 equals w = 1 bit for "
                f"bit on all {M} lanes (14 outputs); K2's 13 lane cotangents "
                f"likewise on all {M_BWD}, dpk at most {worst:.3g} of its "
                f"bound from w = 1's; two K2 launches at the chosen w={w2} "
                f"bitwise equal; chosen K1 w={w1}")
            if dtype == torch.float32:
                sweep[name] = tile_sweep(plan, pk, ins, bins, cts)
                sweep[name]["chosen"] = dict(k1=w1, k2=w2)
    log_tile_sweep(sweep)
    for name in TILE_SCENES:
        packed = packed_tile(name, dev, build)
        sweep[name]["chosen"].update(packed.pop("chosen"))
        sweep[name].update(packed)
    return sweep


def packed_tile(name, dev, build):
    """K3 and K4 at every tile width against one thread a lane (w = 1) on a
    TILE_SCENES plan's packed states (f32, M lanes): K3's 16 state rows bit
    for bit; one K4 chunk of CHUNK_T iterations bit for bit w = 1's and
    CHUNK_T K3 launches' at w = 1 (the state, every flush row, the
    segments), and two chunks at the chosen width equal; on a tie plan, K3
    equal to itself on the plan without the duplicate.  Then the widths'
    device times (CUDA events, 1, 2, 4, 8 and back), each variant's
    registers and spills (`build`), its resident blocks an SM and the
    launch's waves at each width.  Returns {k3, k4: {w: [ms up, ms down]},
    res: {k3, k4: resources}, chosen: {k3, k4}}."""
    tag = f"kernel-tile packed-{name}"
    (plan, pk, q, sb), state_of = packed_tile_case(name, dev)
    T, widths = persist.CHUNK_T, bounce.TILE_WIDTHS
    chosen = dict(k3=bounce.tile_width(plan), k4=persist.tile_width(plan))
    st3, st4 = state_of(0), state_of(1)
    k3 = {w: bounce.step_packed_cuda(plan, pk, sb, st3, **q, tile=w)
          for w in widths}
    k4 = {w: persist.chunk_cuda(plan, pk, sb, st4, T=T, **q, tile=w)
          for w in widths}
    chain, _ = k3_chunk(plan, pk, sb, st4, q, T, tile=1, ops=False)
    again = persist.chunk_cuda(plan, pk, sb, st4, T=T, **q)
    torch.cuda.synchronize()
    for w in widths:
        n_bad = int((bits(k3[w]) != bits(k3[1])).any(0).sum())
        same = same_chunk(k4[w], k4[1]) + same_chunk(k4[w], chain)
        if n_bad or not all(same):
            raise AssertionError(
                f"[{tag}] w={w}: K3 differs from w=1 on {n_bad} lanes; K4 "
                f"against w=1 and against {T} K3 launches (state, flush, "
                f"segments): {same}")
    if not all(same_chunk(again, k4[chosen["k4"]])):
        raise AssertionError(f"[{tag}] two K4 chunks at w={chosen['k4']} "
                             f"differ")
    live = int((st3.view(torch.int32)[0] < q["n_work"]).sum())
    log(f"[{tag}] K3 at w = 2, 4, 8 equals w = 1 bit for bit on all {M} "
        f"lanes (16 rows; {live} live); one K4 chunk of T={T} at every w "
        f"equals w = 1 and {T} K3 launches bit for bit (state, flush rows, "
        f"segments: {int(chain[2].sum())}); two chunks at the chosen "
        f"w={chosen['k4']} equal; chosen K3 w={chosen['k3']}")
    if name in TIE_SCENES:
        p0, pk0 = tie_alone(name, torch.float32, dev)
        alone = bounce.step_packed_cuda(p0, pk0, sb, st3, **q, tile=1)
        ins = packed_lanes(plan, sb, st3, q)
        n_hit = int((bounce.hit_record(p0, pk0, *ins[:4], *ins[5:9])[3]["hit"]
                     & ins[4]).sum())
        same = torch.equal(bits(alone), bits(k3[1]))
        log(f"[{tag}] {n_hit} of {live} live lanes hit; K3 equals itself on "
            f"the plan without the duplicate: {same}")
        if not same:
            raise AssertionError(f"[{tag}] a tie kept the duplicate")
    out = dict(k3={}, k4={}, res={}, chosen=chosen)
    for w in widths + widths[::-1]:
        out["k3"].setdefault(w, []).append(kernel_ms(
            lambda: bounce.step_packed_cuda(plan, pk, sb, st3, **q, tile=w)))
        out["k4"].setdefault(w, []).append(kernel_ms(
            lambda: persist.chunk_cuda(plan, pk, sb, st4, T=T, **q, tile=w),
            10))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    feats = bounce.kernel_features(plan)
    for key, kern in (("k3", K3), ("k4", K4)):
        res = build[cuda_build.variant_name(kern, feats)][0]
        regs = res["registers"]
        out["res"][key] = dict(
            registers=regs, spills=res["spill_stores"],
            resident=bounce.resident_blocks(regs),
            waves={w: bounce.launch_waves(M, w, regs, sms) for w in widths})
        r = out["res"][key]
        times = (f"w={w} {a * 1e3:.2f} / {b * 1e3:.2f}"
                 for w, (a, b) in sorted(out[key].items()))
        log(f"[{tag}] sweep {key} (us, up / down; chosen {chosen[key]}): "
            + ", ".join(times)
            + f"; {regs} registers, {r['spills']} B spilled, "
            f"{r['resident']} blocks of {bounce.THREADS} an SM, waves on "
            f"{sms} SMs " + ", ".join(f"w={w} {n}"
                                      for w, n in r["waves"].items()))
    return out


def phase_persist_w1(dev):
    """K4 at one thread a lane (w = 1) on the eight scenes of the full-size
    paths: one chunk of CHUNK_T iterations from the kernel phases' packed
    states (packed_tile_case, seed 1), timed by CUDA events, the faster of
    two.  It calls only what the port had before K4 took a width (then
    chunk_cuda ran one thread a lane and took no `tile`), so this script,
    copied to the root of an older tree, times that tree's K4 alike: two
    trees run in turns in one call separate K4's loop without its block
    barrier from its tile."""
    one = ({"tile": 1} if "tile" in inspect.signature(
        persist.chunk_cuda).parameters else {})
    out = {}
    for name in PATH_SCENES:
        (plan, pk, q, sb), state_of = packed_tile_case(name, dev)
        st = state_of(1)
        out[name] = min(kernel_ms(lambda: persist.chunk_cuda(
            plan, pk, sb, st, T=persist.CHUNK_T, **q, **one), 10)
            for _ in range(2))
    log(f"[persist-w1] K4 at w = 1, T={persist.CHUNK_T}, ms a chunk (the "
        f"faster of two), from {ROOT}: "
        + ", ".join(f"{name} {ms:.4f}" for name, ms in out.items()))
    return out


def tile_sweep(plan, pk, ins, bins, cts):
    """Device time of K1 and K2 at each tile width, in turns (1, 2, 4, 8,
    then 8, 4, 2, 1): {k1, k2, k2_sum: {w: [ms up, ms down]}}, K2's without
    and k2_sum with the sum of its partials (its wrapper's)."""
    dev, dt = bins[1].device, bins[1].dtype
    out = dict(k1={}, k2={}, k2_sum={})
    for w in bounce.TILE_WIDTHS + bounce.TILE_WIDTHS[::-1]:
        k1 = kernel_ms(lambda: bounce.step_cuda(plan, pk, *ins, tile=w))
        k2_all = kernel_ms(lambda: bounce.step_cuda_bwd(plan, pk, *bins,
                                                        *cts, tile=w))
        parts = bounce.bwd_partials(plan, M_BWD, w, dt, dev).zero_()
        k2 = k2_all - kernel_ms(lambda: parts.sum(dim=0))
        for key, ms in (("k1", k1), ("k2", k2), ("k2_sum", k2_all)):
            out[key].setdefault(w, []).append(ms)
    return out


def log_tile_sweep(sweep):
    """The sweep's table: each scene's times at each width, up and down."""
    for name, sw in sweep.items():
        for key in ("k1", "k2", "k2_sum"):
            log(f"[kernel-tile] sweep {name} {key} (us, up / down; chosen "
                f"{sw['chosen']['k1' if key == 'k1' else 'k2']}): "
                + ", ".join(f"w={w} {a * 1e3:.2f} / {b * 1e3:.2f}"
                            for w, (a, b) in sorted(sw[key].items())))


def phase_probes(dev):
    """K5 and K6: the probes' own entry points with the counts reset just
    before (the path: K5 one launch, K6 every case in one launch), then each
    kernel against its plain version; K6's one launch against its eleven
    single-case launches and each case alone, K5 against the card's launch
    floor (an empty kernel on K5's grid) and the floor of a launch that
    moves its bytes (a copy on its grid), timed in turns."""
    reset_counts()
    ops_line = probe_ops.main()
    loops_ok, ext_ok = probe_loops.main()
    launches = dict(probe_ops=launch_counts()["K5"],
                    probe_loops=launch_counts()["K6"])
    log(f"[probes] probe_ops.main(): {ops_line}; probe_loops.main(): "
        f"{loops_ok}, extension {ext_ok}; launches {launches}")
    if (not all(loops_ok.values()) or not all(ext_ok.values())
            or not ops_line.startswith("ok: True")):
        raise AssertionError("[probes] a probe's main failed")
    n_cases = len(probe_loops.ALL_CASES)
    if launches != dict(probe_ops=1, probe_loops=1):
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
    rows = probe_loops.loops_cuda_all(x)
    for row, (name, plain) in zip(rows, probe_loops.ALL_CASES.items()):
        if not torch.equal(probe_loops.loops_cuda(name, x), plain(x)):
            raise AssertionError(f"[probes] K6 case {name} differs from its "
                                 f"plain version")
        if not (torch.equal(row, plain(x))
                and torch.equal(row, probe_loops.loops_cuda(name, x))):
            raise AssertionError(f"[probes] K6's one launch: row {name} "
                                 f"differs from its plain version or its "
                                 f"single-case launch")
    hit = float((probe_loops.ext_bezier_seeds(x) < 100.0).float().mean())
    kl_hit = float((probe_loops.ext_klein_march(x) < 100.0).float().mean())
    log(f"[probes] K6: all {len(probe_loops.CASES)} cases and the extension "
        f"{list(probe_loops.EXT_CASES)} bitwise equal to their plain "
        f"versions, one case a launch and all {n_cases} in one launch (each "
        f"row also bitwise its single-case launch); the bezier loop form "
        f"hits on {hit:.1%} of the elements, the klein loop form on "
        f"{kl_hit:.1%}")
    # in turns: K5, the empty launch, the copy, the copy, the empty launch,
    # K5; the eleven launches, the one launch, the one launch, the eleven
    k5 = lambda: probe_ops.probe_cuda(pack, item)
    empty = lambda: probe_ops.empty_cuda(pack, item)
    copy = lambda: probe_ops.copy_cuda(pack, item)
    k5_turns = [kernel_ms(f) for f in (k5, empty, copy, copy, empty, k5)]
    eleven = lambda: [probe_loops.loops_cuda(n, x)
                      for n in probe_loops.ALL_CASES]
    one = lambda: probe_loops.loops_cuda_all(x)
    k6_turns = [kernel_ms(f, n) for f, n in ((eleven, 5), (one, 20),
                                             (one, 20), (eleven, 5))]
    k5_ms, floor_ms = min(k5_turns[0], k5_turns[5]), min(k5_turns[1],
                                                         k5_turns[4])
    copy_ms = min(k5_turns[2:4])
    k6_ms, k6_eleven = min(k6_turns[1:3]), min(k6_turns[0], k6_turns[3])
    case_ms = {n: kernel_ms(lambda n=n: probe_loops.loops_cuda(n, x), 10)
               for n in probe_loops.ALL_CASES}
    floor_case = max(case_ms, key=case_ms.get)
    # the dependent chain alone: FORI_CARRY5 on one block of 128 elements,
    # less the launch floor
    x1 = x[:1].contiguous()
    chain_ms = kernel_ms(lambda: probe_loops.loops_cuda("fori_carry5", x1),
                         10) - floor_ms
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True,
        timeout=30).stdout.split()[0])
    k5_plain, k5_pl = device_ms(lambda: probe_ops.probe_plain(pack, item), 5)
    k6_plain, k6_pl = device_ms(lambda: [f(x) for f in
                                         probe_loops.ALL_CASES.values()], 1)
    at_floor = k5_ms - floor_ms <= max(0.1 * floor_ms, 0.3e-3)
    log("[probes] device time, in turns (us): " + ", ".join(
        f"{name} {t * 1e3:.3f}" for name, t in zip(
            ("K5", "empty", "copy", "copy", "empty", "K5"), k5_turns))
        + f": K5 {k5_ms * 1e3:.3f} us against the launch floor "
        f"{floor_ms * 1e3:.3f} us, {'at' if at_floor else 'above'} it "
        f"(within 10% or 0.3 us); the floor of a launch that moves K5's "
        f"bytes {copy_ms * 1e3:.3f} us, K5 {(k5_ms - copy_ms) * 1e3:.3f} us "
        f"above it; plain {k5_plain * 1e3:.2f} us ({k5_pl:.0f} launches)")
    log(f"[probes] device time, in turns (us): K6 eleven launches "
        f"{k6_turns[0] * 1e3:.2f}, one launch {k6_turns[1] * 1e3:.2f}, one "
        f"launch {k6_turns[2] * 1e3:.2f}, eleven launches "
        f"{k6_turns[3] * 1e3:.2f}: the one launch {k6_ms * 1e3:.2f} us, "
        f"{k6_eleven / k6_ms:.2f} times faster than the eleven; plain "
        f"{k6_plain:.2f} ms ({k6_pl:.0f} launches)")
    log("[probes] K6 each case alone (us): " + ", ".join(
        f"{n} {t * 1e3:.2f}" for n, t in case_ms.items())
        + f"; the floor is set by {floor_case}")
    log(f"[probes] K6 dependent chain: fori_carry5 on one block of 128 "
        f"elements {(chain_ms + floor_ms) * 1e3:.2f} us, less the launch "
        f"floor {chain_ms * 1e3:.2f} us for its 1,000 iterations: "
        f"{chain_ms * 1e3:.2f} ns, {chain_ms * mhz:.1f} cycles at the SM "
        f"clock read after it ({mhz:.0f} MHz), an iteration")
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
    log(f"[probes] bounds: K5 {k5_b[0] * 1e6:.2f} ns ({k5_b[1]}; "
        f"{k5_b[0] / k5_ms:.2%} of K5's time, the launch floor "
        f"{floor_ms / k5_b[0]:.0f} times it), K6 {k6_b[0] * 1e3:.2f} us "
        f"({k6_b[1]}; {k6_b[0] / k6_ms:.1%} of the one launch, "
        f"{k6_b[0] / k6_eleven:.1%} of the eleven; twice it with no FMA; "
        f"the early-exit loop ran {trips} iterations)")
    return dict(launches=launches,
                k5=dict(max_abs_err=ops_err, ms=k5_ms, plain_ms=k5_plain,
                        bound_ms=k5_b[0], bound_by=k5_b[1],
                        launch_floor_ms=floor_ms, copy_floor_ms=copy_ms,
                        at_launch_floor=at_floor),
                k6=dict(max_abs_err=0.0, ms=k6_ms, plain_ms=k6_plain,
                        bound_ms=k6_b[0], bound_by=k6_b[1],
                        eleven_launches_ms=k6_eleven, case_ms=case_ms,
                        floor_case=floor_case, chain_ms=chain_ms))


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
    "pools-200": lambda dev, r: phase_pools_200(dev),
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
    "kernel-tile": lambda dev, r: phase_kernel_tile(dev, r["build"]),
    "persist-w1": lambda dev, r: phase_persist_w1(dev),
    "general-check": lambda dev, r: phase_general_check(dev),
    "general-cli": lambda dev, r: phase_general_cli(dev),
    "general-rtow": lambda dev, r: phase_general_rtow(dev),
    "general-grid": lambda dev, r: phase_general_grid(dev),
    "general-rr": lambda dev, r: phase_general_rr(dev),
    "general-sort": lambda dev, r: phase_general_sort(dev),
    "wave-check": lambda dev, r: phase_wave_check(dev),
    "wave-full": lambda dev, r: phase_wave_full(dev),
    "parallel": lambda dev, r: phase_parallel(dev),
    "cli": lambda dev, r: phase_cli(dev),
    "tools": lambda dev, r: phase_tools(dev),
    "bench": lambda dev, r: phase_bench(dev, r.get("full")),
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
    sweep = r["kernel-tile"]
    # each scene's chosen tile width and its times at every width (the
    # faster of the sweep's two passes), K2's without its partials' sum, K3's
    # and K4's on packed states
    tile = lambda key: {name: dict(
        chosen=sw["chosen"][key], ms={w: min(t) for w, t in sw[key].items()})
        for name, sw in sweep.items()}
    # the full-size paths of the later slices: (forward, persistent, fwd+bwd)
    later = {**{k: v[:3] for k, v in tex_full.items()},
             **{k: v[:3] for k, v in bez_full.items()},
             **{k: v[:3] for k, v in kl_full.items()}}
    par, cli, tools, bench = (r["parallel"], r["cli"], r["tools"],
                              r["bench"])
    k1_launches = (full["launches"] + full_bwd["launches"]
                   + pools["strided"]["launches"] + sph_full["launches"]
                   + sph_bwd["launches"]
                   + sum(f["launches"] + b["launches"]
                         for f, _, b in later.values())
                   + par["launches"] + cli["launches"] + tools["launches"]
                   + bench["launches"])
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
    log(f"[paths] bounce_step / bounce_persist launches: the sharded pools "
        f"and train_step_fused (world 1) {par['launches']} / "
        f"{par['persist_launches']}, the CLI's resumed chunk "
        f"{cli['launches']} / {cli['persist_launches']}, the bench's 1024^2 "
        f"render (4 bands; its warm-up and its profiled run) "
        f"{bench['launches']} / {bench['persist_launches']}; "
        f"bounce_step_bwd launches: train_step_fused "
        f"{par['bwd_launches']}")
    log("[paths] the tools phase: " + ", ".join(
        f"{name} {t['launches']} / {t['bwd_launches']}"
        for name, t in tools["runs"].items())
        + " (bounce_step / bounce_step_bwd launches)")
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
        "tile": tile("k1"),
    }, {
        "name": "bounce_step_bwd",
        "route": "cuda",
        "source": src + "bounce_step_bwd.cu",
        "replaces": "scheme_raytrace_tpu/integrator/bounce.py:1687",
        "launches": (full_bwd["bwd_launches"] + sph_bwd["bwd_launches"]
                     + sum(b["bwd_launches"] for _, _, b in later.values())
                     + par["bwd_launches"] + tools["bwd_launches"]),
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
        "tile": tile("k2"),
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
        "tile": tile("k3"),
    }, {
        "name": "bounce_persist",
        "route": "cuda",
        "source": src + "bounce_persist.cu",
        "replaces": "scheme_raytrace_tpu/integrator/persist.py:114",
        "launches": (pools["persistent"]["launches"]
                     + sph_persist["launches"]
                     + sum(pers["launches"] for _, pers, _ in later.values())
                     + par["persist_launches"] + cli["persist_launches"]
                     + bench["persist_launches"]),
        **on(chunk),
        "library_ms": None,
        "rtow_227_spheres": on(chunk_sph),
        "textured": on(packed_tex["textured"][1]),
        "cornell_smoke": on(packed_tex["smoke"][1]),
        "bezier": on(packed_bez["bezier"][1]),
        "cornell_bezier": on(packed_bez["cornell_bezier"][1]),
        "klein": on(packed_kl["klein"][1]),
        "cornell_klein": on(packed_kl["cornell_klein"][1]),
        "tile": tile("k4"),
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
