"""The numbers that decide `correct`: the timed path's output against the
plain reference, each held to its limit (rtbench/limits/<workload>.json).

A frame: one frame of the window, drawn from the seed, recomputed whole by
the reference from the same seed and sample base.
  * `img_gap`: sum over the frame of |(after - before) - reference| over
    sum |reference|, the program's frame being the difference of the
    accumulated radiance after and before it (float64);
  * `seg_gap`: |segments - reference's| / reference's.
Path tracing is chaotic: a path whose float rounding differs by an ulp at a
silhouette takes another way, so both gaps read a little above 0 on sound
runs; they are set from readings (PERF.md).

A training run: the reference follows the run's first `checked_steps`
steps from the same start configuration with the same seeds and target,
and replays one step of the window, drawn from the seed, from the
parameters the program gave that step.
  * `loss_gap`: the largest |loss - reference's| / reference's, over the
    checked steps and the window's step;
  * `seg_gap`: the same of the steps' exact forward path segments;
  * `step1_gap`: the first update p1 - p0 (the gradient as the optimiser
    applied it, times lr), leaf by leaf: |norm(program's) -
    norm(reference's)| over the larger of the reference leaf's norm and the
    median leaf's; the worst leaf;
  * `stepN_gap`: the same for p_N - p0 after the N checked steps;
  * `window_median_gap`: the window's step, by its median leaf: of the
    leaves that move, the one whose reference update has the median norm
    (the upper of two), |norm(program's) - norm(reference's)| over the
    reference's.  Not the worst leaf: where a step's gradient is mostly
    sampling noise, a small leaf (the spheres' centres, at a twentieth of
    the median leaf) rests on a few grazing paths, which float32 rounding
    hands to one side and not the other, and the float64 reference sides
    with neither (PERF.md);
  * `undrained`: those steps whose pool did not drain (limit 0).
Leaves whose reference gradient (of that step) is under a thousandth of
the median leaf's (the median over leaves with a gradient) move by
rounding alone and are left out of the update gaps.
"""

from __future__ import annotations

import math
import statistics

import torch

from . import reference

FLOOR = 1e-3       # a leaf's share of the median gradient below which it
                   # moves by rounding alone


def frame_numbers(before, after, segments, ref, ref_segments):
    delta = (after.double() - before.double()).reshape(-1, 3)
    ref = ref.double().reshape(-1, 3).to(delta.device)
    img = float((delta - ref).abs().sum() / ref.abs().sum())
    seg = abs(segments - ref_segments) / ref_segments
    return {"img_gap": img, "seg_gap": seg}


def _norms(a, b):
    return {k: float((b[k].double() - a[k].double()).norm()) for k in b}


def update_gap(p0, p1, r0, r1, keep):
    """Worst leaf's |norm(p1 - p0) - norm(r1 - r0)| over max(that leaf's
    reference norm, the median leaf's), over the leaves in `keep`."""
    prog, ref = _norms(p0, p1), _norms(r0, r1)
    med = statistics.median([ref[k] for k in keep]) if keep else 0.0
    worst = 0.0
    for k in keep:
        den = max(ref[k], med)
        gap = abs(prog.get(k, 0.0) - ref[k])
        worst = max(worst, gap / den if den > 0 else (0.0 if gap == 0
                                                          else math.inf))
    # a leaf the program moved and the reference has no such parameter
    for k in prog:
        if k not in ref and prog[k] != 0.0:
            worst = math.inf
    return worst


def median_leaf_gap(p0, p1, r0, r1, keep):
    """|norm(p1 - p0) - norm(r1 - r0)| over norm(r1 - r0) of the leaf in
    `keep` whose reference update has the median norm (the upper of two)."""
    prog, ref = _norms(p0, p1), _norms(r0, r1)
    if any(k not in ref and prog[k] != 0.0 for k in prog):
        return math.inf
    if not keep:
        return 0.0
    k = sorted(keep, key=lambda k: ref[k])[len(keep) // 2]
    gap = abs(prog.get(k, 0.0) - ref[k])
    return gap / ref[k] if ref[k] > 0 else (0.0 if gap == 0 else math.inf)


def moving(grads):
    """The leaves whose gradient is at least FLOOR of the median leaf's."""
    g = {k: float(v.double().norm()) for k, v in grads.items()}
    nonzero = [v for v in g.values() if v > 0]
    med = statistics.median(nonzero) if nonzero else 0.0
    return [k for k, v in g.items() if v > 0 and v >= FLOOR * med]


def _rel(a, b):
    return abs(a - b) / abs(b)


def step_numbers(prog, ref, ref_win):
    """The numbers of a training run.  `prog`: the program's checked steps
    (`losses`, `history`, `segments`, `leftovers`) and its window step
    (`window`: `before`, `after`, `loss`, `segments`, `leftover`); `ref`
    and `ref_win`: reference.train_steps' (losses, history, first
    gradients, segments) of the checked steps and of the window step's
    replay."""
    rl, rh, rg, rs = ref
    wl, wh, wg, ws = ref_win
    win = prog["window"]
    n = len(rl)
    keep = moving(rg)
    losses = list(zip(prog["losses"], rl)) + [(win["loss"], wl[0])]
    segs = list(zip(prog["segments"], rs)) + [(win["segments"], ws[0])]
    h = prog["history"]
    return {"loss_gap": max(_rel(a, b) for a, b in losses),
            "seg_gap": max(_rel(a, b) for a, b in segs),
            "step1_gap": update_gap(h[0], h[1], rh[0], rh[1], keep),
            f"step{n}_gap": update_gap(h[0], h[n], rh[0], rh[n], keep),
            "window_median_gap": median_leaf_gap(win["before"], win["after"],
                                                 wh[0], wh[1], moving(wg)),
            "undrained": float(sum(x != 0 for x in
                                   [*prog["leftovers"], win["leftover"]]))}


def numbers(cfg, tr, prog, device, dtype=torch.float32):
    """(the compared numbers, the reference's work) of one run's output
    `prog` (the loop's "program" dict); the reference runs on `device` in
    `dtype`.  The work: its path segments and its klein march's lane-steps,
    inversions and accepted hits, over the frame or steps it traced."""
    nx, ny, spp = tr["nx"], tr["ny"], tr["spp"]
    work = dict(steps=0, inversions=0, hits=0)
    if "window" in prog:
        args = (prog["config"], nx, ny, spp)
        ref = reference.train_steps(*args, prog["seeds"], prog["target"],
                                    tr["lr"], dtype=dtype, device=device,
                                    work=work)
        win = prog["window"]
        ref_win = reference.train_steps(*args, [win["seed"]], prog["target"],
                                        tr["lr"], dtype=dtype, device=device,
                                        start=win["before"], work=work)
        work["segments"] = sum(ref[3]) + sum(ref_win[3])
        return step_numbers(prog, ref, ref_win), work
    ref, ref_segs = reference.render_frame(
        cfg, nx, ny, spp, prog["seed"], prog["sample_base"], dtype=dtype,
        device=device, work=work)
    work["segments"] = ref_segs
    return frame_numbers(prog["before"], prog["after"], prog["segments"],
                         ref.cpu(), ref_segs), work


def correct(nums, limits):
    """Every number within its limit (a NaN is not)."""
    return all(nums[k] <= limits[k] for k in nums)
