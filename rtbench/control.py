"""The readings that the output limits are set from, beyond the program's:
the control, and the faults planted in the reference put in the program's
place.

    python -m rtbench.control --workload <name> --seeds 1,2,3 [--device cuda]

The control is the reference put in the program's place and computed in
bfloat16, the precision below the float32 the configurations state.  A
frame cell compares the control's frame (the run's first frame of the
window: sample base = spp) with the float32 reference's.  A training cell
compares the control's first steps and a fourth step replayed from the
float32 reference's third parameters (in the window's step's place), and
the same steps with half of the frame's pixels left out of the loss (the
mean taken over the rest), with the float32 reference's.  One JSON line a
reading on standard output.  The benchmark's runs do not run this; it sets
no limit by itself (PERF.md gives the readings and the limits set from
them).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from . import check, reference, run


def frame_readings(cfg, tr, seed, device, dtype):
    nx, ny, spp = tr["nx"], tr["ny"], tr["spp"]
    s = seed & run.M32
    t = time.perf_counter()
    ref, ref_segs = reference.render_frame(cfg, nx, ny, spp, s, spp,
                                           device=device)
    t_ref = time.perf_counter() - t
    ctl, ctl_segs = reference.render_frame(cfg, nx, ny, spp, s, spp,
                                           dtype=dtype, device=device)
    nums = check.frame_numbers(torch.zeros_like(ref, device="cpu"),
                               ctl.float().cpu(), ctl_segs, ref.cpu(),
                               ref_segs)
    yield dict(what="control", ref_seconds=t_ref, **nums)


def step_readings(cfg, tr, seed, device, dtype):
    nx, ny, spp, lr = tr["nx"], tr["ny"], tr["spp"], tr["lr"]
    target = run.make_target(cfg, tr, seed, device)
    start = run.start_config(cfg, tr, tr["job_seed"])     # the cell's job
    n = tr["checked_steps"]
    seeds = [run.step_seed(seed, k) for k in range(n)]
    w_seed = run.step_seed(seed, n)
    steps = lambda seeds, **kw: reference.train_steps(
        start, nx, ny, spp, seeds, target, lr, device=device, **kw)
    t = time.perf_counter()
    ref = steps(seeds)
    t_ref = time.perf_counter() - t
    # the window's step: the run's fourth step, from the reference's p3
    ref_win = steps([w_seed], start=ref[1][-1])
    wide = lambda h: [{k: v.float() for k, v in p.items()} for p in h]

    def as_program(checked, win):
        losses, hist, _, segs = checked
        wl, wh, _, ws = win
        return dict(losses=losses, history=wide(hist), segments=segs,
                    leftovers=[0] * n,
                    window=dict(before=wide(wh)[0], after=wide(wh)[1],
                                loss=wl[0], segments=ws[0], leftover=0))

    try:
        ctl = as_program(steps(seeds, dtype=dtype),
                         steps([w_seed], dtype=dtype, start=ref[1][-1]))
        yield dict(what="control", ref_seconds=t_ref,
                   **check.step_numbers(ctl, ref, ref_win))
    except RuntimeError as e:       # a control that crashes has failed
        yield dict(what="control", error=str(e)[:500])
    keep = torch.arange(nx * ny, device=device) < nx * ny // 2
    half = as_program(steps(seeds, keep=keep),
                      steps([w_seed], keep=keep, start=ref[1][-1]))
    yield dict(what="half_batch", **check.step_numbers(half, ref, ref_win))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = run.cell_of(run.benchmark(), args.workload)
    cfg = run.load("configs", cell["config"])
    tr = run.load("traffic", cell["traffic"])
    device = torch.device(args.device)
    readings = step_readings if tr["loop"] == "steps" else frame_readings
    for seed in (int(s) for s in args.seeds.split(",")):
        for r in readings(cfg, tr, seed, device, torch.bfloat16):
            print(json.dumps(dict(workload=args.workload, seed=seed, **r)),
                  flush=True)


if __name__ == "__main__":
    main()
