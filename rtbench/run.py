"""Run one cell of the benchmark once.

    python -m rtbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (BENCHMARK.json's `workloads`) names a configuration, found as
rtbench/configs/<config>.json, and a traffic mix, rtbench/traffic/<traffic>.json;
its output limits are rtbench/limits/<workload>.json, and each per-layer
metric is read by rtbench/metrics/<metric>.py.  Set-up builds the scene
from the seed's configuration on the card, loads the cell's kernel
variants (built into build/kernels/ on a checkout's first run), and runs
one frame or the first steps; then the cell's loop runs for `--seconds`
from one client, closed: the next frame or step is asked for when the last
has returned.  Once the window has closed the output of the timed path is
compared with the plain reference (rtbench/reference/), and the last line
of standard output is one JSON object: correct, attempted, failed, the
metrics (end-to-end with --trace 0, per-layer with --trace 1), the device,
with --trace 1 the breakdown, and last `check`, each number compared with
its limit (also the last lines of standard error).

With no CUDA card, or fewer than the cell asks for, it exits 3 and prints
no result; if JAX or the JAX package was loaded, it exits 4.  Run as a
program, it holds itself to two cores and torch to one thread.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()         # set-up counts from here

if __name__ == "__main__":
    # One process on two fixed cores of those it may use, torch on one
    # thread: the host dispatches every launch, and a run's pace should not
    # follow where the scheduler moves it.  Set before torch is imported,
    # so that every thread the process starts inherits it.
    import os
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[-2:])
    os.environ["OMP_NUM_THREADS"] = "1"

import argparse  # noqa: E402
import copy  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

from . import check  # noqa: E402
from .reference.scene import compile_scene as ref_scene  # noqa: E402
from .trace import Window  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "scheme_raytrace_tpu")
M32 = 0xFFFFFFFF


def load(kind, name):
    """rtbench/<kind>/<name>.json."""
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def benchmark(root=None):
    with open(Path(root or HERE.parent) / "BENCHMARK.json") as f:
        return json.load(f)


def cell_of(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"rtbench: no workload {name!r} in BENCHMARK.json")


def reports(bench, cell):
    """(end-to-end metrics, per-layer metrics) the cell reports."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if name in m["workloads"] and m["moves"] in moved]
    return e2e, per


def reader(metric):
    """The `read(ctx)` of rtbench/metrics/<metric>.py."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "rtbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def p90(values):
    """The 90th percentile (nearest rank) of all values."""
    v = sorted(values)
    return v[max(0, math.ceil(0.9 * len(v)) - 1)]


def scene_counts(cfg, work=None):
    """The scene's primitive counts for the roofline and, where it has
    kleins, the reference's klein march work a segment (`work`: from
    check.numbers, over the frame or steps it traced)."""
    sc = ref_scene(cfg)
    rc = cfg["render"]
    out = dict(n_rects=sc.n_rects, n_spheres=sc.n_spheres,
               n_beziers=sc.n_beziers,
               n_lights=sc.n_lights if rc["light_sampling"] else 0,
               bez_seeds=rc["bezier_seeds"], bez_newton=rc["bezier_newton"],
               n_kleins=sc.n_kleins)
    if sc.n_kleins:
        seg = max(work["segments"], 1)
        out.update(klein_steps=work["steps"] / seg,
                   klein_inversions=work["inversions"] / seg,
                   klein_hits=work["hits"] / seg)
    return out


def step_seed(seed, k):
    """The render seed of frame set-up or step k of a run."""
    return (seed + k) & M32


def start_config(cfg, tr, seed):
    """The configuration a training run starts from: the published one
    with its parameters perturbed from the seed (tr["perturb"]): each
    channel of every albedo and emission scaled by a factor within
    1 -+ `albedo` / `emission`, each coordinate of every Bezier control
    point moved by up to -+ `bezier_points` and, where the mix gives
    `klein_center`, each coordinate of every klein's centre by up to -+
    that."""
    pert = tr["perturb"]
    r = random.Random(seed)
    out = copy.deepcopy(cfg)

    def scale(rgb, a):
        return [c * r.uniform(1.0 - a, 1.0 + a) for c in rgb]

    def move(xyz, a):
        return [x + r.uniform(-a, a) for x in xyz]

    for m in out["materials"].values():
        if "diffuse_light" in m:
            m["diffuse_light"] = scale(m["diffuse_light"], pert["emission"])
        elif isinstance(m["lambertian"], dict):
            for side in ("even", "odd"):
                m["lambertian"][side] = scale(m["lambertian"][side],
                                              pert["albedo"])
        else:
            m["lambertian"] = scale(m["lambertian"], pert["albedo"])
    for o in out["objects"]:
        if "bezier" in o:
            o["bezier"]["points"] = [move(pt, pert["bezier_points"])
                                     for pt in o["bezier"]["points"]]
    if "klein_center" in pert:
        for o in out["objects"]:
            if "klein" in o:
                o["klein"]["center"] = move(o["klein"]["center"],
                                            pert["klein_center"])
    return out


def make_target(cfg, tr, seed, device):
    """The training target [ny, nx, 3]: the reference's frame of the
    published scene at the traffic's samples a pixel, rendered with seed
    - 1 (no step renders with it)."""
    from . import reference
    nx, ny, spp = tr["nx"], tr["ny"], tr["spp"]
    raw, _ = reference.render_frame(cfg, nx, ny, spp, step_seed(seed, -1),
                                    device=device, lanes_per_block=1 << 20)
    return (raw / spp).reshape(ny, nx, 3).to(torch.float32)


# ---------------------------------------------------------------------------
# the loops
# ---------------------------------------------------------------------------


def run_frames(cfg, tr, seed, seconds, trace, device, t0=None, fault=None):
    """Progressive frames through render_with_stats, on one device."""
    from . import program
    nx, ny, spp = tr["nx"], tr["ny"], tr["spp"]
    seed32 = seed & M32
    scene, cam, config = program.build(cfg, nx, ny, spp, seed32, device)
    if fault is not None:
        program = fault(program)
    st = program.zero_state(config, device)
    st, _ = program.frame(scene, cam, config, st)          # warm-up
    float(st.raw_sum.reshape(-1)[0])
    sync(device)
    setup_s = time.perf_counter() - (T0 if t0 is None else t0)
    pick = random.Random(seed).random() * seconds
    times, segs, traced_segs = [], [], []
    chosen, win, alloc = None, None, []
    tw0 = time.perf_counter()
    while True:
        k = len(times)
        if trace and k == 1:
            win = Window(device).__enter__()
        before = st
        ta = time.perf_counter()
        st, seg = program.frame(scene, cam, config, st)
        float(st.raw_sum.reshape(-1)[0])
        tb = time.perf_counter()
        times.append(tb - ta)
        segs.append(seg)
        if win is not None and k <= tr["trace_units"]:
            traced_segs.append(seg)
            if k == tr["trace_units"]:
                win.__exit__(None, None, None)
        if chosen is None and tb - tw0 >= pick:
            chosen = (before.raw_sum, st.raw_sum, seg,
                      spp * (k + 1))
        if device.type == "cuda":
            alloc.append(torch.cuda.memory_allocated(device))
        if tb - tw0 >= seconds and (not trace or k >= tr["trace_units"]):
            break
    window_s = tb - tw0
    total = int(torch.stack(segs).sum())
    out = dict(
        e2e={"fwd_rays_per_s": total / window_s,
             "fwd_frame_ms_p90": p90(times) * 1e3, "setup_s": setup_s},
        attempted=len(times), failed=0, memory=_peak(device, alloc),
        window_s=window_s, traces=[win.summary] if win is not None else [],
        traced=dict(units=tr["trace_units"],
                    segments=int(sum(int(s) for s in traced_segs)),
                    paths=tr["trace_units"] * nx * ny * spp,
                    n_pixels=tr["trace_units"] * nx * ny, step=False))
    before, after, seg, base = chosen
    out["program"] = dict(before=before.detach().cpu(),
                          after=after.detach().cpu(), segments=int(seg),
                          sample_base=base, seed=seed32)
    del scene, cam, st, chosen, before, after
    return out


def _peak(device, alloc):
    """Peak device memory of the process; raises where the memory held
    after each frame or step grew through the window (a graph or a
    buffer kept from one to the next)."""
    if device.type != "cuda":
        return 0
    if len(alloc) >= 4 and alloc[-1] > 1.05 * alloc[1] + (64 << 20):
        raise RuntimeError(f"memory held grew through the window: "
                           f"{alloc[1]} B after the second, {alloc[-1]} B "
                           f"after the last")
    return torch.cuda.max_memory_allocated(device)


def run_steps(cfg, tr, seed, seconds, trace, device, t0=None, fault=None):
    """Training steps through train_step_fused on a mesh of one rank, from
    the start configuration towards the published scene's frame.  One
    fitting job a cell: the start configuration, and the render seed of
    the build and of the trip count's calibration, come from the mix's
    `job_seed`; the target, every step's render seed and the window step
    checked come from the run's seed."""
    from . import program
    nx, ny, spp, lr = tr["nx"], tr["ny"], tr["spp"], tr["lr"]
    target = make_target(cfg, tr, seed, device)
    if device.type == "cuda":            # the peak is the program's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    job = tr["job_seed"]
    start = start_config(cfg, tr, job)
    scene, cam, config = program.build(start, nx, ny, spp, step_seed(job, 0),
                                       device)
    if fault is not None:
        program = fault(program)
    n_check = tr["checked_steps"]
    with program.one_rank(device) as mesh, \
            program.SegmentCounter() as counter:
        n_iters = program.calibrate(scene, cam, config, mesh)
        params, rest = program.params_of(scene)

        def step(params, k):
            counter.last = None
            cfg_k = config.replace(seed=step_seed(seed, k))
            params, loss, leftover = program.train_step(
                params, rest, cam, cfg_k, target, mesh, n_iters, lr)
            if counter.last is None:
                raise RuntimeError("the step did not go through "
                                   "render_pool_fused: no segment count")
            return params, float(loss), int(leftover), counter.last

        checked = dict(history=[params], losses=[], leftovers=[], segments=[])
        for k in range(n_check):                 # the checked first steps
            params, loss, leftover, seg = step(params, k)
            checked["history"].append(params)
            checked["losses"].append(loss)
            checked["leftovers"].append(leftover)
            checked["segments"].append(seg)
        sync(device)
        setup_s = time.perf_counter() - (T0 if t0 is None else t0)
        pick = random.Random(seed).random() * seconds
        times, ok_segs, traced_segs, failed = [], [], [], 0
        chosen, win, alloc = None, None, []
        tw0 = time.perf_counter()
        while True:
            j = len(times)
            if trace and j == 1:
                win = Window(device).__enter__()
            before = params
            ta = time.perf_counter()
            params, loss, leftover, seg = step(params, n_check + j)
            tb = time.perf_counter()
            times.append(tb - ta)
            if leftover == 0 and math.isfinite(loss):
                ok_segs.append(seg)
            else:
                failed += 1
            if win is not None and j <= tr["trace_units"]:
                traced_segs.append(seg)
                if j == tr["trace_units"]:
                    win.__exit__(None, None, None)
            if chosen is None and tb - tw0 >= pick:
                chosen = dict(before=before, after=params, loss=loss,
                              leftover=leftover, segments=seg,
                              seed=step_seed(seed, n_check + j))
            if device.type == "cuda":
                alloc.append(torch.cuda.memory_allocated(device))
            if tb - tw0 >= seconds and (not trace or j >= tr["trace_units"]):
                break
        window_s = tb - tw0
        total = int(torch.stack(ok_segs).sum()) if ok_segs else 0
    cpu = lambda p: {n: v.detach().cpu() for n, v in p.items()}
    checked["history"] = [cpu(h) for h in checked["history"]]
    checked["segments"] = [int(x) for x in checked["segments"]]
    chosen.update(before=cpu(chosen["before"]), after=cpu(chosen["after"]),
                  segments=int(chosen["segments"]))
    out = dict(
        e2e={"train_rays_per_s": total / window_s, "setup_s": setup_s},
        attempted=len(times), failed=failed, n_iters=n_iters,
        memory=_peak(device, alloc), window_s=window_s,
        traces=[win.summary] if win is not None else [],
        traced=dict(units=tr["trace_units"],
                    segments=int(sum(int(s) for s in traced_segs)),
                    paths=tr["trace_units"] * nx * ny * spp,
                    n_pixels=tr["trace_units"] * nx * ny, step=True),
        program=dict(checked, window=chosen, config=start,
                     seeds=[step_seed(seed, k) for k in range(n_check)],
                     target=target.cpu()))
    del scene, params, rest, before, checked
    return out


LOOPS = {"frames": run_frames, "steps": run_steps}



# ---------------------------------------------------------------------------
# one run of a cell
# ---------------------------------------------------------------------------


def run_cell(bench, cell, seed, seconds, trace, device, t0=None, fault=None,
             traffic=None):
    """Run `cell` once and return the result line as a dict (its `check`
    last).  `traffic` replaces the cell's traffic mix (a smaller one, in the
    CPU tests); `fault` wraps the program module (the tests' planted
    faults)."""
    cfg = load("configs", cell["config"])
    tr = traffic or load("traffic", cell["traffic"])
    limits = load("limits", cell["name"])
    e2e, per = reports(bench, cell)
    loop = LOOPS[tr["loop"]]
    out = loop(cfg, tr, seed, seconds, bool(trace), device, t0, fault)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers, ref_work = check.numbers(cfg, tr, out["program"], device)
    units = ("steps, trip count %d" % out["n_iters"] if tr["loop"] == "steps"
             else "frames")
    print(f"rtbench: {cell['name']} seed {seed}: set-up "
          f"{out['e2e']['setup_s']:.3f} s, window {out['window_s']:.3f} s "
          f"({out['attempted']} {units}), reference "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr, flush=True)
    line = {"correct": check.correct(numbers, limits),
            "attempted": out["attempted"], "failed": out["failed"]}
    if trace:
        ctx = dict(loop=tr["loop"], ranks=out["traces"], **out["traced"],
                   scene=scene_counts(cfg, ref_work))
        metrics = {}
        for m in per:
            v = reader(m["name"])(ctx) if out["traces"] else None
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        line["metrics"] = metrics
    else:
        line["metrics"] = {m["name"]: {"value": out["e2e"][m["name"]],
                                       "unit": m["unit"]} for m in e2e}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1,                 # both loops drive one card
           "memory_peak_bytes": out["memory"]}
    if trace and out["traces"]:
        dev["busy_s"] = statistics.fmean(t["busy_s"] for t in out["traces"])
        dev["window_s"] = statistics.fmean(t["window_s"]
                                           for t in out["traces"])
        t0_ = out["traces"][0]
        line["breakdown"] = {"device_ops": t0_["device_ops"],
                             "idle_gaps": t0_["idle_gaps"]}
    line["device"] = dev
    line["card"] = card_line(device)
    line["check"] = {k: {"value": v, "limit": limits[k]}
                     for k, v in numbers.items()}
    return line


def card_line(device):
    """nvidia-smi's name and power limit of the card, beside the numbers."""
    if device.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            check=True, capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def jax_loaded():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = benchmark()
    cell = cell_of(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"rtbench: the cell needs {cell['chips']} CUDA device(s), "
              f"{n} found", file=sys.stderr)
        return 3
    line = run_cell(bench, cell, args.seed, args.seconds, args.trace,
                    torch.device("cuda", 0))
    found = jax_loaded()
    if found:
        print(f"rtbench: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 4
    for k, v in line["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r} "
              f"{'ok' if v['value'] <= v['limit'] else 'FAILED'}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
