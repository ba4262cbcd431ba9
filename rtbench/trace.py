"""What a traced window of whole frames or steps reads from the profiler.

`Window` runs `torch.profiler` around a few whole frames or steps and
reduces its trace to one summary dict: the device's kernel launches, their
summed time, the union of all device intervals (kernels, copies, sets)
over the window, the device operations that took the most time and the
longest idle gaps by the host operation that was running in them.  The per-layer metric readers (rtbench/metrics/) take
their numbers from that dict.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

TOP = 10            # entries of each breakdown list


# kineto's kinds of event: what runs on the card, and what the host does
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
              "python_function")


def _kind(e):
    """An event's kineto kind (older kineto bindings: from its device and
    whether it is an annotation)."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    cuda = e.device_type() == torch.autograd.DeviceType.CUDA
    if e.is_user_annotation():
        return "gpu_user_annotation" if cuda else "user_annotation"
    return "kernel" if cuda else "cpu_op"


def _events(prof):
    """(name, device, start_s, end_s) of the card's work (kernels, copies,
    sets: device True) and of the host's operations (device False); the
    card's ranges of record_function annotations and the profiler's own
    overhead are neither."""
    out = []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        if kind in DEVICE_KINDS:
            dev = True
        elif kind in HOST_KINDS:
            dev = False
        else:
            continue
        out.append((e.name(), dev, e.start_ns() * 1e-9, e.end_ns() * 1e-9))
    return out


def _union(intervals, lo, hi):
    """Merged [a, b] intervals clipped to [lo, hi], in order."""
    merged = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(events, window_name):
    """The summary of a trace whose whole frames or steps lie inside the
    host range `window_name` (a record_function around them)."""
    span = [(a, b) for n, d, a, b in events if not d and n == window_name]
    if not span:
        return None
    lo, hi = span[0]
    dev = [(n, a, b) for n, d, a, b in events if d and b > lo and a < hi]
    kernels = [(n, a, b) for n, a, b in dev
               if not n.startswith(("Memcpy", "Memset"))]
    busy = _union([(a, b) for _, a, b in dev], lo, hi)
    by_name = defaultdict(float)
    for n, a, b in dev:
        by_name[n[:120]] += b - a
    host = sorted((a, b, n) for n, d, a, b in events
                  if not d and n != window_name and b > lo and a < hi)
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        name = "(host idle)"
        i = bisect.bisect_right(starts, mid)
        for j in range(i - 1, max(-1, i - 64), -1):   # innermost op running
            if host[j][1] >= mid:
                name = host[j][2]
                break
        gaps[name[:120]] += g1 - g0
    top = lambda d: sorted(([k, v] for k, v in d.items()),
                           key=lambda kv: -kv[1])[:TOP]
    return dict(window_s=hi - lo, busy_s=sum(b - a for a, b in busy),
                kernels=len(kernels),
                kernel_s=sum(b - a for _, a, b in kernels),
                device_ops=top(by_name), idle_gaps=top(gaps))


class Window:
    """Profile the whole frames or steps run inside `with Window(device)`;
    the summary is `summary` once the block has ended."""

    NAME = "rtbench.window"

    def __init__(self, device):
        self.device = device
        self.summary = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.range = torch.profiler.record_function(self.NAME)
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.range.__exit__(*exc)
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = summarize(_events(self.prof), self.NAME)
        return False
