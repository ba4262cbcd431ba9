"""The port's telemetry: process counters, and spans and counters traced
while a torch profiler records.

Process counters are always on and cumulative over the process: `count`
adds to one, `counter` reads it.  They count what happens once a kernel
launch or a kernel load (`launches.K1` ... `launches.K6`,
`kernels.load_s`, `kernels.build_s`).

Traced records exist only while a torch profiler records
(`torch.profiler.profile`, the CLI's `--profile`, a benchmark's traced
window): with none running, `span(name)` returns one shared no-op context
manager and `add` returns at once, so the whole cost of a site is the
profiler's gate.  While one records:

  * `span(name)` opens `torch.profiler.record_function(name)`, so the span
    lies on the profiler's own timeline beside the kernels it launched, and
    aggregates by name its calls, its host seconds and its self seconds
    (the seconds less those its child spans on the same thread cover).
    `unit=True` marks a frame or a training step: opened with no span
    around it on its thread, it counts one unit.
  * `add(name, value)` adds a Python number, or a 0-d tensor that is kept
    as it is (no host sync) and summed at `snapshot()`.

`snapshot()` returns {"spans": {name: {"n", "total_s", "self_s"}},
"counters": {name: value}, "units": n}; `reset()` clears the traced
records, and leaves the process counters as they are.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

_tracing = torch._C._autograd._profiler_enabled   # the profiler's gate
_lock = threading.Lock()       # autograd runs backward on its own thread
_local = threading.local()     # each thread's stack of open spans

_COUNTERS: dict = {}           # process counters: name -> number
_SPANS: dict = {}              # traced: name -> [calls, total_s, self_s]
_ADDED: dict = {}              # traced counters: name -> number
_TENSORS: dict = {}            # traced counters: name -> [0-d tensors]
_UNITS = [0]

_OFF = contextlib.nullcontext()


def count(name: str, n=1) -> None:
    """Add n to the process counter `name`."""
    with _lock:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def counter(name: str):
    """The process counter `name`: 0 where nothing was counted."""
    return _COUNTERS.get(name, 0)


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Span:
    __slots__ = ("name", "unit", "child", "t0", "rf")

    def __init__(self, name, unit):
        self.name, self.unit = name, unit

    def __enter__(self):
        st = _stack()
        if self.unit and not st:
            with _lock:
                _UNITS[0] += 1
        st.append(self)
        self.child = 0.0
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self.t0
        self.rf.__exit__(*exc)
        st = _stack()
        st.pop()
        if st:
            st[-1].child += dur
        with _lock:
            rec = _SPANS.setdefault(self.name, [0, 0.0, 0.0])
            rec[0] += 1
            rec[1] += dur
            rec[2] += dur - self.child
        return False


def tracing() -> bool:
    """True while a torch profiler records: the gate of `span` and `add`,
    for a site whose counting needs work of its own (a buffer, a mask)."""
    return _tracing()


def span(name: str, unit: bool = False):
    """A context manager around one named piece of work: a traced span
    while a profiler records, else a shared no-op.  Keep `name` a fixed
    string: the profiler and `snapshot` aggregate by it."""
    if not _tracing():
        return _OFF
    return _Span(name, unit)


def add(name: str, value) -> None:
    """Add `value` (a number, or a 0-d tensor summed at snapshot time) to
    the traced counter `name`, while a profiler records."""
    if not _tracing():
        return
    with _lock:
        if isinstance(value, torch.Tensor):
            _TENSORS.setdefault(name, []).append(value.detach())
        else:
            _ADDED[name] = _ADDED.get(name, 0) + value


def _tensor_sum(ts: list):
    """The sum of kept tensors as a Python number (an int for integer
    tensors), with one host sync a device."""
    by_device: dict = {}
    for t in ts:
        by_device.setdefault(t.device, []).append(t)
    return sum(torch.stack(v).sum().item() for v in by_device.values())


def snapshot() -> dict:
    """The traced records so far: spans by name, counters, units."""
    with _lock:
        spans = {k: dict(n=v[0], total_s=v[1], self_s=v[2])
                 for k, v in _SPANS.items()}
        counters = dict(_ADDED)
        tensors = {k: list(v) for k, v in _TENSORS.items()}
        units = _UNITS[0]
    for name, ts in tensors.items():
        counters[name] = counters.get(name, 0) + _tensor_sum(ts)
    return dict(spans=spans, counters=counters, units=units)


def reset() -> None:
    """Clear the traced records (not the process counters)."""
    with _lock:
        _SPANS.clear()
        _ADDED.clear()
        _TENSORS.clear()
        _UNITS[0] = 0
