"""Process groups and collectives of the sharded paths.

The port of scheme_raytrace_tpu/parallel/distributed.py.  JAX spans hosts
with jax.distributed and one controller; torch runs one process a device
(parallel/mesh.py), so every process calls `initialize` before building a
mesh, and the collectives below combine the shards.  `spawn` starts n gloo
processes on the CPU, the port's counterpart of the JAX tests' virtual CPU
mesh (or n NCCL processes, a card each): its children import torch and
this package only.  `single_process` is a world of one rank in this
process, the way one card runs the sharded entry points.
"""

from __future__ import annotations

import contextlib
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from ..config import resolve_device


def initialize(init_method=None, world_size=None, rank=None, backend=None,
               device=None) -> torch.device:
    """Join this process to the default process group; return its device.

    The backend follows the device the caller names, never what happens to
    be present: NCCL for the card (`device=None` or a CUDA device), gloo
    for `device="cpu"`.  `init_method` defaults to "env://" (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE and RANK from the environment); pass e.g.
    "tcp://localhost:29500" or "file:///path/store" with `world_size` and
    `rank` otherwise.  With no device named, rank r of a host takes card
    LOCAL_RANK (else r) modulo the host's card count.  A failure raises."""
    if device is None and torch.cuda.is_available():
        local = int(os.environ.get(
            "LOCAL_RANK", rank if rank is not None
            else os.environ.get("RANK", 0)))
        device = torch.device("cuda", local % torch.cuda.device_count())
    device = resolve_device(device)
    if backend is None:
        backend = "gloo" if device.type == "cpu" else "nccl"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank)
    return device


def is_multi_process() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def all_sum(x, group=None):
    """SUM of x over the group's ranks (a new tensor; x is not changed)."""
    y = x.detach().clone()
    dist.all_reduce(y, dist.ReduceOp.SUM, group=group)
    return y


def all_max(x, group=None):
    """MAX of x over the group's ranks (a new tensor)."""
    y = x.detach().clone()
    dist.all_reduce(y, dist.ReduceOp.MAX, group=group)
    return y


def assemble_image(rows, group=None):
    """Every rank's band of rows, gathered in rank order onto every rank
    (the final image assembly: JAX's `process_allgather`)."""
    parts = [torch.empty_like(rows) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, rows.detach().contiguous(), group=group)
    return torch.cat(parts)


def _to_numpy(x):
    """Tensors of a result (in dicts, lists and tuples) as numpy arrays, so
    the result pickles without shared memory."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_numpy(v) for v in x)
    return x


def _child(fn, store, n, rank, args, results, device):
    try:
        if device == "cpu":
            # n processes share the host's cores
            torch.set_num_threads(1)
        else:
            device = torch.device("cuda", rank)     # one card a rank
        initialize(store, n, rank, device=device)
        from .mesh import make_mesh
        try:
            out = _to_numpy(fn(make_mesh(), *args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, n: int, *args, timeout: float = 600.0,
          device: str = "cpu") -> list:
    """Run fn(mesh, *args) in n new processes joined in a gloo group on the
    CPU (a `file://` store in a temporary directory), or with
    device="cuda" in an NCCL group, rank r on card r; return their results
    in rank order, tensors as numpy arrays.  fn is pickled by its import
    path: a module-level function of a module the children can import.
    Raises if a rank raises or dies, or after `timeout` seconds; every
    child is ended before it returns."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"spawn: device must be 'cpu' or 'cuda', got "
                         f"{device!r}")
    if device == "cuda" and n > torch.cuda.device_count():
        raise RuntimeError(f"spawn: {n} ranks on the cards, but "
                           f"{torch.cuda.device_count()} CUDA devices")
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_child,
                             args=(fn, store, n, r, args, results,
                                   device))
                 for r in range(n)]
        for p in procs:
            p.start()
        done = False
        try:
            out, deadline = {}, time.monotonic() + timeout
            while len(out) < n:
                try:
                    rank, ok, val = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [p.exitcode for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"spawn: a rank died ({dead})")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"spawn: {n} ranks, {len(out)} "
                                           f"done in {timeout} s")
                    continue
                if not ok:
                    raise RuntimeError(f"spawn: rank {rank} raised:\n{val}")
                out[rank] = val
            done = True
        finally:
            # on a failure the other ranks may wait in a collective: end them
            for p in procs:
                p.join(timeout=30 if done else 0)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(n)]


def free_port() -> int:
    """A TCP port of this host that is free now."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def single_process(device=None):
    """A world of one rank in this process, on `device` (None: the card;
    NCCL there, gloo for "cpu"), at a free localhost port: yields its mesh
    and destroys the group on the way out.  On one card this is how the
    sharded entry points run (NCCL takes one rank a card)."""
    from .mesh import make_mesh
    initialize(f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0,
               device=device)
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()
