"""The ray mesh over a torch.distributed process group.

The port of scheme_raytrace_tpu/parallel/mesh.py.  The renderer is
data-parallel over rays and pixels: one axis, RAY_AXIS, shards the ray
pool; scene parameters are replicated and their gradients all-reduced.

JAX runs one controller over all the devices of its mesh, and
`shard_map` runs each device's shard inside one program.  torch runs one
process a device instead: a rank IS a shard.  Every rank calls the same
entry point of parallel/ with the same arguments, renders its own shard
on its own device, and the collectives of the process group (NCCL on
the card, gloo on the CPU) combine the shards.  Call
`distributed.initialize` in every process before `make_mesh`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

RAY_AXIS = "rays"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the 1-D ray mesh."""
    group: Optional[dist.ProcessGroup]   # None: the default group
    rank: int                            # this process's shard
    size: int                            # shards (ranks) on RAY_AXIS
    device: torch.device                 # where this rank's tensors live


def make_mesh(n_devices: Optional[int] = None, group=None) -> Mesh:
    """The mesh of the initialised process group `group` (default: the
    default group), one shard a rank, on this rank's device: the current
    card for an NCCL group, the CPU for a gloo one.  `n_devices`, if given,
    must be the group's size: a torch mesh cannot leave ranks out the way
    JAX's takes the first n devices."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: call parallel.distributed.initialize "
                           "in every process first")
    size = dist.get_world_size(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh: the group has {size} ranks, "
                         f"not {n_devices}")
    device = (torch.device("cpu") if dist.get_backend(group) == "gloo"
              else torch.device("cuda", torch.cuda.current_device()))
    return Mesh(group, dist.get_rank(group), size, device)
