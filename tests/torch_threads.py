"""The share of the host's cores that torch takes in a test process of the
port.

Every tests/test_torch_*.py imports this module first.  Tier 1 runs the
test files in several xdist workers at once, and torch would start as many
intra-op threads in each worker as the host has cores: n workers then put
n times as many spinning threads as there are cores on the host, and the
plain step's small eager ops wait on threads that are descheduled (two
64^2 renders that pass in 16 s with the cap did not finish in 240 s
without it, on two workers of an 8-core host).  So
each process of the port's tests takes its share,

    max(1, os.cpu_count() // n_workers),

where n_workers is xdist's PYTEST_XDIST_WORKER_COUNT (1 when it is unset:
one process has the host to itself).  The ranks that
tests/test_torch_parallel.py spawns divide their worker's share once more
(`cap(ranks)`, tests/parallel_ranks.py).  Only torch's intra-op pool is
capped, in these processes only: the port itself never sets a thread
count, so user programs keep torch's default.
"""

import os

import torch


def cap(ranks: int = 1) -> int:
    """Give torch this process's share of the cores, one of `ranks`
    processes of a worker; return it."""
    n_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    n = max(1, (os.cpu_count() or 1) // (n_workers * ranks))
    torch.set_num_threads(n)
    return n


cap()
