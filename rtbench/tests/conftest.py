"""The benchmark's CPU tests: torch on a few threads, every test in this
process on the CPU (the card runs the cells themselves)."""

import os

import torch

torch.set_num_threads(max(1, min(4, (os.cpu_count() or 1)
                             // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT",
                                                   "1")))))
