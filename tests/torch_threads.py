"""One intra-op thread a process for the port's CPU tests.

Every ``tests/test_torch_*.py`` imports this module first. The tests run
small tensors, where torch's intra-op threads (one a core by default) cost
more than they give, and the suite runs six pytest workers on the CPU's
cores, each of which would start its own pool: six pools of one a core
fight for the cores. One thread a worker, and the same for the processes
the tests start (``OMP_NUM_THREADS``, read when torch is imported there),
unless the caller set it.
"""

import os

import torch

os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
