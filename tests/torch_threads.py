"""The port's tests run on one PyTorch intra-op thread.

The port's CPU paths (the kernels' plain twins, retrieval's stages) are
thousands of small eager ops. Under pytest-xdist every worker's default
pool, a thread a core, contends with the other workers' pools, and each op
waits on it: six workers on eight cores then take several times as long
as at one thread each. Results do not depend on the count: rank processes
at one thread are held bit-equal to in-process runs.

Importing this module sets THREADS in the importing process. Every
tests/test_torch_*.py and tests/torch_mesh_ranks.py imports it, which
covers a file run alone, each xdist worker (it imports every test module
while collecting) and each spawned rank (it imports the module that holds
its function). Ranks get THREADS through spawn_ranks(threads=THREADS),
and a process a test starts itself runs with child_env().
"""
import os

import torch

THREADS = 1
torch.set_num_threads(THREADS)


def child_env(**extra: str) -> dict:
    """This process's environment, with `extra` and OMP_NUM_THREADS set to
    THREADS (a process's PyTorch reads it when it starts)."""
    return dict(os.environ, OMP_NUM_THREADS=str(THREADS), **extra)
