"""The port's CPU tests share the cores under pytest-xdist: importing this
module gives each worker process ``cores // workers`` torch intra-op
threads (at least one).  Left at its default, every worker's OpenMP pool
takes all the cores, and six such pools oversubscribe them: on 8 CPU
cores the quickstart's test took 1.8 s alone and 121 s beside five other
workers.
A run in one process keeps torch's default."""
import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if WORKERS > 1:
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // WORKERS))
