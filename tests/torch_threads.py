"""Intra-op threads for the port's CPU tests.

torch starts one intra-op thread per core in every process. Under
pytest-xdist every worker does so, and the workers' spinning thread pools
oversubscribe the machine (a 12 s system test took minutes in a full
six-worker run). Each worker takes its share of the cores instead."""

import os

import torch


def share_cores() -> None:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // workers))
