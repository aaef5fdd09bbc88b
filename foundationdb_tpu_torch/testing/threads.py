"""The intra-op thread count of a test process.

pytest-xdist runs the suite in several worker processes on one host. Each
imports torch, whose OpenMP pool defaults to one thread a core, so six
workers on eight cores run forty-eight spinning threads, and a test whose
plain versions make many small parallel calls takes tens of times its
time alone. Each test module of the port calls `cap_intra_op_threads()`
when it is imported.
"""

from __future__ import annotations

import os


def cap_intra_op_threads() -> int:
    """Give torch this process's share of the host's cores: the cores
    over the xdist workers (PYTEST_XDIST_WORKER_COUNT, 1 outside xdist),
    at least one. Returns the count set."""
    import torch

    workers = max(1, int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 1))
    n = max(1, (os.cpu_count() or 1) // workers)
    if torch.get_num_threads() != n:
        torch.set_num_threads(n)
    return n
