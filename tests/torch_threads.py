"""One share of the host's cores for each xdist worker of the port's tests.

Under xdist (``PYTEST_XDIST_WORKER`` set) every worker would run torch at
its default intra-op thread count, one thread a core, so ``-n 6`` on an
8-core host runs ~48 threads and the in-process torch work of the port's
tests slows several-fold. Each ``tests/test_torch_*.py`` imports
:func:`xdist_torch_threads`, a module-scoped autouse fixture: under xdist
it sets torch's intra-op threads to ``max(1, cpu_count //
PYTEST_XDIST_WORKER_COUNT)`` and ``OMP_NUM_THREADS`` to the same count,
so the subprocesses a test starts inherit it, and puts both back after
the file. Without xdist it does nothing.
"""

import os
from typing import Optional

import pytest


def worker_threads() -> Optional[int]:
    """Threads for one xdist worker, or None outside xdist."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return None
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 1)
    return max(1, (os.cpu_count() or 1) // max(1, workers))


@pytest.fixture(autouse=True, scope="module")
def xdist_torch_threads():
    n = worker_threads()
    if n is None:
        yield
        return
    import torch

    threads = torch.get_num_threads()
    omp = os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(n)
    os.environ["OMP_NUM_THREADS"] = str(n)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        if omp is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = omp
