"""One intra-op thread for the port's test modules.

The test workers share the machine's cores. With a thread per core in every
worker, their OpenMP threads spin against each other and a loop of small
tensor ops runs many times slower (a city map's .scen entries: 417 s in a
loaded run against ~15 s at one thread). Every tests/test_torch_*.py imports
`one_thread` from here, which makes it an autouse fixture of that module, so
the thread policy is defined once and no test file sets threads of its own.
"""
import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module, and OMP_NUM_THREADS=1 for the
    interpreters its tests spawn; both restored after the module. Not
    set_num_interop_threads: it raises once inter-op work has started."""
    threads = torch.get_num_threads()
    omp = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    if omp is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = omp
