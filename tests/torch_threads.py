"""One thread per thread pool for a test module of the port.

The suite runs six workers on one machine. The port's CPU paths make
many small torch and LAPACK calls (host loops, the direct engine's
factorizations, the polish's lstsq), and with every worker's OpenMP, MKL
and OpenBLAS pools at the machine's core count they oversubscribe it:
measured on 8 cores, a test that takes 9 s alone took 1,013 s beside
five busy workers. A module imports ``one_thread`` to run on one thread
of each pool (torch's intra-op pool and the BLAS that numpy loads)."""

import pytest
import torch
from threadpoolctl import threadpool_limits


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(limits=1, user_api="blas"):
            yield
    finally:
        torch.set_num_threads(threads)
