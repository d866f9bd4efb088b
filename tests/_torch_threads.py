"""Caps torch's intra-op threads at one in a pytest-xdist worker.

Every ``tests/test_torch_*.py`` imports this module first. Torch starts
one intra-op thread per CPU in each process, so N workers on an N-CPU
host run N x N threads beside JAX's own pools, and small CPU products
then wait on each other: a loop of small matmuls shaped like the
emulated attention backward took 107 s in each of six 8-thread workers
against 0.85 s in each of six 1-thread workers. A serial run (no
xdist, ``PYTEST_XDIST_WORKER`` unset) keeps torch's default.

:func:`default_threads` gives a test torch's own thread count back for
its duration. The CPU GEMM sums in an order that depends on the thread
count, and two JAX-parity train tests are held to the sums of the
default count: at one to four threads a weight whose gradient is
rounding noise (~1e-8) takes an Adam step of the other sign and lands
3.3e-5 or 4.6e-5 from JAX's, past their 2e-5 limit.
"""

import contextlib
import os

import torch

DEFAULT_THREADS = torch.get_num_threads()

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


@contextlib.contextmanager
def default_threads():
    """Torch's default intra-op thread count for the duration."""
    prev = torch.get_num_threads()
    torch.set_num_threads(DEFAULT_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(prev)
