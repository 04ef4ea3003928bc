"""Cap torch's intra-op threads in every pytest process.

The suite runs in pytest-xdist workers (`-n 6`), each a process with
torch's default thread count, one a core: six workers then run six times
as many torch threads as there are cores, beside XLA's own, and the port's
files ran many times slower in the suite than alone.  Each worker imports
every test module before it runs a test, so this module caps the threads
of every worker when it is imported: the cores divided among the workers
(PYTEST_XDIST_WORKER_COUNT), at least one.  Tests that pin one thread
restore the count they found, the cap."""
import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
CAP = max(1, (os.cpu_count() or 1) // WORKERS)
torch.set_num_threads(CAP)


def test_torch_threads_are_capped():
    assert torch.get_num_threads() == CAP
