"""One torch thread for the port's CPU tests.

The suite runs in several worker processes on a machine of a few cores, and
torch starts one intra-op thread per core in each: their parallel regions
then spin on cores that the other workers are using. Six copies of
``test_torch_trainer.py::test_update_replays_in_flax_cortex`` at once took
87.6 s each with torch's default threads and 7.3 s each with one. Every
``tests/test_torch_*.py`` file that runs torch on the CPU imports
``one_torch_thread``, an autouse fixture that runs its module on one torch
thread and gives the previous count back after it. Nothing a test compares
depends on it beyond the order of float reductions, which each float
comparison's stated tolerance covers.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_module_runs_on_one_torch_thread():
    assert torch.get_num_threads() == 1
