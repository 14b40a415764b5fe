"""A fixture the port's test modules share (``from torch_port_threads
import _two_threads``): two torch threads while a module runs.  The suite
runs its files in parallel workers; torch's default, a thread a core in
every worker, oversubscribes the host many times over, and a test of many
small operations then runs ten to fifty times slower.
``tests/test_torch_port_trainer.py`` keeps torch's default: its folder
run against JAX's (a BatchNorm model under AdamW, whose BatchNorm-fed
biases step by about lr on the sign of a rounding-level gradient) lands
within its limits at the default thread count and 9e-4 off at two."""

import pytest


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)
