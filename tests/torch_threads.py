"""The autouse fixture the port's CPU test files import: torch on one
intra-op thread while each test runs."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
  """Torch on one intra-op thread while each test runs: its ops are small,
  and with several test processes at once, torch's threads in each of them
  thrash the cores (tests/test_torch_seaquest.py took 21 s alone, 527 s
  beside five other test processes)."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)
