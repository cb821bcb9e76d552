"""Policy sampling (port of dqn_zoo_tpu/ops/policy.py).

The random draws are inputs: JAX's threefry and torch's generators never
agree bit for bit, so the caller draws (from a `torch.Generator`, or from
values a test computed with JAX) and these functions only decide.
"""

from __future__ import annotations

import torch


def greedy_sample(q_values: torch.Tensor) -> torch.Tensor:
  """Greedy action per row; ties break to the lowest index like jnp.argmax."""
  return torch.argmax(q_values, dim=-1)


def epsilon_greedy_sample(q_values: torch.Tensor, epsilon,
                          explore_uniform: torch.Tensor,
                          random_action: torch.Tensor) -> torch.Tensor:
  """ε-greedy actions (int64).

  explore_uniform: U[0, 1) draws, one per row; a row explores when its draw
  is below ε. random_action: integer draws in [0, A), one per row, taken
  when the row explores.
  """
  greedy = torch.argmax(q_values, dim=-1)
  # ε as a host scalar: a copy of it to the device would wait for the
  # device.
  explore = explore_uniform < torch.as_tensor(epsilon)
  return torch.where(explore, random_action.to(greedy.dtype), greedy)


def epsilon_greedy_draws(batch: int, num_actions: int,
                         generator: torch.Generator, device):
  """The (explore_uniform, random_action) pair from a generator."""
  u = torch.rand((batch,), generator=generator, device=device)
  a = torch.randint(0, num_actions, (batch,), generator=generator,
                    device=device)
  return u, a
