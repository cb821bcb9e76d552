"""The port's batched games, and what several of them share."""

import torch


def last_true(hit: torch.Tensor) -> torch.Tensor:
  """(B, N) bool -> the last true entry of each row alone.

  The reference picks one of several hits per env with
  `N - 1 - jnp.argmax(hit[::-1])` under vmap; here the argmax runs over the
  last axis of a uint8 view (torch's refuses bool), whose ties go to the
  first index, as JAX's do. A row with no hit keeps none."""
  n = hit.shape[1]
  pick = n - 1 - torch.argmax(hit.flip(1).to(torch.uint8), dim=1)
  return hit & (torch.arange(n, device=hit.device) == pick[:, None])


def isin(action: torch.Tensor, table) -> torch.Tensor:
  """(B,) actions -> where each is one of the Python ints in `table` (the
  reference's `jnp.isin` against a constant table)."""
  out = action == table[0]
  for a in table[1:]:
    out = out | (action == a)
  return out
