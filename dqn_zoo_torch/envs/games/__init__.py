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


def first_true(hit: torch.Tensor) -> torch.Tensor:
  """(B, N) bool -> the first true entry of each row alone: the
  reference's `jnp.argmax(hit)` under vmap (the first true, or index 0 for
  a row with none) masked by the row's hits, so a row with no hit keeps
  none."""
  n = hit.shape[1]
  pick = torch.argmax(hit.to(torch.uint8), dim=1)
  return hit & (torch.arange(n, device=hit.device) == pick[:, None])


def joystick(action: torch.Tensor):
  """The 18-action joystick decode (ALE order): (dx, dy) in {-1, 0, 1} as
  f32 and the fire bit; actions 10..17 are 2..9 with fire."""
  fire = (action == 1) | (action >= 10)
  a = torch.where(action >= 10, action - 8, action)
  up = (a == 2) | (a == 6) | (a == 7)
  right = (a == 3) | (a == 6) | (a == 8)
  left = (a == 4) | (a == 7) | (a == 9)
  down = (a == 5) | (a == 8) | (a == 9)
  dx = right.to(torch.float32) - left.to(torch.float32)
  dy = down.to(torch.float32) - up.to(torch.float32)
  return dx, dy, fire


def isin(action: torch.Tensor, table) -> torch.Tensor:
  """(B,) actions -> where each is one of the Python ints in `table` (the
  reference's `jnp.isin` against a constant table)."""
  out = action == table[0]
  for a in table[1:]:
    out = out | (action == a)
  return out
