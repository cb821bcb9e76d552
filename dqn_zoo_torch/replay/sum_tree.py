"""Flat-array device sum tree (port of dqn_zoo_tpu/replay/sum_tree.py).

A `SumTree` is a (2P,) float32 tensor (P = capacity, a power of two) in a
1-based heap layout: tree[1] is the root and total, the leaves are
tree[P + i], tree[0] is unused. After a batch of leaf writes the internal
levels are rebuilt bottom-up with log2(P) pairwise sums, the JAX package's
order of addition. The functions return a new tree, as the JAX ones do.

Neither engine uses it: the replay's trees are `fanout_tree.py`, which
mirrors this API.
"""

from __future__ import annotations

import torch

from dqn_zoo_torch.device import resolve_device
from dqn_zoo_torch.replay.fanout_tree import _last_write_values

# A SumTree is just a (2P,) float32 tensor.
SumTree = torch.Tensor


def capacity_of(tree: SumTree) -> int:
  cap = tree.shape[-1] // 2
  if cap <= 0 or cap & (cap - 1):
    raise ValueError(
        f"tree length must be 2·(power of 2), got {tuple(tree.shape)}")
  return cap


def sum_tree_init(capacity: int, device=None) -> SumTree:
  """A zero tree on the card unless `device="cpu"` (`resolve_device`)."""
  if capacity <= 0 or capacity & (capacity - 1):
    raise ValueError(f"capacity must be a positive power of 2, got {capacity}")
  return torch.zeros((2 * capacity,), dtype=torch.float32,
                     device=resolve_device(device))


def _rebuild(tree: SumTree, capacity: int) -> SumTree:
  """Recomputes all internal nodes from the leaves, bottom-up, in place."""
  level = tree[capacity:2 * capacity]
  size = capacity // 2
  while size >= 1:
    level = level.reshape(-1, 2).sum(dim=1)
    tree[size:2 * size] = level
    size //= 2
  return tree


def sum_tree_set(tree: SumTree, indices: torch.Tensor,
                 values: torch.Tensor) -> SumTree:
  """Sets leaves at `indices` (0-based) to `values`; duplicate indices keep
  the last write. Values must be non-negative."""
  cap = capacity_of(tree)
  indices = indices.reshape(-1).to(torch.int64)
  values = _last_write_values(indices, values.reshape(-1).to(torch.float32))
  tree = tree.clone()
  tree[cap + indices] = values
  return _rebuild(tree, cap)


def sum_tree_set_all(tree: SumTree, leaves: torch.Tensor) -> SumTree:
  """Replaces the full leaf vector (P,)."""
  cap = capacity_of(tree)
  tree = tree.clone()
  tree[cap:] = leaves.to(torch.float32)
  return _rebuild(tree, cap)


def sum_tree_total(tree: SumTree) -> torch.Tensor:
  return tree[1]


def sum_tree_get(tree: SumTree, indices: torch.Tensor) -> torch.Tensor:
  return tree[capacity_of(tree) + indices.to(torch.int64)]


def sum_tree_leaves(tree: SumTree) -> torch.Tensor:
  cap = capacity_of(tree)
  return tree[cap:2 * cap]


def sum_tree_query(tree: SumTree, targets: torch.Tensor) -> torch.Tensor:
  """Batched prefix-sum query: for each target t in [0, total), the
  smallest leaf index i with sum(leaves[:i+1]) > t, by a root-to-leaf
  descent in float32 (log2(P) gather steps for the whole batch)."""
  cap = capacity_of(tree)
  t = targets.to(torch.float32)
  idx = torch.ones(t.shape, dtype=torch.int64, device=t.device)
  for _ in range(cap.bit_length() - 1):
    left = 2 * idx
    left_sum = tree[left]
    go_right = t >= left_sum
    idx = torch.where(go_right, left + 1, left)
    t = torch.where(go_right, t - left_sum, t)
  return idx - cap
