"""Radix-128 fanout sum tree (port of dqn_zoo_tpu/replay/fanout_tree.py).

A tree is a list of f32 tensors: the leaves (padded to RADIX^depth), then
each level's row sums of RADIX children, up to a level of size 1.
`fanout_set` updates the tree IN PLACE.
"""

from __future__ import annotations

from typing import List

import torch

RADIX = 128
Tree = List[torch.Tensor]


def _depth_for(capacity: int) -> int:
  d = 1
  while RADIX**d < capacity:
    d += 1
  return d


def fanout_init(capacity: int, device) -> Tree:
  depth = _depth_for(capacity)
  size = RADIX**depth
  levels = [torch.zeros((size,), dtype=torch.float32, device=device)]
  for _ in range(depth):
    size //= RADIX
    levels.append(torch.zeros((size,), dtype=torch.float32, device=device))
  return levels


def fanout_set(tree: Tree, indices: torch.Tensor,
               values: torch.Tensor) -> None:
  """Sets leaves at `indices` to `values` in place and re-sums the touched
  ancestor rows. Indices must be distinct wherever their values differ
  (a CUDA scatter keeps an arbitrary one of duplicate writes)."""
  tree[0][indices] = values.to(torch.float32)
  node = indices
  for k in range(len(tree) - 1):
    node = node // RADIX
    rows = tree[k].view(-1, RADIX)[node]
    tree[k + 1][node] = rows.sum(dim=-1)


def fanout_total(tree: Tree) -> torch.Tensor:
  return tree[-1].sum()


def fanout_get(tree: Tree, indices: torch.Tensor) -> torch.Tensor:
  return tree[0][indices]


def fanout_query(tree: Tree, targets: torch.Tensor) -> torch.Tensor:
  """Smallest leaf i with cumsum(leaves)[i] > t, for each target t."""
  t = targets.to(torch.float32)
  idx = torch.zeros(t.shape, dtype=torch.int64, device=t.device)
  for level in range(len(tree) - 2, -1, -1):
    children = tree[level].view(-1, RADIX)[idx]
    prefix = torch.cumsum(children, dim=-1)
    child = (prefix <= t[..., None]).sum(dim=-1)
    child = torch.clamp(child, max=RADIX - 1)
    exclusive = prefix - children
    t = t - torch.gather(exclusive, -1, child[..., None])[..., 0]
    idx = idx * RADIX + child
  return idx
