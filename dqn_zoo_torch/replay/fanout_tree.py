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


def _last_write_values(indices: torch.Tensor,
                       values: torch.Tensor) -> torch.Tensor:
  """`values` with every duplicate of an index given the value of that
  index's last occurrence, so that a scatter of them, which keeps an
  arbitrary one of duplicate writes, keeps the last. A stable sort by index
  puts each index's writes in one run in their original order; each
  position reads the value at the end of its run. No atomics, and no read
  back to the host."""
  n = indices.shape[0]
  if n < 2:
    return values
  order = torch.argsort(indices, stable=True)
  run = indices[order]
  pos = torch.arange(n, device=indices.device)
  run_end = torch.ones((n,), dtype=torch.bool, device=indices.device)
  run_end[:-1] = run[1:] != run[:-1]
  end = torch.where(run_end, pos, n)
  end = torch.flip(torch.cummin(torch.flip(end, (0,)), 0).values, (0,))
  out = torch.empty_like(values)
  out[order] = values[order][end]
  return out


def fanout_set(tree: Tree, indices: torch.Tensor,
               values: torch.Tensor) -> None:
  """Sets leaves at `indices` to `values` in place and re-sums the touched
  ancestor rows. Duplicate indices: the last write wins, as in the JAX
  package. A duplicated parent gathers the same re-written row and writes
  the same sum."""
  indices = indices.reshape(-1)
  values = _last_write_values(indices, values.reshape(-1).to(torch.float32))
  tree[0][indices] = values
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
