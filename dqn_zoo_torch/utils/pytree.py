"""Small pytree helpers (port of dqn_zoo_tpu/utils/pytree.py)."""

from __future__ import annotations

import dataclasses
from typing import Any, List

import torch


def tree_replace(obj: Any, **updates) -> Any:
  """dataclasses.replace that also works on NamedTuples."""
  if dataclasses.is_dataclass(obj):
    return dataclasses.replace(obj, **updates)
  if hasattr(obj, "_replace"):
    return obj._replace(**updates)
  raise TypeError(f"Cannot replace fields on {type(obj)}")


def leaves(tree) -> List[torch.Tensor]:
  """Parameter leaves of a nested dict in sorted-key order (JAX's order)."""
  if isinstance(tree, dict):
    return [x for k in sorted(tree) for x in leaves(tree[k])]
  return [tree]


def tree_map(fn, tree):
  """`fn` applied to every leaf of a nested dict, keeping its keys."""
  if isinstance(tree, dict):
    return {k: tree_map(fn, v) for k, v in tree.items()}
  return fn(tree)
