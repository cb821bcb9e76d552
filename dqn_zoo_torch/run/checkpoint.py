"""Checkpointing (port of dqn_zoo_tpu/run/checkpoint.py).

`TorchCheckpoint` keeps one slot of the FULL training state: env and game
state, frame stack, pending row, replay (frame store, rows, sum trees,
insert counter, max-seen priority), online and target parameters, the
optimizer's moments, the generator, the counters and the telemetry. A run
restored from it goes on as if it had never stopped.

The state is flattened to a dict of tensors and plain numbers keyed by
path (`flatten_state`) and written with `torch.save`; it loads under
`weights_only=True`, memory-mapped on the host, and is copied IN PLACE into
the tensors of a template that `Engine.init` built (`restore_state`). In
place, because the engine holds on to tensors across supersteps: the online
parameters keep `requires_grad`, the optimizer's moments stay the tensors
that its step updates, and the uniform replay's one tree stays one list
(`value_tree is indicator_tree`). Loading on the host first also keeps the
card's peak memory at one copy of the multi-GB frame store.

The slot is a state file and a small JSON meta file beside it. A save
writes the state under a new name, then replaces the meta file, which names
it, and only then deletes the previous state file: the meta file is the
commit point, as `meta.npz` is in the JAX package, and a process killed at
any moment leaves a restorable slot. The meta file needs nothing but a JSON
reader (the chain script reads `iteration` from it).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

META = "meta.json"


def flatten_state(state) -> Dict[str, Any]:
  """{path: tensor | int | float} of a nest of NamedTuples, dicts, lists,
  tensors, generators and numbers. A generator is stored as its
  `get_state()`; None subtrees are left out. A tensor met twice (the
  uniform replay's shared tree) is listed under both paths, and
  `torch.save` writes its storage once."""
  out: Dict[str, Any] = {}

  def walk(x, path):
    if x is None:
      return
    if isinstance(x, torch.Generator):
      out[path] = x.get_state()
    elif isinstance(x, torch.Tensor):
      out[path] = x.detach()
    elif isinstance(x, (bool, int, float)):
      out[path] = x
    else:
      for key, child in _children(x):
        walk(child, f"{path}.{key}" if path else str(key))

  walk(state, "")
  return out


def restore_state(template, flat: Mapping[str, Any]):
  """`template` with every tensor's values copied in place from `flat` (as
  `flatten_state` made it), every generator set, every number replaced.
  NamedTuples holding a number are rebuilt around the same children;
  tensors, lists and dicts are never replaced. Raises on a missing or
  unexpected path and on a shape or dtype that differs from the
  template's."""
  used = set()

  def take(path):
    if path not in flat:
      raise KeyError(f"checkpoint has no entry {path!r}")
    used.add(path)
    return flat[path]

  def walk(x, path):
    if x is None:
      return None
    if isinstance(x, torch.Generator):
      x.set_state(take(path))
      return x
    if isinstance(x, torch.Tensor):
      src = take(path)
      if src.shape != x.shape or src.dtype != x.dtype:
        raise ValueError(f"{path}: checkpoint holds {src.dtype} "
                         f"{tuple(src.shape)}, the run {x.dtype} "
                         f"{tuple(x.shape)}")
      with torch.no_grad():
        x.copy_(src)
      return x
    if isinstance(x, (bool, int, float)):
      return type(x)(take(path))
    kids = [(k, walk(c, f"{path}.{k}" if path else str(k)))
            for k, c in _children(x)]
    if hasattr(x, "_fields"):
      return type(x)(*(c for _, c in kids))
    return x

  out = walk(template, "")
  extra = sorted(set(flat) - used)
  if extra:
    raise ValueError(f"checkpoint entries the run does not have: {extra[:5]}")
  return out


def _children(x):
  if hasattr(x, "_fields"):
    return [(f, getattr(x, f)) for f in x._fields]
  if isinstance(x, dict):
    return [(k, x[k]) for k in sorted(x)]
  if isinstance(x, (list, tuple)):
    return list(enumerate(x))
  raise TypeError(f"cannot checkpoint a {type(x).__name__}")


class NullCheckpoint:
  """No-op checkpoint (ref parts.py:496-527)."""

  def can_be_restored(self) -> bool:
    return False

  def save(self, state, iteration, writer_state, train_done: int = 0,
           extras=None) -> None:
    del state, iteration, writer_state, train_done, extras

  def restore(self, template):
    raise RuntimeError("Nothing to restore.")

  def restore_extras(self):
    return {}


class TorchCheckpoint:
  """Single-slot checkpoint of (engine state, iteration, writer state)."""

  def __init__(self, path: str):
    self._path = os.path.abspath(path)
    self._meta_path = os.path.join(self._path, META)

  def can_be_restored(self) -> bool:
    return os.path.exists(self._meta_path)

  def meta(self) -> Dict[str, Any]:
    with open(self._meta_path) as f:
      return json.load(f)

  def state_path(self) -> str:
    """The committed state file."""
    return os.path.join(self._path, self.meta()["state_file"])

  def save(self, state, iteration: int, writer_state: Mapping[str, Any],
           train_done: int = 0,
           extras: Optional[Mapping[str, float]] = None) -> None:
    """Writes `state` (a replay of None is left out) and commits it.

    train_done: supersteps already completed inside `iteration`'s train
    phase, so that a resumed run continues mid-iteration. extras: numbers
    that must outlive a subtree left out of `state` (the replay's insert
    counter and max-seen priority under --checkpoint_replay=false)."""
    os.makedirs(self._path, exist_ok=True)
    saves = self.meta()["saves"] + 1 if self.can_be_restored() else 1
    name = f"state.{saves}.pt"
    tmp = os.path.join(self._path, name + ".tmp")
    torch.save(flatten_state(state), tmp)
    os.replace(tmp, os.path.join(self._path, name))
    meta = {
        "iteration": int(iteration),
        "train_done": int(train_done),
        "header_written": bool(writer_state.get("header_written", False)),
        "fieldnames": list(writer_state.get("fieldnames") or []),
        "rows_written": int(writer_state.get("rows_written", -1)),
        "extras": {k: float(v) for k, v in (extras or {}).items()},
        "state_file": name,
        "saves": saves,
    }
    with open(self._meta_path + ".tmp", "w") as f:
      json.dump(meta, f)
    os.replace(self._meta_path + ".tmp", self._meta_path)
    for old in os.listdir(self._path):
      if old.startswith("state.") and old != name:
        os.remove(os.path.join(self._path, old))

  def restore(self, template) -> Tuple[Any, int, Mapping[str, Any], int]:
    """(state, iteration, writer state, train_done). The state's tensors
    are `template`'s, holding the saved values; a template replay of None
    stays None (and the file's replay, if any, is not read)."""
    meta = self.meta()
    flat = torch.load(self.state_path(), map_location="cpu",
                      weights_only=True, mmap=True)
    if template.replay is None:
      flat = {k: v for k, v in flat.items() if not k.startswith("replay.")}
    state = restore_state(template, flat)
    writer_state = {"header_written": meta["header_written"],
                    "fieldnames": meta["fieldnames"] or None}
    if meta["rows_written"] >= 0:
      writer_state["rows_written"] = meta["rows_written"]
    return state, meta["iteration"], writer_state, meta["train_done"]

  def restore_extras(self) -> Mapping[str, float]:
    """Numbers saved via `extras=`."""
    return self.meta()["extras"]
