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

`RankCheckpoint` is the slot of a data-parallel run (parallel/): each rank
writes its own state file, and the first rank commits the meta file once
every rank's is written. A restore requires as many ranks as the save had.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from dqn_zoo_torch.device import resolve_device

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

  world_size = 1  # the ranks whose states one slot holds

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

  def _next_saves(self) -> int:
    os.makedirs(self._path, exist_ok=True)
    return self.meta()["saves"] + 1 if self.can_be_restored() else 1

  def _write(self, state, name: str) -> None:
    tmp = os.path.join(self._path, name + ".tmp")
    torch.save(flatten_state(state), tmp)
    os.replace(tmp, os.path.join(self._path, name))

  def _commit(self, meta: Dict[str, Any], keep) -> None:
    """Replaces the meta file, then deletes the state files it does not
    name (`keep`)."""
    with open(self._meta_path + ".tmp", "w") as f:
      json.dump(meta, f)
    os.replace(self._meta_path + ".tmp", self._meta_path)
    for old in os.listdir(self._path):
      if old.startswith("state.") and old not in keep:
        os.remove(os.path.join(self._path, old))

  @staticmethod
  def _meta(iteration, writer_state, train_done, extras, saves) -> dict:
    return {
        "iteration": int(iteration),
        "train_done": int(train_done),
        "header_written": bool(writer_state.get("header_written", False)),
        "fieldnames": list(writer_state.get("fieldnames") or []),
        "rows_written": int(writer_state.get("rows_written", -1)),
        "extras": {k: float(v) for k, v in (extras or {}).items()},
        "saves": saves,
    }

  def save(self, state, iteration: int, writer_state: Mapping[str, Any],
           train_done: int = 0,
           extras: Optional[Mapping[str, float]] = None) -> None:
    """Writes `state` (a replay of None is left out) and commits it.

    train_done: supersteps already completed inside `iteration`'s train
    phase, so that a resumed run continues mid-iteration. extras: numbers
    that must outlive a subtree left out of `state` (the replay's insert
    counter and max-seen priority under --checkpoint_replay=false)."""
    saves = self._next_saves()
    name = f"state.{saves}.pt"
    self._write(state, name)
    self._commit(dict(self._meta(iteration, writer_state, train_done, extras,
                                 saves), state_file=name), keep={name})

  def restore(self, template) -> Tuple[Any, int, Mapping[str, Any], int]:
    """(state, iteration, writer state, train_done). The state's tensors
    are `template`'s, holding the saved values; a template replay of None
    stays None (and the file's replay, if any, is not read). Raises where
    the slot holds another number of ranks' states than this run has."""
    meta = self.meta()
    if meta.get("world_size", 1) != self.world_size:
      raise ValueError(f"the checkpoint holds {meta.get('world_size', 1)} "
                       f"ranks' states; this run has {self.world_size}.")
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


def exchange_device(device=None) -> torch.device:
  """Where the default process group's collectives take their tensors:
  `device` when given; else the current card under NCCL (raising where
  there is none), the CPU under any other backend (gloo)."""
  if device is not None:
    return torch.device(device)
  if dist.get_backend() == "nccl":
    resolve_device("cuda")
    return torch.device("cuda", torch.cuda.current_device())
  return torch.device("cpu")


class RankCheckpoint(TorchCheckpoint):
  """The slot of a data-parallel run, saved and restored on every rank of
  the process group together: each rank writes `state.{saves}.rank{r}.pt`,
  then the first rank commits the meta file (with the world size) once
  every rank's file is written. The path must be on a file system that
  every rank sees. `device` holds the few numbers the ranks exchange; None
  resolves it as every entry point does: this rank's card under NCCL, the
  CPU under gloo (`exchange_device`)."""

  def __init__(self, path: str, device=None):
    super().__init__(path)
    self._device = exchange_device(device)
    self.rank = dist.get_rank()
    self.world_size = dist.get_world_size()

  def state_path(self) -> str:
    return os.path.join(self._path,
                        f"state.{self.meta()['saves']}.rank{self.rank}.pt")

  def _max_over_ranks(self, values) -> list:
    """Each value's max over the ranks. A collective, and a barrier: it
    returns once every rank has reached it."""
    t = torch.tensor([float(v) for v in values] + [0.0], dtype=torch.float64,
                     device=self._device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.tolist()[:-1]

  def save(self, state, iteration: int, writer_state: Mapping[str, Any],
           train_done: int = 0,
           extras: Optional[Mapping[str, float]] = None) -> None:
    """TorchCheckpoint.save on every rank; `extras` are saved as their max
    over the ranks (the JAX CLI's rule for the replay's insert counter and
    max-seen priority), and the writer state is the first rank's."""
    saves = self._next_saves()
    self._write(state, f"state.{saves}.rank{self.rank}.pt")
    keys = sorted(extras or {})
    extras = dict(zip(keys, self._max_over_ranks(
        [extras[k] for k in keys])))  # every rank's file is written
    if self.rank == 0:
      self._commit(dict(self._meta(iteration, writer_state, train_done,
                                   extras, saves),
                        world_size=self.world_size),
                   keep={f"state.{saves}.rank{r}.pt"
                         for r in range(self.world_size)})
    self._max_over_ranks([])  # no rank goes on before the commit
