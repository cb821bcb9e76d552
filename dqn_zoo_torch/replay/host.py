"""Host-side replay structures (port of dqn_zoo_tpu/replay/host.py).

NumPy, copied from the JAX package, which has the reference's host replay
API (dqn_zoo's replay.py): `Transition`,
`UniformDistribution`, `TransitionReplay` over a ring store,
`importance_sampling_weights`, the host `SumTree` and
`PrioritizedDistribution`, `PrioritizedTransitionReplay`, the 1-step and
n-step accumulators and zlib array compression. The same calls on the same
`np.random.RandomState` sample the same ids and give the same transitions
and weights as the JAX package's, bit for bit, and `get_state` /
`set_state` use the same plain structures (NumPy arrays, lists, dicts and
numbers), so a JAX replay's state loads here unchanged.

Timesteps are read only through their fields and `first()` / `last()`, so
a TimeStep works as well as the port's envs.timestep.TimeStep.

Semantics pinned by tests (tests/test_torch_host_replay.py against the JAX
package): priority exponent applied at insert with 0^0 = 0, the
uniform/proportional mixture and root == 0 fallback, the IS exponent
evaluated on the insert counter (ref replay.py:742-745), and the n-step
episode-end suffix flush.
"""

from __future__ import annotations

import typing
from typing import Any, Callable, Generic, Iterable, Mapping, Optional
from typing import Sequence, Tuple, TypeVar
import zlib

import numpy as np

from dqn_zoo_torch.envs.timestep import TimeStep

ReplayStructure = TypeVar("ReplayStructure", bound=Tuple[Any, ...])
CompressedArray = Tuple[bytes, Tuple, np.dtype]


class Transition(typing.NamedTuple):
  """Flat transition (ref replay.py:36-41)."""

  s_tm1: Optional[np.ndarray]
  a_tm1: Optional[int]
  r_t: Optional[float]
  discount_t: Optional[float]
  s_t: Optional[np.ndarray]


class UniformDistribution:
  """O(1) add/remove/uniform-sample over a dynamic set of integer IDs.

  Ref replay.py:44-117: swap-with-last array + id → position map.
  """

  def __init__(self, random_state: np.random.RandomState):
    self._random_state = random_state
    self._ids: list[int] = []
    self._pos: dict[int, int] = {}

  def add(self, ids: Sequence[int]) -> None:
    for i in ids:
      if i in self._pos:
        raise IndexError(f"ID {i} already added.")
      self._pos[i] = len(self._ids)
      self._ids.append(i)

  def remove(self, ids: Sequence[int]) -> None:
    for i in ids:
      if i not in self._pos:
        raise IndexError(f"ID {i} not found.")
      j = self._pos.pop(i)
      last = self._ids.pop()
      if last != i:  # move the tail ID into the vacated position
        self._ids[j] = last
        self._pos[last] = j

  def sample(self, size: int) -> np.ndarray:
    if not self._ids:
      raise RuntimeError("No IDs to sample.")
    picks = self._random_state.randint(len(self._ids), size=size)
    return np.asarray([self._ids[j] for j in picks], dtype=np.int64)

  def ids(self) -> Iterable[int]:
    return list(self._ids)

  @property
  def size(self) -> int:
    return len(self._ids)

  def get_state(self) -> Mapping[str, Any]:
    return {"ids": list(self._ids)}

  def set_state(self, state: Mapping[str, Any]) -> None:
    self._ids = list(state["ids"])
    self._pos = {i: j for j, i in enumerate(self._ids)}

  def check_valid(self) -> Tuple[bool, str]:
    if len(self._ids) != len(self._pos):
      return False, "ids and position map sizes differ."
    for j, i in enumerate(self._ids):
      if self._pos.get(i) != j:
        return False, f"position map wrong for ID {i}."
    return True, ""


class _RingStorage:
  """ID-indexed FIFO store: consecutive IDs land in slot id % capacity."""

  def __init__(self, capacity: int):
    self._slots: list[Any] = [None] * capacity
    self._capacity = capacity
    self.t = 0  # next ID

  @property
  def size(self) -> int:
    return min(self.t, self._capacity)

  @property
  def oldest_id(self) -> int:
    return self.t - self.size

  def append(self, item: Any) -> int:
    item_id = self.t
    self._slots[item_id % self._capacity] = item
    self.t += 1
    return item_id

  def get(self, item_id: int) -> Any:
    if not self.oldest_id <= item_id < self.t:
      raise KeyError(f"ID {item_id} not in storage.")
    return self._slots[item_id % self._capacity]

  def ids(self) -> Iterable[int]:
    return range(self.oldest_id, self.t)

  def get_state(self) -> Mapping[str, Any]:
    return {"items": [(i, self.get(i)) for i in self.ids()], "t": self.t}

  def set_state(self, state: Mapping[str, Any]) -> None:
    self.t = state["t"]
    self._slots = [None] * self._capacity
    for i, item in state["items"]:
      self._slots[i % self._capacity] = item


def _stack(structure: ReplayStructure,
           samples: Iterable[Tuple[Any, ...]]) -> ReplayStructure:
  columns = [np.stack(xs, axis=0) for xs in zip(*samples)]
  return type(structure)(*columns)


class TransitionReplay(Generic[ReplayStructure]):
  """Uniform replay over flat namedtuples (ref replay.py:120-200)."""

  def __init__(self, capacity: int, structure: ReplayStructure,
               random_state: np.random.RandomState,
               encoder: Optional[Callable[[ReplayStructure], Any]] = None,
               decoder: Optional[Callable[[Any], ReplayStructure]] = None):
    self._structure = structure
    self._encoder = encoder or (lambda s: s)
    self._decoder = decoder or (lambda s: s)
    self._distribution = UniformDistribution(random_state)
    self._storage = _RingStorage(capacity)

  def add(self, item: ReplayStructure) -> None:
    if self.size == self.capacity:
      self._distribution.remove([self._storage.oldest_id])
    self._distribution.add([self._storage.append(self._encoder(item))])

  def get(self, ids: Sequence[int]) -> Iterable[ReplayStructure]:
    for i in ids:
      yield self._decoder(self._storage.get(i))

  def sample(self, size: int) -> ReplayStructure:
    return _stack(self._structure,
                  self.get(self._distribution.sample(size)))

  def ids(self) -> Iterable[int]:
    return self._storage.ids()

  @property
  def size(self) -> int:
    return self._storage.size

  @property
  def capacity(self) -> int:
    return self._storage._capacity

  def get_state(self) -> Mapping[str, Any]:
    return {"storage": self._storage.get_state(),
            "distribution": self._distribution.get_state()}

  def set_state(self, state: Mapping[str, Any]) -> None:
    self._storage.set_state(state["storage"])
    self._distribution.set_state(state["distribution"])

  def check_valid(self) -> Tuple[bool, str]:
    if set(self._storage.ids()) != set(self._distribution.ids()):
      return False, "storage and distribution IDs differ."
    return self._distribution.check_valid()


def _power(base, exponent) -> np.ndarray:
  """base**exponent with 0^0 = 0 so zero priority is never sampleable
  (ref replay.py:203-208)."""
  base = np.asarray(base)
  return np.where(base == 0.0, 0.0, base ** exponent)


def importance_sampling_weights(probabilities: np.ndarray,
                                uniform_probability: float,
                                exponent: float,
                                normalize: bool) -> np.ndarray:
  """(uniform_p / p)^exponent, optionally max-normalized (ref
  replay.py:211-243)."""
  if not 0.0 <= exponent <= 1.0:
    raise ValueError("Require 0 <= exponent <= 1.")
  if not 0.0 <= uniform_probability <= 1.0:
    raise ValueError("Require 0 <= uniform_probability <= 1.")
  weights = (uniform_probability / np.asarray(probabilities)) ** exponent
  if normalize:
    weights = weights / np.max(weights)
  if not np.isfinite(weights).all():
    raise ValueError(f"Weights are not finite: {weights}.")
  return weights


class SumTree:
  """Flat implicit-heap sum tree with vectorized batched queries.

  Same contract as ref replay.py:246-426 (non-negative leaf values set
  externally, O(log n) set, prefix-sum query descent, resize preserving
  values); stored as one array `nodes` of length 2·capacity with the root
  at index 1 and leaves at [capacity, capacity + size).
  """

  def __init__(self):
    self._size = 0
    self._capacity = 1  # power of two ≥ size
    self._nodes = np.zeros((2,), np.float64)

  # --- public API ------------------------------------------------------------

  def resize(self, size: int) -> None:
    if size < 0:
      raise ValueError("Require size >= 0.")
    values = self.values[:size] if size < self._size else self.values
    self._build(size, values)

  def get(self, indices: Sequence[int]) -> np.ndarray:
    indices = np.asarray(indices)
    if indices.size and not ((0 <= indices) & (indices < self._size)).all():
      raise IndexError("index out of range.")
    return self._nodes[self._capacity + indices]

  def set(self, indices: Sequence[int], values: Sequence[float]) -> None:
    indices = np.asarray(indices)
    values = np.asarray(values, np.float64)
    if np.any(values < 0.0) or not np.isfinite(values).all():
      raise ValueError("Require finite values >= 0.")
    if indices.size and not ((0 <= indices) & (indices < self._size)).all():
      raise IndexError("index out of range.")
    nodes = np.unique(self._capacity + indices)
    self._nodes[self._capacity + indices] = values
    # Recompute ancestor sums level by level (duplicate-safe: sums are
    # rebuilt from children, not updated by deltas).
    while nodes.size and nodes[0] > 1:
      nodes = np.unique(nodes // 2)
      self._nodes[nodes] = (self._nodes[2 * nodes]
                            + self._nodes[2 * nodes + 1])

  def set_all(self, values: Sequence[float]) -> None:
    values = np.asarray(values, np.float64)
    if np.any(values < 0.0) or not np.isfinite(values).all():
      raise ValueError("Require finite values >= 0.")
    self._build(len(values), values)

  def query(self, targets: Sequence[float]) -> Sequence[int]:
    """Smallest leaf i per target with prefix_sum(i) > target, all targets
    descending the tree together (one vectorized step per level)."""
    targets = np.asarray(targets, np.float64)
    if targets.size and not ((0.0 <= targets) & (targets < self.root())).all():
      raise ValueError("Require 0 <= target < total sum.")
    node = np.ones(targets.shape, np.int64)
    remaining = targets.copy()
    while node[0] < self._capacity if node.size else False:
      left = 2 * node
      left_sum = self._nodes[left]
      go_right = remaining >= left_sum
      remaining = np.where(go_right, remaining - left_sum, remaining)
      node = np.where(go_right, left + 1, left)
    leaves = node - self._capacity
    if leaves.size and not (leaves < self._size).all():
      raise RuntimeError("query descended into zero padding.")
    return leaves

  def root(self) -> float:
    return float(self._nodes[1]) if self._size else np.nan

  @property
  def values(self) -> np.ndarray:
    return self._nodes[self._capacity:self._capacity + self._size].copy()

  @property
  def size(self) -> int:
    return self._size

  @property
  def capacity(self) -> int:
    return self._capacity

  def get_state(self) -> Mapping[str, Any]:
    return {"size": self._size, "values": self.values}

  def set_state(self, state: Mapping[str, Any]) -> None:
    self._build(state["size"], np.asarray(state["values"], np.float64))

  def check_valid(self) -> Tuple[bool, str]:
    for parent in range(1, self._capacity):
      expect = self._nodes[2 * parent] + self._nodes[2 * parent + 1]
      if not np.isclose(self._nodes[parent], expect):
        return False, f"node {parent} != sum of children."
    if np.any(self._nodes[self._capacity + self._size:] != 0.0):
      return False, "zero padding was modified."
    return True, ""

  # --- internals --------------------------------------------------------------

  def _build(self, size: int, values: np.ndarray) -> None:
    capacity = 1
    while capacity < size:
      capacity *= 2
    nodes = np.zeros((2 * capacity,), np.float64)
    nodes[capacity:capacity + len(values)] = values
    for parent in range(capacity - 1, 0, -1):
      nodes[parent] = nodes[2 * parent] + nodes[2 * parent + 1]
    self._size, self._capacity, self._nodes = size, capacity, nodes


class PrioritizedDistribution:
  """Weighted sampling of integer IDs (ref replay.py:429-651).

  Priorities are exponentiated at insert/update time (α, with 0^0 = 0);
  sampling mixes proportional draws with uniform-over-active draws at
  probability `uniform_sample_probability`, falling back to uniform when
  every priority is zero; capacity grows by doubling up to max_capacity.
  """

  def __init__(self, priority_exponent: float,
               uniform_sample_probability: float,
               random_state: np.random.RandomState,
               min_capacity: int = 0,
               max_capacity: Optional[int] = None):
    if priority_exponent < 0.0:
      raise ValueError("Require priority_exponent >= 0.")
    if not 0.0 <= uniform_sample_probability <= 1.0:
      raise ValueError("Require 0 <= uniform_sample_probability <= 1.")
    if min_capacity < 0:
      raise ValueError("Require min_capacity >= 0.")
    if max_capacity is not None and max_capacity < min_capacity:
      raise ValueError("Require max_capacity >= min_capacity.")
    self._priority_exponent = priority_exponent
    self._usp = uniform_sample_probability
    self._random_state = random_state
    self._max_capacity = max_capacity
    self._tree = SumTree()
    self._tree.resize(min_capacity)
    self._id_to_index: dict[int, int] = {}
    self._index_to_id: dict[int, int] = {}
    self._free: list[int] = list(range(min_capacity))
    self._active = UniformDistribution(random_state)  # over tree indices

  def ensure_capacity(self, capacity: int) -> None:
    if self._max_capacity is not None and capacity > self._max_capacity:
      raise ValueError(
          f"capacity {capacity} cannot exceed max_capacity "
          f"{self._max_capacity}")
    if capacity <= self._tree.size:
      return
    self._free.extend(range(self._tree.size, capacity))
    self._tree.resize(capacity)

  def add_priorities(self, ids: Sequence[int],
                     priorities: Sequence[float]) -> None:
    for i in ids:
      if i in self._id_to_index:
        raise IndexError(f"ID {i} already exists.")
    new_size = self.size + len(ids)
    if self._max_capacity is not None and new_size > self._max_capacity:
      raise ValueError("Cannot add IDs as max capacity would be exceeded.")
    if new_size > self.capacity:
      grown = max(new_size, 2 * self.capacity)
      self.ensure_capacity(grown if self._max_capacity is None
                           else min(self._max_capacity, grown))
    indices = [self._free.pop() for _ in ids]
    for i, idx in zip(ids, indices):
      self._id_to_index[i] = idx
      self._index_to_id[idx] = i
    self._active.add(indices)
    self._tree.set(indices, _power(priorities, self._priority_exponent))

  def remove_priorities(self, ids: Sequence[int]) -> None:
    indices = [self._id_to_index[i] for i in ids]
    for i, idx in zip(ids, indices):
      del self._id_to_index[i]
      del self._index_to_id[idx]
    self._active.remove(indices)
    self._free.extend(indices)
    self._tree.set(indices, np.zeros(len(indices)))

  def update_priorities(self, ids: Sequence[int],
                        priorities: Sequence[float]) -> None:
    for i in ids:
      if i not in self._id_to_index:
        raise IndexError(f"ID {i} does not exist.")
    self._tree.set([self._id_to_index[i] for i in ids],
                   _power(priorities, self._priority_exponent))

  def sample(self, size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(sampled ids, their mixture sampling probabilities)."""
    if self.size == 0:
      raise RuntimeError("No IDs to sample.")
    uniform_indices = self._active.sample(size)
    if self._tree.root() == 0.0:
      prioritized_indices = uniform_indices
    else:
      targets = self._random_state.uniform(size=size) * self._tree.root()
      prioritized_indices = np.asarray(self._tree.query(targets))
    indices = np.where(self._random_state.uniform(size=size) < self._usp,
                       uniform_indices, prioritized_indices)
    uniform_prob = 1.0 / self.size
    exp_priorities = self._tree.get(indices)
    if self._tree.root() == 0.0:
      proportional_probs = np.full_like(exp_priorities, uniform_prob)
    else:
      proportional_probs = exp_priorities / self._tree.root()
    probs = (1.0 - self._usp) * proportional_probs + self._usp * uniform_prob
    ids = np.asarray([self._index_to_id[idx] for idx in indices], np.int64)
    return ids, probs

  def get_exponentiated_priorities(self,
                                   ids: Sequence[int]) -> Sequence[float]:
    return self._tree.get([self._id_to_index[i] for i in ids])

  def ids(self) -> Iterable[int]:
    return self._id_to_index.keys()

  @property
  def capacity(self) -> int:
    return self._tree.size

  @property
  def size(self) -> int:
    return len(self._id_to_index)

  def get_state(self) -> Mapping[str, Any]:
    return {
        "sum_tree": self._tree.get_state(),
        "id_to_index": dict(self._id_to_index),
        "free": list(self._free),
        "active": self._active.get_state(),
    }

  def set_state(self, state: Mapping[str, Any]) -> None:
    self._tree.set_state(state["sum_tree"])
    self._id_to_index = dict(state["id_to_index"])
    self._index_to_id = {v: k for k, v in self._id_to_index.items()}
    self._free = list(state["free"])
    self._active.set_state(state["active"])

  def check_valid(self) -> Tuple[bool, str]:
    if len(self._id_to_index) != len(self._index_to_id):
      return False, "id/index maps differ in size."
    for i, idx in self._id_to_index.items():
      if self._index_to_id.get(idx) != i:
        return False, f"ID {i} does not round-trip."
    active = set(self._index_to_id)
    if set(self._active.ids()) != active:
      return False, "active set does not match index map."
    if sorted(self._free + list(active)) != list(range(self._tree.size)):
      return False, "free and active indices do not partition the tree."
    ok, msg = self._active.check_valid()
    if not ok:
      return ok, msg
    return self._tree.check_valid()


class PrioritizedTransitionReplay(Generic[ReplayStructure]):
  """Proportional prioritized replay (arXiv 1511.05952; ref
  replay.py:654-768).

  `importance_sampling_exponent` is a callable evaluated on the INSERT
  counter `t` (ref replay.py:742-745), so the anneal progresses with data
  written, not with samples drawn.
  """

  def __init__(self, capacity: int, structure: ReplayStructure,
               priority_exponent: float,
               importance_sampling_exponent: Callable[[int], float],
               uniform_sample_probability: float,
               normalize_weights: bool,
               random_state: np.random.RandomState,
               encoder: Optional[Callable[[ReplayStructure], Any]] = None,
               decoder: Optional[Callable[[Any], ReplayStructure]] = None):
    self._structure = structure
    self._encoder = encoder or (lambda s: s)
    self._decoder = decoder or (lambda s: s)
    self._distribution = PrioritizedDistribution(
        priority_exponent=priority_exponent,
        uniform_sample_probability=uniform_sample_probability,
        random_state=random_state,
        min_capacity=capacity, max_capacity=capacity)
    self._is_exponent = importance_sampling_exponent
    self._normalize_weights = normalize_weights
    self._storage = _RingStorage(capacity)

  def add(self, item: ReplayStructure, priority: float) -> None:
    if self.size == self.capacity:
      self._distribution.remove_priorities([self._storage.oldest_id])
    item_id = self._storage.append(self._encoder(item))
    self._distribution.add_priorities([item_id], [priority])

  def get(self, ids: Sequence[int]) -> Iterable[ReplayStructure]:
    for i in ids:
      yield self._decoder(self._storage.get(i))

  def sample(self, size: int
             ) -> Tuple[ReplayStructure, np.ndarray, np.ndarray]:
    ids, probabilities = self._distribution.sample(size)
    weights = importance_sampling_weights(
        probabilities,
        uniform_probability=1.0 / self.size,
        exponent=self.importance_sampling_exponent,
        normalize=self._normalize_weights)
    return _stack(self._structure, self.get(ids)), ids, weights

  def update_priorities(self, ids: Sequence[int],
                        priorities: Sequence[float]) -> None:
    self._distribution.update_priorities(ids, np.asarray(priorities))

  @property
  def size(self) -> int:
    return self._storage.size

  @property
  def capacity(self) -> int:
    return self._storage._capacity

  @property
  def importance_sampling_exponent(self):
    return self._is_exponent(self._storage.t)

  def get_state(self) -> Mapping[str, Any]:
    return {"storage": self._storage.get_state(),
            "distribution": self._distribution.get_state()}

  def set_state(self, state: Mapping[str, Any]) -> None:
    self._storage.set_state(state["storage"])
    self._distribution.set_state(state["distribution"])

  def check_valid(self) -> Tuple[bool, str]:
    if set(self._storage.ids()) != set(self._distribution.ids()):
      return False, "storage and distribution IDs differ."
    return self._distribution.check_valid()


class TransitionAccumulator:
  """Pairs consecutive timesteps into 1-step transitions (ref
  replay.py:771-805); resets on FIRST, yields nothing until two timesteps
  have been seen."""

  def __init__(self):
    self.reset()

  def step(self, timestep_t: TimeStep, a_t: int
           ) -> Iterable[Transition]:
    if timestep_t.first():
      self.reset()
    if self._prev is None:
      if not timestep_t.first():
        raise ValueError(f"Expected FIRST timestep, got {timestep_t}.")
    else:
      prev_ts, prev_a = self._prev
      yield Transition(s_tm1=prev_ts.observation, a_tm1=prev_a,
                       r_t=timestep_t.reward,
                       discount_t=timestep_t.discount,
                       s_t=timestep_t.observation)
    self._prev = (timestep_t, a_t)

  def reset(self) -> None:
    self._prev = None


def _fold_n_step(steps: Sequence[Transition]) -> Transition:
  """r = Σ_m Π_{l<m} γ_l · r_m, γ = Π γ_m (ref replay.py:808-823)."""
  r_t, discount_t = 0.0, 1.0
  for tr in steps:
    r_t += discount_t * tr.r_t
    discount_t *= tr.discount_t
  return Transition(s_tm1=steps[0].s_tm1, a_tm1=steps[0].a_tm1, r_t=r_t,
                    discount_t=discount_t, s_t=steps[-1].s_t)


class NStepTransitionAccumulator:
  """n-step accumulator (ref replay.py:826-892).

  MID: yields one n-step transition once n 1-step transitions are queued.
  LAST: flushes the whole suffix — n, n-1, ..., 1-step transitions all
  ending at the terminal state (ref replay.py:873-886).
  """

  def __init__(self, n: int):
    self._n = n
    self.reset()

  def step(self, timestep_t: TimeStep, a_t: int
           ) -> Iterable[Transition]:
    if timestep_t.first():
      self.reset()
    if self._prev is None:
      if not timestep_t.first():
        raise ValueError(f"Expected FIRST timestep, got {timestep_t}.")
      self._prev = (timestep_t, a_t)
      return
    prev_ts, prev_a = self._prev
    self._steps.append(Transition(
        s_tm1=prev_ts.observation, a_tm1=prev_a, r_t=timestep_t.reward,
        discount_t=timestep_t.discount, s_t=timestep_t.observation))
    self._prev = (timestep_t, a_t)
    if timestep_t.last():
      while self._steps:
        yield _fold_n_step(self._steps)
        self._steps.pop(0)
    elif len(self._steps) == self._n:
      yield _fold_n_step(self._steps)
      self._steps.pop(0)

  def reset(self) -> None:
    self._steps: list[Transition] = []
    self._prev = None


def compress_array(array: np.ndarray) -> CompressedArray:
  """Compresses an array keeping shape and dtype (ref replay.py:895-898
  uses snappy; zlib level 1 here — same capability, stdlib-only)."""
  return zlib.compress(array.tobytes(), 1), array.shape, array.dtype


def uncompress_array(compressed: CompressedArray) -> np.ndarray:
  data, shape, dtype = compressed
  return np.frombuffer(zlib.decompress(data), dtype=dtype).reshape(shape)
