"""The replay as the reference rebuilds it, in plain PyTorch.

One row per (stream, agent step) in a ring of C slots a stream, written in
lockstep. The rules it keeps are the replay's published ones:
  - a row is sampleable (active) once its n-step future has been written,
    or earlier where an episode ends inside that future, never when it is
    terminal itself, and only while the K - 1 rows before it are still in
    the ring (their frames make its stack);
  - a sample is uniform over the active rows, or, for prioritized replay
    (Schaul et al. 2016), with probability 1 - ε proportional to
    priority^α and with probability ε uniform; new rows enter at the
    largest priority seen so far; importance weights (1 / (N P(i)))^β
    divided by their maximum over each chunk of the agent's batch;
  - a transition's return folds the rewards of the next n rows, each
    discounted by the rows before it, and stops at a terminal row;
  - a stack holds the row and up to K - 1 rows before it, back to its
    episode's first row, oldest first, zero-padded after.

Rows the benchmark filled come from the traffic's seed (benchmark/traffic);
rows the run wrote during the steps the reference follows come from the
reference's own frames of the env's raw output. A sample's leaves are the
program's, judged here against the row intervals of this model.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from benchmark.traffic import FillRows


class Batch(NamedTuple):
  s_tm1: torch.Tensor  # (B, 84, 84, K) uint8
  a_tm1: torch.Tensor  # (B,) int64
  r_t: torch.Tensor  # (B,) float32
  discount_t: torch.Tensor  # (B,) float32
  s_t: torch.Tensor  # (B, 84, 84, K) uint8


class ReplayModel:

  def __init__(self, fill: FillRows, num_streams: int, slots: int,
               n_step: int, inserted: int, device, stack: int = 4,
               priority_exponent: float = 0.0,
               uniform_sample_probability: float = 0.0,
               weight_chunk: int = 0):
    self.fill, self.s, self.c, self.n, self.k = (fill, num_streams, slots,
                                                 n_step, stack)
    self.t = inserted  # rows a stream written so far
    self.t_fill = inserted
    self.dev = device
    self.alpha = priority_exponent
    self.eps = uniform_sample_probability
    self.chunk = weight_chunk
    self.env: Dict[str, torch.Tensor] = {}  # field -> (E, S, ...) written rows
    self.max_seen = 1.0
    self.value: Optional[torch.Tensor] = None
    if self.alpha > 0:
      # No priority is written during the fill: every active row holds
      # max_seen^α = 1.
      self.value = self.active().to(torch.float64)

  # --- rows -------------------------------------------------------------------

  def write(self, row: Dict[str, torch.Tensor]) -> None:
    """Writes one row a stream (fields of shape (S, ...)) at step t."""
    before = self.active() if self.alpha > 0 else None
    for name, v in row.items():
      v = v[None]
      self.env[name] = v if name not in self.env else torch.cat(
          [self.env[name], v])
    self.t += 1
    if self.alpha > 0:
      after = self.active()
      new = after & ~before
      self.value = torch.where(new, self.max_seen ** self.alpha,
                               torch.where(after, self.value, 0.0))

  def _lookup(self, name: str, stream, step, filled):
    """Field `name` of rows (stream, step): the fill rows' from `filled`,
    the written rows' from the table."""
    if not self.env:
      return filled
    idx = torch.clamp(step - self.t_fill, min=0)
    idx = torch.clamp(idx, max=self.env[name].shape[0] - 1)
    mine = self.env[name][idx, stream]
    written = step >= self.t_fill
    while written.dim() < mine.dim():
      written = written[..., None]
    return torch.where(written, mine, filled)

  def meta(self, stream, step):
    """(stack_count, action, reward, discount, is_terminal) of rows."""
    filled = self.fill.meta(stream, step)
    names = ("stack_count", "action", "reward", "discount", "is_terminal")
    return tuple(self._lookup(n, stream, step, f)
                 for n, f in zip(names, filled))

  def frames(self, stream, step):
    return self._lookup("frame", stream, step,
                        self.fill.frames(stream, step))

  # --- which rows are active ---------------------------------------------------

  def slot_steps(self) -> torch.Tensor:
    """(S·C,) the step each leaf's slot holds (leaf = stream · C + slot)."""
    slot = torch.arange(self.c, device=self.dev)
    step = slot + self.c * ((self.t - 1 - slot) // self.c)
    return step.repeat(self.s)

  def active(self) -> torch.Tensor:
    step = self.slot_steps()
    stream = torch.arange(self.s, device=self.dev).repeat_interleave(self.c)
    last = self.t - 1
    alive = step >= self.t - self.c + self.k - 1
    term = self.meta(stream, step)[4]
    ready = step + self.n <= last
    for m in range(1, self.n):
      later = step + m
      ready = ready | ((later <= last)
                       & self.meta(stream, torch.clamp(later, max=last))[4])
    return alive & ~term & ready

  # --- sampling ----------------------------------------------------------------

  def sample_gap(self, leaves: torch.Tensor, uniforms: torch.Tensor) -> float:
    """How far the program's leaves lie from the rows its uniforms pick: the
    largest distance, as a share of the tree's total, between the query
    point and the chosen leaf's interval of the cumulative mass (0 where
    the leaf is the one the query names); 1 for a leaf that is not active.
    """
    active = self.active()
    ind = active.to(torch.float64)
    leaves = leaves.long()
    if self.alpha == 0:
      gap = self._interval_gap(ind, leaves, uniforms.double())
    else:
      u, p, mix = uniforms.double()
      gu = self._interval_gap(ind, leaves, u)
      gp = self._interval_gap(self.value, leaves, p)
      gap = torch.where(mix < self.eps, gu, gp)
    gap = torch.where(active[leaves], gap, torch.ones_like(gap))
    return float(gap.max())

  @staticmethod
  def _interval_gap(mass: torch.Tensor, leaves, u) -> torch.Tensor:
    total = mass.sum()
    incl = torch.cumsum(mass, 0)
    hi = incl[leaves]
    lo = hi - mass[leaves]
    x = u * total
    return torch.clamp(torch.maximum(lo - x, x - hi), min=0.0) / total

  def batch(self, leaves: torch.Tensor, beta: float):
    """(Batch, importance weights) of the rows at `leaves`."""
    leaves = leaves.long()
    stream, slot = leaves // self.c, leaves % self.c
    step = self.slot_steps()[leaves]
    b = leaves.shape[0]
    r = torch.zeros((b,), dtype=torch.float32, device=self.dev)
    disc = torch.ones((b,), dtype=torch.float32, device=self.dev)
    ended = torch.zeros((b,), dtype=torch.bool, device=self.dev)
    m_star = torch.full((b,), self.n, dtype=torch.int64, device=self.dev)
    for m in range(1, self.n + 1):
      _, _, r_m, g_m, term_m = self.meta(stream, step + m)
      r = torch.where(ended, r, r + disc * r_m)
      disc = torch.where(ended, disc, disc * g_m)
      m_star = torch.where(~ended & term_m, m, m_star)
      ended = ended | term_m
    count, action = self.meta(stream, step)[:2]
    count_t = self.meta(stream, step + m_star)[0]
    batch = Batch(self._stack(stream, step, count.long()), action.long(), r,
                  disc, self._stack(stream, step + m_star, count_t.long()))
    if self.alpha == 0:
      return batch, torch.ones((b,), dtype=torch.float32, device=self.dev)
    active = self.active().to(torch.float64)
    n = max(float(active.sum()), 1.0)
    probs = (1.0 - self.eps) * self.value[leaves] / self.value.sum() \
        + self.eps / n
    w = (1.0 / (probs * n)) ** beta
    chunk = self.chunk if 0 < self.chunk < b and b % self.chunk == 0 else b
    w = w.view(b // chunk, chunk)
    w = (w / w.max(dim=1, keepdim=True).values).view(b)
    return batch, w.to(torch.float32)

  def _stack(self, stream, step, count) -> torch.Tensor:
    j = torch.arange(self.k, device=self.dev)
    rows = step[:, None] - count[:, None] + 1 + j[None, :]
    valid = j[None, :] < count[:, None]
    f = self.frames(stream[:, None].expand_as(rows), torch.where(
        valid, rows, step[:, None]))
    f = torch.where(valid[:, :, None, None], f, torch.zeros_like(f))
    return f.permute(0, 2, 3, 1).contiguous()

  def write_priorities(self, leaves: torch.Tensor,
                       priorities: torch.Tensor) -> None:
    """Sets sampled rows' priorities (the last of a leaf's duplicates
    counts; rows no longer active keep 0) and raises the largest seen."""
    leaves = leaves.long()
    uniq, inv = torch.unique(leaves, return_inverse=True)
    pos = torch.arange(leaves.shape[0], device=self.dev)
    last = torch.full(uniq.shape, -1, dtype=torch.int64, device=self.dev)
    last = last.scatter_reduce(0, inv, pos, reduce="amax")
    p = priorities.double()[last]
    active = self.active()[uniq]
    self.value[uniq] = torch.where(active, p ** self.alpha, self.value[uniq])
    self.max_seen = max(self.max_seen, float(priorities.max()))
