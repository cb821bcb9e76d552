"""Device-resident replay (port of dqn_zoo_tpu/replay/device_replay.py).

One row per (stream, agent-step): the newest 84×84 frame of that step's
observation stack, the stack fill count, the action taken and the
aggregated reward/discount received at that step. Stacks are rebuilt at
sample time from one contiguous window of K + n rows (kernel K1); n-step
returns are folded at sample time; a row activates when its n-step future
has landed or its episode ended (the reference's suffix flush). Inserting at
slot t mod C deactivates that slot and the K-1 after it, whose stacks would
need frames older than the ring. Rows C..C+W-2 of the frame store mirror
slots 0..W-2 so that no window wraps; row C+W-1 is a write sink.

Priorities live in two fanout trees: `value_tree` holds priority^α of the
active rows (0 elsewhere, the reference's 0^0 = 0 rule), `indicator_tree`
1.0 at active rows. A sample mixes uniform-over-active (with probability
`uniform_sample_probability`) and proportional draws. Uniform replay
(α = 0) keeps one tree: the value tree is the indicator tree, and a sample
is one query of it with IS weights of one. `replay_insert` and
`replay_update_priorities` update the state IN PLACE.

Invariants (C = slots per stream, n = n_step, K = stack size): C > n + K;
active ⇔ indicator leaf == 1 ⇔ the row yields a well-defined transition.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from dqn_zoo_torch.replay import fanout_tree as ft
from dqn_zoo_torch.replay import window_gather as wg


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
  num_streams: int  # S
  slots_per_stream: int  # C
  n_step: int = 1
  stack_size: int = 4
  frame_size: int = 84
  priority_exponent: float = 0.0  # α; 0 → uniform replay
  uniform_sample_probability: float = 0.0  # mixture weight
  normalize_weights: bool = True
  # IS weights are divided by their max over each chunk of this many
  # samples (the reference's batch), so that a big batch keeps the
  # reference's per-update weight scale; 0, or a chunk that does not divide
  # the batch into several, takes one max over the batch.
  normalize_weights_chunk: int = 0

  def __post_init__(self):
    if self.slots_per_stream <= self.n_step + self.stack_size:
      raise ValueError("slots_per_stream must exceed n_step + stack_size")

  @property
  def window(self) -> int:
    """Consecutive rows covering both sampled stacks: K + n."""
    return self.stack_size + self.n_step

  @property
  def slots_padded(self) -> int:
    return self.slots_per_stream + self.window


class ReplayState(NamedTuple):
  frames: torch.Tensor  # (S, C+W, F, F) uint8
  stack_count: torch.Tensor  # (S, C) int32 in [1, K]
  action: torch.Tensor  # (S, C) int32
  reward: torch.Tensor  # (S, C) float32
  discount: torch.Tensor  # (S, C) float32
  is_terminal: torch.Tensor  # (S, C) bool
  row_t: torch.Tensor  # (S, C) int32 — global step of the row, -1 if empty
  value_tree: ft.Tree  # priority^α at active rows; the indicator tree if α = 0
  indicator_tree: ft.Tree  # 1.0 at active rows
  t: int  # rows inserted per stream so far
  max_seen_priority: torch.Tensor  # () float32; new rows get it^α


class TransitionBatch(NamedTuple):
  s_tm1: torch.Tensor  # (B, F, F, K) uint8
  a_tm1: torch.Tensor  # (B,) int32
  r_t: torch.Tensor  # (B,) float32
  discount_t: torch.Tensor  # (B,) float32
  s_t: torch.Tensor  # (B, F, F, K) uint8


def _pexp(priorities: torch.Tensor, exponent: float) -> torch.Tensor:
  """priority^exponent with the reference's 0^0 = 0 rule."""
  return torch.where(priorities > 0.0,
                     torch.pow(torch.clamp(priorities, min=1e-30), exponent),
                     torch.zeros_like(priorities))


def replay_init(cfg: ReplayConfig, device) -> ReplayState:
  s, c, f = cfg.num_streams, cfg.slots_per_stream, cfg.frame_size
  kw = dict(device=device)
  ind = ft.fanout_init(s * c, device)
  return ReplayState(
      frames=torch.zeros((s, cfg.slots_padded, f, f), dtype=torch.uint8, **kw),
      stack_count=torch.ones((s, c), dtype=torch.int32, **kw),
      action=torch.zeros((s, c), dtype=torch.int32, **kw),
      reward=torch.zeros((s, c), dtype=torch.float32, **kw),
      discount=torch.zeros((s, c), dtype=torch.float32, **kw),
      is_terminal=torch.zeros((s, c), dtype=torch.bool, **kw),
      row_t=torch.full((s, c), -1, dtype=torch.int32, **kw),
      value_tree=(ft.fanout_init(s * c, device) if cfg.priority_exponent > 0
                  else ind),
      indicator_tree=ind,
      t=0,
      max_seen_priority=torch.ones((), dtype=torch.float32, **kw),
  )


def replay_insert(cfg: ReplayConfig, state: ReplayState,
                  frame: torch.Tensor, stack_count: torch.Tensor,
                  action: torch.Tensor, reward: torch.Tensor,
                  discount: torch.Tensor,
                  is_terminal: torch.Tensor) -> ReplayState:
  """Inserts one row per stream (lockstep) IN PLACE and updates which rows
  are active. Returns the state with `t` advanced."""
  c, n, w = cfg.slots_per_stream, cfg.n_step, cfg.window
  t = state.t
  slot = t % c
  dev = state.frames.device
  streams = torch.arange(cfg.num_streams, device=dev)

  state.frames[:, slot] = frame
  state.frames[:, c + slot if slot < w - 1 else c + w - 1] = frame
  state.stack_count[:, slot] = stack_count.to(torch.int32)
  state.action[:, slot] = action.to(torch.int32)
  state.reward[:, slot] = reward
  state.discount[:, slot] = discount
  state.is_terminal[:, slot] = is_terminal
  state.row_t[:, slot] = t

  leaf = lambda step: streams * c + step % c
  kill_ids = torch.cat([leaf(t + off) for off in range(cfg.stack_size)])
  ind = state.indicator_tree

  def activation(step, extra_mask):
    a_slot = step % c
    ids = leaf(step)
    mask = (state.row_t[:, a_slot] == step) & ~state.is_terminal[:, a_slot] \
        & (ft.fanout_get(ind, ids) == 0.0) & extra_mask
    if step < 0:
      mask = torch.zeros_like(mask)
    return ids, mask

  pairs = [activation(t - n, torch.ones_like(is_terminal))]
  # Suffix flush: a terminal insert activates rows t-1 .. t-(n-1) early.
  pairs += [activation(t - off, is_terminal) for off in range(1, n)]
  act_ids = torch.cat([p[0] for p in pairs])
  act_masks = torch.cat([p[1] for p in pairs])
  all_ids = torch.cat([kill_ids, act_ids])
  kills = torch.zeros(kill_ids.shape, device=dev)
  cur = ft.fanout_get(ind, act_ids)
  ft.fanout_set(ind, all_ids,
                torch.cat([kills, torch.where(act_masks, 1.0, cur)]))
  if cfg.priority_exponent > 0.0:
    prio = _pexp(state.max_seen_priority, cfg.priority_exponent)
    cur = ft.fanout_get(state.value_tree, act_ids)
    ft.fanout_set(state.value_tree, all_ids,
                  torch.cat([kills, torch.where(act_masks, prio, cur)]))
  return state._replace(t=t + 1)


def _stack_from_window(cfg: ReplayConfig, windows: torch.Tensor,
                       count: torch.Tensor,
                       offset: torch.Tensor) -> torch.Tensor:
  """(B, F, F, K) stacks from (B, W, F, F) windows: the row at window
  position `offset` with its count-1 predecessors, zero-padded after."""
  k = cfg.stack_size
  j = torch.arange(k, device=windows.device)
  idx = offset[:, None] - (count[:, None] - 1) + j[None, :]
  valid = j[None, :] < count[:, None]
  idx = torch.clamp(idx, 0, cfg.window - 1).long()
  f = windows.shape[-1]
  stack = torch.gather(windows, 1,
                       idx[:, :, None, None].expand(-1, -1, f, f))
  stack = torch.where(valid[:, :, None, None], stack,
                      torch.zeros_like(stack))
  return stack.permute(0, 2, 3, 1).contiguous()


def replay_sample(cfg: ReplayConfig, state: ReplayState,
                  uniforms: torch.Tensor,
                  importance_sampling_exponent: float = 0.0
                  ) -> Tuple[TransitionBatch, torch.Tensor, torch.Tensor]:
  """Samples B transitions; returns (batch, leaf indices, IS weights).

  Uniform replay (α = 0): `uniforms` is (B,) U[0, 1), one query of the
  indicator tree, weights all ones. Prioritized: `uniforms` is (3, B), the
  streams u, p and mix that the JAX package splits its key into: with
  probability `uniform_sample_probability` (mix < it) uniform over active
  rows by u, else proportional to priority^α by p. The IS weights are
  (1 / (P(i) · N))^β with the mixture probabilities, normalized as the
  config says."""
  c, n, k = cfg.slots_per_stream, cfg.n_step, cfg.stack_size
  n_active = ft.fanout_total(state.indicator_tree)
  if cfg.priority_exponent == 0.0:
    leaves = ft.fanout_query(state.indicator_tree,
                             uniforms.to(torch.float32) * n_active)
  else:
    u, p, mix = uniforms.to(torch.float32)
    total_p = ft.fanout_total(state.value_tree)
    leaves = torch.where(
        mix < cfg.uniform_sample_probability,
        ft.fanout_query(state.indicator_tree, u * n_active),
        ft.fanout_query(state.value_tree, p * total_p))
  b = leaves.shape[0]
  stream = leaves // c
  slot = leaves % c
  k_step = state.row_t[stream, slot].long()

  dev = uniforms.device
  m_star = torch.full((b,), n, dtype=torch.int64, device=dev)
  r_fold = torch.zeros((b,), dtype=torch.float32, device=dev)
  cum_disc = torch.ones((b,), dtype=torch.float32, device=dev)
  ended = torch.zeros((b,), dtype=torch.bool, device=dev)
  zero = torch.zeros_like(r_fold)
  for m in range(1, n + 1):
    fslot = (k_step + m) % c
    r_m = state.reward[stream, fslot]
    g_m = state.discount[stream, fslot]
    term_m = state.is_terminal[stream, fslot]
    live = ~ended
    r_fold = r_fold + torch.where(live, cum_disc * r_m, zero)
    cum_disc = torch.where(live, cum_disc * g_m, cum_disc)
    m_star = torch.where(live & term_m, m, m_star)
    ended = ended | term_m

  w0_slot = (k_step - (k - 1)) % c  # never wraps: margin rows mirror
  windows = wg.gather_windows(state.frames, stream, w0_slot, cfg.window)
  count_tm1 = state.stack_count[stream, slot].long()
  count_t = state.stack_count[stream, (k_step + m_star) % c].long()
  off_tm1 = torch.full((b,), k - 1, dtype=torch.int64, device=dev)
  batch = TransitionBatch(
      s_tm1=_stack_from_window(cfg, windows, count_tm1, off_tm1),
      a_tm1=state.action[stream, slot],
      r_t=r_fold,
      discount_t=cum_disc,
      s_t=_stack_from_window(cfg, windows, count_t, off_tm1 + m_star),
  )
  if cfg.priority_exponent == 0.0:
    return batch, leaves, torch.ones((b,), dtype=torch.float32, device=dev)
  num = torch.clamp(n_active, min=1.0)
  probs = (1.0 - cfg.uniform_sample_probability) \
      * ft.fanout_get(state.value_tree, leaves) \
      / torch.clamp(total_p, min=1e-30) \
      + cfg.uniform_sample_probability / num
  weights = importance_sampling_weights(probs, num,
                                        importance_sampling_exponent,
                                        normalize=False)
  if cfg.normalize_weights:
    chunk = cfg.normalize_weights_chunk
    if not (0 < chunk < b and b % chunk == 0):
      chunk = b
    w = weights.view(b // chunk, chunk)
    weights = (w / torch.clamp(w.max(dim=1, keepdim=True).values, min=1e-30)
               ).view(b)
  return batch, leaves, weights


def replay_update_priorities(cfg: ReplayConfig, state: ReplayState,
                             leaves: torch.Tensor,
                             priorities: torch.Tensor) -> None:
  """Sets the raw priorities of sampled rows IN PLACE (rows that went
  inactive since the sample keep their 0); a leaf sampled twice takes its
  last priority. Raises `max_seen_priority` to the largest of them."""
  still_active = ft.fanout_get(state.indicator_tree, leaves) > 0.0
  cur = ft.fanout_get(state.value_tree, leaves)
  ft.fanout_set(state.value_tree, leaves,
                torch.where(still_active,
                            _pexp(priorities, cfg.priority_exponent), cur))
  torch.maximum(state.max_seen_priority, priorities.max(),
                out=state.max_seen_priority)


def importance_sampling_weights(probs: torch.Tensor, num,
                                exponent: float,
                                normalize: bool = True) -> torch.Tensor:
  """(1 / (P(i) · N))^β, divided by its max when `normalize`."""
  w = torch.pow(1.0 / (torch.clamp(probs, min=1e-30) * num), exponent)
  if normalize:
    w = w / torch.clamp(w.max(), min=1e-30)
  return w


def replay_size(state: ReplayState) -> torch.Tensor:
  """Number of sampleable transitions (active rows), int32."""
  return ft.fanout_total(state.indicator_tree).to(torch.int32)
