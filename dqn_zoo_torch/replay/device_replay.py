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

This slice ports the uniform path: priority_exponent > 0 raises until the
prioritized slice. `replay_insert` updates the state IN PLACE.

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
  priority_exponent: float = 0.0

  def __post_init__(self):
    if self.slots_per_stream <= self.n_step + self.stack_size:
      raise ValueError("slots_per_stream must exceed n_step + stack_size")
    if self.priority_exponent > 0.0:
      raise NotImplementedError(
          "prioritized replay (priority_exponent > 0) is not ported yet.")

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
  indicator_tree: ft.Tree  # 1.0 at active rows
  t: int  # rows inserted per stream so far


class TransitionBatch(NamedTuple):
  s_tm1: torch.Tensor  # (B, F, F, K) uint8
  a_tm1: torch.Tensor  # (B,) int32
  r_t: torch.Tensor  # (B,) float32
  discount_t: torch.Tensor  # (B,) float32
  s_t: torch.Tensor  # (B, F, F, K) uint8


def replay_init(cfg: ReplayConfig, device) -> ReplayState:
  s, c, f = cfg.num_streams, cfg.slots_per_stream, cfg.frame_size
  kw = dict(device=device)
  return ReplayState(
      frames=torch.zeros((s, cfg.slots_padded, f, f), dtype=torch.uint8, **kw),
      stack_count=torch.ones((s, c), dtype=torch.int32, **kw),
      action=torch.zeros((s, c), dtype=torch.int32, **kw),
      reward=torch.zeros((s, c), dtype=torch.float32, **kw),
      discount=torch.zeros((s, c), dtype=torch.float32, **kw),
      is_terminal=torch.zeros((s, c), dtype=torch.bool, **kw),
      row_t=torch.full((s, c), -1, dtype=torch.int32, **kw),
      indicator_tree=ft.fanout_init(s * c, device),
      t=0,
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
  cur = ft.fanout_get(ind, act_ids)
  writes = torch.cat([torch.zeros(kill_ids.shape, device=dev),
                      torch.where(act_masks, 1.0, cur)])
  ft.fanout_set(ind, torch.cat([kill_ids, act_ids]), writes)
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
                  uniforms: torch.Tensor
                  ) -> Tuple[TransitionBatch, torch.Tensor, torch.Tensor]:
  """Samples len(uniforms) transitions uniformly over active rows.

  uniforms: (B,) U[0, 1) draws. Returns (batch, leaf indices, IS weights);
  the weights are all ones on the uniform path."""
  c, n, k = cfg.slots_per_stream, cfg.n_step, cfg.stack_size
  b = uniforms.shape[0]
  n_active = ft.fanout_total(state.indicator_tree)
  leaves = ft.fanout_query(state.indicator_tree,
                           uniforms.to(torch.float32) * n_active)
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
  return batch, leaves, torch.ones((b,), dtype=torch.float32, device=dev)


def replay_size(state: ReplayState) -> torch.Tensor:
  """Number of sampleable transitions (active rows), int32."""
  return ft.fanout_total(state.indicator_tree).to(torch.int32)
