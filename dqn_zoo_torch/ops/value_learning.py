"""Value-learning losses (port of dqn_zoo_tpu/ops/value_learning.py:26-66)."""

from __future__ import annotations

import torch


class _ClipGradient(torch.autograd.Function):
  """Identity forward; clamps the cotangent to [lo, hi] backward."""

  @staticmethod
  def forward(ctx, x, lo, hi):
    ctx.lo, ctx.hi = lo, hi
    return x.view_as(x)

  @staticmethod
  def backward(ctx, g):
    return torch.clamp(g, ctx.lo, ctx.hi), None, None


def clip_gradient(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
  return _ClipGradient.apply(x, lo, hi)


def l2_loss(x: torch.Tensor) -> torch.Tensor:
  return 0.5 * torch.square(x)


def q_learning(q_tm1, a_tm1, r_t, discount_t, q_t):
  """One-sample Q-learning TD error: r + γ·max_a q_t − q_tm1[a_tm1]."""
  target = r_t + discount_t * torch.max(q_t)
  return target.detach() - q_tm1[a_tm1]


def double_q_learning(q_tm1, a_tm1, r_t, discount_t, q_t_value, q_t_selector):
  """Double Q TD error: the selector's argmax picks, the value net scores."""
  a_t = torch.argmax(q_t_selector)
  target = r_t + discount_t * q_t_value[a_t]
  return target.detach() - q_tm1[a_tm1]


def batch_q_learning(q_tm1, a_tm1, r_t, discount_t, q_t):
  """q_learning over a leading batch axis (the reference's vmap)."""
  target = r_t + discount_t * torch.max(q_t, dim=-1).values
  picked = torch.gather(q_tm1, 1, a_tm1.long()[:, None])[:, 0]
  return target.detach() - picked


def batch_double_q_learning(q_tm1, a_tm1, r_t, discount_t, q_t_value,
                            q_t_selector):
  a_t = torch.argmax(q_t_selector, dim=-1)
  target = r_t + discount_t * torch.gather(q_t_value, 1, a_t[:, None])[:, 0]
  picked = torch.gather(q_tm1, 1, a_tm1.long()[:, None])[:, 0]
  return target.detach() - picked
