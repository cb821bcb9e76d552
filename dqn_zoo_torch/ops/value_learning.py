"""Value-learning losses (port of dqn_zoo_tpu/ops/value_learning.py:26-145
and the batch forms of :148-155)."""

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


def huber_loss(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
  abs_x = torch.abs(x)
  quadratic = torch.clamp(abs_x, max=delta)
  linear = abs_x - quadratic
  return 0.5 * quadratic**2 + delta * linear


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


def categorical_l2_project(z_p, probs, z_q):
  """Projects the distributions (z_p, probs) onto the support z_q (the
  C51 Cramér/L2 projection). z_p and probs (..., n), z_q (m,) sorted →
  (..., m); the intermediate is (..., m, n). z_p is clipped to [z_q[0],
  z_q[-1]] and the JAX package's d_pos/d_neg form is kept, so atoms beyond
  the support and terminal rows (all of z_p at one point) land as there."""
  gaps = z_q[1:] - z_q[:-1]
  one = torch.ones((1,), dtype=z_q.dtype, device=z_q.device)
  d_pos = torch.cat([gaps, one])[:, None]
  d_neg = torch.cat([one, gaps])[:, None]
  z_p = torch.clamp(z_p, z_q[0], z_q[-1])[..., None, :]  # (..., 1, n)
  delta_qp = z_p - z_q[:, None]  # (..., m, n)
  d_sign = (delta_qp >= 0.0).to(probs.dtype)
  delta_hat = (d_sign * delta_qp / d_pos
               - (1.0 - d_sign) * delta_qp / d_neg)
  return torch.sum(torch.clamp(1.0 - delta_hat, 0.0, 1.0)
                   * probs[..., None, :], dim=-1)


def _pick(x, a):
  """x (B, A, n), a (B,) → x[b, a[b]] (B, n)."""
  return torch.gather(x, 1, a.long()[:, None, None].expand(
      -1, 1, x.shape[2]))[:, 0]


def _categorical_loss(q_atoms_tm1, q_logits_tm1, a_tm1, r_t, discount_t,
                      q_atoms_t, q_t_probs, a_t):
  """Per row: the cross-entropy of the online logits at a_tm1 to the
  projected target distribution at a_t (detached)."""
  target_z = r_t[:, None] + discount_t[:, None] * q_atoms_t[None, :]
  target = categorical_l2_project(target_z, _pick(q_t_probs, a_t),
                                  q_atoms_tm1)
  log_p = torch.log_softmax(_pick(q_logits_tm1, a_tm1), dim=-1)
  return -torch.sum(target.detach() * log_p, dim=-1)


def batch_categorical_q_learning(q_atoms_tm1, q_logits_tm1, a_tm1, r_t,
                                 discount_t, q_atoms_t, q_logits_t):
  """The C51 loss over a leading batch axis (the reference's vmap with shared
  supports): the greedy a_t is the argmax of the target distribution's own
  mean. q_logits_* (B, A, atoms), a_tm1, r_t, discount_t (B,) → (B,)."""
  q_t_probs = torch.softmax(q_logits_t, dim=-1)
  q_t = torch.sum(q_t_probs * q_atoms_t[None, None, :], dim=-1)
  a_t = torch.argmax(q_t, dim=-1)
  return _categorical_loss(q_atoms_tm1, q_logits_tm1, a_tm1, r_t, discount_t,
                           q_atoms_t, q_t_probs, a_t)


def batch_categorical_double_q_learning(q_atoms_tm1, q_logits_tm1, a_tm1, r_t,
                                        discount_t, q_atoms_t, q_logits_t,
                                        q_t_selector):
  """C51 loss with double-Q action selection, over a leading batch axis
  (the reference's vmap with shared supports): q_logits_* (B, A, atoms),
  q_t_selector (B, A), a_tm1, r_t, discount_t (B,) → (B,)."""
  a_t = torch.argmax(q_t_selector, dim=-1)
  q_t_probs = torch.softmax(q_logits_t, dim=-1)
  return _categorical_loss(q_atoms_tm1, q_logits_tm1, a_tm1, r_t, discount_t,
                           q_atoms_t, q_t_probs, a_t)


def quantile_regression_loss(dist_src, tau_src, dist_target,
                             huber_param: float = 0.0):
  """Quantile-regression (Huber) loss between quantile estimates.

  dist_src (..., n) with quantile midpoints tau_src (..., n); dist_target
  (..., m), detached. Returns, per leading index, the sum over source
  quantiles of the mean over target samples."""
  dist_target = dist_target.detach()
  delta = dist_target[..., None, :] - dist_src[..., :, None]  # (..., n, m)
  indicator = (delta < 0.0).to(delta.dtype)
  weight = torch.abs(tau_src[..., :, None] - indicator)
  if huber_param == 0.0:
    delta_loss = torch.abs(delta)
  else:
    delta_loss = huber_loss(delta, huber_param) / huber_param
  return torch.sum(torch.mean(weight * delta_loss, dim=-1), dim=-1)


def quantile_q_learning(dist_q_tm1, tau_q_tm1, a_tm1, r_t, discount_t,
                        dist_q_t_selector, dist_q_t,
                        huber_param: float = 0.0):
  """One-sample quantile-distribution Q-learning (QR-DQN / IQN).

  dist_* have shape (num_quantiles, num_actions); the selector
  distribution's mean over τ picks the greedy next action, evaluated on
  `dist_q_t`."""
  dist_qa_tm1 = dist_q_tm1[:, a_tm1]
  a_t = torch.argmax(torch.mean(dist_q_t_selector, dim=0))
  target = r_t + discount_t * dist_q_t[:, a_t]
  return quantile_regression_loss(dist_qa_tm1, tau_q_tm1, target, huber_param)


def batch_quantile_q_learning(dist_q_tm1, tau_q_tm1, a_tm1, r_t, discount_t,
                              dist_q_t_selector, dist_q_t,
                              huber_param: float = 0.0):
  """quantile_q_learning over a leading batch axis (the reference's vmap):
  dist_* (B, quantiles, A), tau_q_tm1 (B, n), a_tm1, r_t, discount_t (B,)."""
  pick = lambda dist, a: torch.gather(
      dist, 2, a.long()[:, None, None].expand(-1, dist.shape[1], 1))[:, :, 0]
  a_t = torch.argmax(torch.mean(dist_q_t_selector, dim=1), dim=-1)
  target = r_t[:, None] + discount_t[:, None] * pick(dist_q_t, a_t)
  return quantile_regression_loss(pick(dist_q_tm1, a_tm1), tau_q_tm1, target,
                                  huber_param)
