"""IQN (Dabney et al. 2018, arXiv:1806.06923) in plain PyTorch.

The Nature DQN torso; τ embedding ReLU(Σᵢ cos(π i τ) wᵢ + b) over i = 1..64,
multiplied into the torso's 3136 features; a 512-unit ReLU layer; one value
per action for each τ. The loss is the quantile Huber loss (κ = 1) of the
online net's quantiles at the taken action against r + γ Z(s_t, a*), with
a* the argmax of the target net's mean over the policy's τ samples (dqn_zoo
selects with the target net), summed over the online τ and averaged over
the target τ; new priorities are the rows' absolute losses.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import common

HIDDEN = 512


def init_params(gen, device, num_actions: int, flags: dict) -> dict:
  latent = flags["tau_latent_dim"]
  e = common.EMBED
  specs = common.torso_specs() + [
      ((latent, e), latent), ((e,), latent), ((e, HIDDEN), e), ((HIDDEN,), e),
      ((HIDDEN, num_actions), HIDDEN), ((num_actions,), HIDDEN)]
  p = common.init_uniform(gen, device, specs)
  return {"torso": common.torso_tree(p[:6]),
          "tau_embed": {"w": p[6], "b": p[7]},
          "head": {"hidden": {"w": p[8], "b": p[9]},
                   "out": {"w": p[10], "b": p[11]}}}


def quantiles(params, frames, taus, precision: str) -> torch.Tensor:
  """(B, S, A) values of the S τ samples of each stack."""
  b, s = taus.shape
  latent = params["tau_embed"]["w"].shape[0]
  i = torch.arange(1, latent + 1, dtype=torch.float32, device=taus.device)
  cos = torch.cos(math.pi * i[None, None, :] * taus[:, :, None])
  state = common.torso(params["torso"], frames, precision)
  te = torch.relu(common.dense(cos.reshape(b * s, latent),
                               params["tau_embed"], precision))
  x = (te.reshape(b, s, -1) * state[:, None, :]).reshape(b * s, -1)
  h = torch.relu(common.dense(x, params["head"]["hidden"], precision))
  return common.dense(h, params["head"]["out"], precision).reshape(b, s, -1)


def act_q(params, frames, draws: dict, flags: dict, num_actions: int,
          precision: str) -> torch.Tensor:
  del flags, num_actions
  return quantiles(params, frames, draws["act_taus"], precision).mean(1)


def loss(online, target, batch, weights, draws: dict, flags: dict,
         num_actions: int, precision: str, half_batch: bool = False):
  """(mean loss, per-row losses, new priorities, the smallest margin of the
  next action's choice: common.top2_margin)."""
  del num_actions
  tau_tm1, tau_sel, tau_t = draws["loss_taus"]
  dist = quantiles(online, batch.s_tm1, tau_tm1, precision)
  src = dist.gather(2, batch.a_tm1[:, None, None].expand(
      -1, dist.shape[1], 1))[:, :, 0]
  with torch.no_grad():
    both = quantiles(target, batch.s_t, torch.cat([tau_sel, tau_t], 1),
                     precision)
    sel, z_t = both[:, :tau_sel.shape[1]], both[:, tau_sel.shape[1]:]
    a_t = sel.mean(1).argmax(-1)
    margin = common.top2_margin(sel.mean(1))
    z = z_t.gather(2, a_t[:, None, None].expand(-1, z_t.shape[1], 1))[:, :, 0]
    target_z = batch.r_t[:, None] + batch.discount_t[:, None] * z
  delta = target_z[:, None, :] - src[:, :, None]
  kappa = flags["huber_param"]
  weight = torch.abs(tau_tm1[:, :, None] - (delta < 0).to(delta.dtype))
  rows = (weight * common.huber(delta, kappa) / kappa).mean(-1).sum(-1)
  if half_batch:
    keep = rows.shape[0] // 2
    mean = torch.mean(rows[:keep] * weights[:keep])
  else:
    mean = torch.mean(rows * weights)
  return mean, rows.detach(), torch.abs(rows.detach()), margin
