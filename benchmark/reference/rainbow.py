"""Rainbow (Hessel et al. 2018, arXiv:1710.02298) in plain PyTorch.

The Nature DQN torso; a dueling head of factorised-Gaussian noisy layers
(Fortunato et al. 2018: y = (μ_w + σ_w ⊙ ε_in ε_outᵀ) x + μ_b + σ_b ⊙ ε_out,
the output layers without μ_b), 512 hidden units a stream, 51 atoms on
[-v_max, v_max]; q_logits = value + advantage − mean over actions of the
advantage. The loss is the categorical (C51, Bellemare et al. 2017)
cross-entropy against the target net's distribution at the online net's
greedy next action, projected onto the support, over n-step returns; each
apply with its own noise; new priorities are the rows' losses clipped to
[0, 100].
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import common

HIDDEN = 512


def support(flags: dict, device) -> torch.Tensor:
  n = flags["num_atoms"]
  v = flags["vmax"]
  return torch.linspace(-v, v, n, dtype=torch.float64,
                        device=device).to(torch.float32)


def init_params(gen, device, num_actions: int, flags: dict) -> dict:
  atoms, e = flags["num_atoms"], common.EMBED
  layers = (("advantage", "hidden", e, HIDDEN, True),
            ("advantage", "out", HIDDEN, num_actions * atoms, False),
            ("value", "hidden", e, HIDDEN, True),
            ("value", "out", HIDDEN, atoms, False))
  specs = common.torso_specs()
  for _, _, fan_in, n, bias in layers:
    specs += [((fan_in, n), fan_in)] + ([((n,), fan_in)] if bias else [])
  p = iter(common.init_uniform(gen, device, specs))
  tree = {"torso": common.torso_tree([next(p) for _ in range(6)])}
  for stream, name, fan_in, n, bias in layers:
    mu = {"w": next(p)}
    if bias:
      mu["b"] = next(p)
    s0 = flags["noisy_weight_init"] / math.sqrt(fan_in)
    sigma = {"w": torch.full((fan_in, n), s0, device=device),
             "b": torch.full((n,), s0, device=device)}
    tree.setdefault(stream, {})[name] = {"mu": mu, "sigma": sigma}
  return tree


def _noisy(x, p, e_in, e_out, precision):
  w = p["mu"]["w"] + p["sigma"]["w"] * (e_in[:, None] * e_out[None, :])
  y = common.mm(x, w, precision) + p["sigma"]["b"] * e_out
  return y + p["mu"]["b"] if "b" in p["mu"] else y


def logits(params, frames, noise: dict, num_actions: int,
           precision: str) -> torch.Tensor:
  """(B, A, atoms) q_logits under one noise set."""
  e = common.torso(params["torso"], frames, precision)

  def stream(name):
    p = params[name]
    h = torch.relu(_noisy(e, p["hidden"], noise[f"{name}_hidden_in"],
                          noise[f"{name}_hidden_out"], precision))
    return _noisy(h, p["out"], noise[f"{name}_out_in"],
                  noise[f"{name}_out_out"], precision)

  b = frames.shape[0]
  adv = stream("advantage").reshape(b, num_actions, -1)
  value = stream("value").reshape(b, 1, -1)
  return value + adv - adv.mean(1, keepdim=True)


def _q(lg, z):
  return (torch.softmax(lg, -1) * z).sum(-1)


def act_q(params, frames, draws: dict, flags: dict, num_actions: int,
          precision: str) -> torch.Tensor:
  lg = logits(params, frames, draws["act_noise"], num_actions, precision)
  return _q(lg, support(flags, frames.device))


def project(target_z, probs, z) -> torch.Tensor:
  """C51's projection of the atoms target_z (B, n) with masses probs onto
  the fixed support z: each mass split between the two nearest atoms in
  proportion to its distance from them."""
  vmin, vmax = float(z[0]), float(z[-1])
  dz = (vmax - vmin) / (z.shape[0] - 1)
  bj = (torch.clamp(target_z, vmin, vmax) - vmin) / dz
  lo, hi = torch.floor(bj), torch.ceil(bj)
  out = torch.zeros_like(probs)
  out.scatter_add_(1, lo.long(), probs * (hi - bj + (lo == hi)))
  out.scatter_add_(1, hi.long(), probs * (bj - lo))
  return out


def loss(online, target, batch, weights, draws: dict, flags: dict,
         num_actions: int, precision: str, half_batch: bool = False):
  """(mean loss, per-row losses, new priorities, the smallest margin of the
  next action's choice: common.top2_margin)."""
  z = support(flags, batch.s_tm1.device)
  n_tm1, n_sel, n_t = draws["loss_noise"]
  lg = logits(online, batch.s_tm1, n_tm1, num_actions, precision)
  with torch.no_grad():
    q_sel = _q(logits(online, batch.s_t, n_sel, num_actions, precision), z)
    a_t = q_sel.argmax(-1)
    margin = common.top2_margin(q_sel)
    p_t = torch.softmax(logits(target, batch.s_t, n_t, num_actions,
                               precision), -1)
    p_t = p_t[torch.arange(p_t.shape[0], device=p_t.device), a_t]
    target_z = batch.r_t[:, None] + batch.discount_t[:, None] * z[None, :]
    m = project(target_z, p_t, z)
  lg_a = lg[torch.arange(lg.shape[0], device=lg.device), batch.a_tm1]
  rows = -(m * torch.log_softmax(lg_a, -1)).sum(-1)
  if half_batch:
    keep = rows.shape[0] // 2
    mean = torch.mean(rows[:keep] * weights[:keep])
  else:
    mean = torch.mean(rows * weights)
  return (mean, rows.detach(), torch.clamp(torch.abs(rows.detach()), 0, 100),
          margin)
