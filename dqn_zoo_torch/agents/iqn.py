"""IQN, implicit quantile networks (port of dqn_zoo_tpu/agents/iqn.py):
quantile Q-learning on sampled-τ distributions with the target net as
selector and Huber κ = 1; 64 τ samples each for policy, s_tm1 and s_t, latent
dim 64, uniform replay, Adam lr 5e-5, min fill 2 %, eval ε 0.001.

The reference draws its τ samples from a key inside `iqn_loss` and
`iqn_act`; here they are arguments, drawn by the engine.
"""

from __future__ import annotations

import torch

from dqn_zoo_torch import nets, ops
from dqn_zoo_torch.agents.base import AgentSpec, LossOutput, register_agent


def iqn_loss(spec, network, online_params, target_params, batch, weights,
             tau_tm1, tau_sel, tau_t):
  """tau_tm1 (B, tau_samples_s_tm1), tau_sel (B, tau_samples_policy) and
  tau_t (B, tau_samples_s_t), each U[0, 1)."""
  dist_q_tm1 = network.apply(
      online_params, nets.IqnInputs(batch.s_tm1, tau_tm1)).q_dist
  # One target apply on s_t with the selector and target τ concatenated: the
  # per-τ head is independent per sample, so this is the reference agent's
  # two applies with the s_t conv torso run once.
  with torch.no_grad():
    dist_both = network.apply(
        target_params,
        nets.IqnInputs(batch.s_t, torch.cat([tau_sel, tau_t], dim=1))).q_dist
  dist_q_sel = dist_both[:, :spec.tau_samples_policy]
  dist_q_target = dist_both[:, spec.tau_samples_policy:]
  losses = ops.batch_quantile_q_learning(
      dist_q_tm1, tau_tm1, batch.a_tm1, batch.r_t, batch.discount_t,
      dist_q_sel, dist_q_target, spec.huber_param)
  return LossOutput(loss=torch.mean(losses * weights),
                    priorities=torch.abs(losses.detach()))


@torch.no_grad()
def iqn_act(spec, network, params, obs, epsilon, explore_u, random_action,
            taus):
  del spec
  q = network.apply(params, nets.IqnInputs(obs, taus)).q_values
  actions = ops.epsilon_greedy_sample(q, epsilon, explore_u, random_action)
  return actions, torch.max(q, dim=-1).values


SPEC = register_agent(AgentSpec(
    name="iqn",
    make_network=lambda spec, n: nets.iqn_atari_network(
        n, spec.tau_latent_dim, compute_dtype=spec.compute_dtype),
    loss=iqn_loss,
    act=iqn_act,
    act_takes_taus=True,
    loss_takes_taus=True,
    exploration_epsilon_end=0.01,
    eval_exploration_epsilon=0.001,
    min_replay_capacity_fraction=0.02,
    optimizer="adam",
    learning_rate=0.00005,
    optimizer_epsilon=0.01 / 32,
))
