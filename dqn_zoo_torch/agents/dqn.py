"""DQN (port of dqn_zoo_tpu/agents/dqn.py): TD error clipped by gradient
clipping at ±1/32, L2 loss, ε-greedy actor."""

from __future__ import annotations

import torch

from dqn_zoo_torch import nets, ops
from dqn_zoo_torch.agents.base import AgentSpec, LossOutput, register_agent


def q_learning_loss(double_q: bool = False):

  def loss(spec, network, online_params, target_params, batch, weights):
    q_tm1 = network.apply(online_params, batch.s_tm1).q_values
    with torch.no_grad():
      q_target_t = network.apply(target_params, batch.s_t).q_values
    if double_q:
      with torch.no_grad():
        q_t = network.apply(online_params, batch.s_t).q_values
      td_errors = ops.batch_double_q_learning(
          q_tm1, batch.a_tm1, batch.r_t, batch.discount_t, q_target_t, q_t)
    else:
      td_errors = ops.batch_q_learning(
          q_tm1, batch.a_tm1, batch.r_t, batch.discount_t, q_target_t)
    clipped = ops.clip_gradient(td_errors, -spec.grad_error_bound,
                                spec.grad_error_bound)
    losses = ops.l2_loss(clipped)
    return LossOutput(loss=torch.mean(losses * weights),
                      priorities=torch.abs(td_errors.detach()))

  return loss


@torch.no_grad()
def epsilon_greedy_act(spec, network, params, obs, epsilon, explore_u,
                       random_action):
  del spec
  q = network.apply(params, obs).q_values
  actions = ops.epsilon_greedy_sample(q, epsilon, explore_u, random_action)
  return actions, torch.max(q, dim=-1).values


SPEC = register_agent(AgentSpec(
    name="dqn",
    make_network=lambda spec, n: nets.dqn_atari_network(
        n, compute_dtype=spec.compute_dtype),
    loss=q_learning_loss(double_q=False),
    act=epsilon_greedy_act,
))
