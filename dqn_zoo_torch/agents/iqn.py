"""IQN, implicit quantile networks (port of dqn_zoo_tpu/agents/iqn.py):
64 τ samples per act, latent dim 64, uniform replay, Adam lr 5e-5, min fill
2 %, eval ε 0.001.

Ported so far: the network, the actor and the spec, which is everything a
run does before its first learn step, and evaluation. The loss is not: it
needs the head's backward kernels K4b and K4c and the quantile regression
loss, so `iqn_loss` raises.
"""

from __future__ import annotations

import torch

from dqn_zoo_torch import nets, ops
from dqn_zoo_torch.agents.base import AgentSpec, register_agent


def iqn_loss(spec, network, online_params, target_params, batch, weights):
  raise NotImplementedError(
      "the IQN learn step is not ported yet: it needs the fused head's "
      "backward kernels K4b (dwh, dbh) and K4c (dwe, dbe, ds_emb, dcos), "
      "the quantile regression loss and the three τ draws of iqn_loss. "
      "--agent=iqn acts, fills its replay and evaluates until then.")


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
        n, spec.tau_latent_dim),
    loss=iqn_loss,
    act=iqn_act,
    act_takes_taus=True,
    exploration_epsilon_end=0.01,
    eval_exploration_epsilon=0.001,
    min_replay_capacity_fraction=0.02,
    optimizer="adam",
    learning_rate=0.00005,
    optimizer_epsilon=0.01 / 32,
))
