"""QR-DQN (port of dqn_zoo_tpu/agents/qrdqn.py): the quantile Q-learning
loss on the QR net at the fixed midpoints (i + 0.5)/201, Huber κ =
`huber_param`, the target's own distribution both picking and scoring the
next action, priorities |loss|; an ε-greedy actor (ε end 0.01, eval ε
0.001); Adam lr 5e-5 and eps 0.01/32 after a global-norm clip at 10."""

from __future__ import annotations

import torch

from dqn_zoo_torch import nets, ops
from dqn_zoo_torch.agents.base import AgentSpec, LossOutput, register_agent
from dqn_zoo_torch.agents.dqn import epsilon_greedy_act


def quantiles(spec) -> torch.Tensor:
  """The fixed midpoints (i + 0.5)/n in f32, on the host."""
  n = spec.num_quantiles
  return (torch.arange(n, dtype=torch.float32) + 0.5) / n


def qrdqn_loss(spec, network, online_params, target_params, batch, weights):
  """The online net on s_tm1 (under grad) and the target net on s_t, whose
  distribution both selects and evaluates the next action."""
  dist_q_tm1 = network.apply(online_params, batch.s_tm1).q_dist
  with torch.no_grad():
    dist_q_target_t = network.apply(target_params, batch.s_t).q_dist
  taus = network.quantiles(dist_q_tm1.device).expand(
      dist_q_tm1.shape[0], -1)
  losses = ops.batch_quantile_q_learning(
      dist_q_tm1, taus, batch.a_tm1, batch.r_t, batch.discount_t,
      dist_q_target_t, dist_q_target_t, spec.huber_param)
  return LossOutput(loss=torch.mean(losses * weights),
                    priorities=torch.abs(losses.detach()))


SPEC = register_agent(AgentSpec(
    name="qrdqn",
    make_network=lambda spec, n: nets.qr_atari_network(
        n, quantiles(spec), compute_dtype=spec.compute_dtype),
    loss=qrdqn_loss,
    act=epsilon_greedy_act,
    exploration_epsilon_end=0.01,
    eval_exploration_epsilon=0.001,
    optimizer="adam",
    learning_rate=0.00005,
    optimizer_epsilon=0.01 / 32,
    max_global_grad_norm=10.0,
))
