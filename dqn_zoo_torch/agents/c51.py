"""C51 (port of dqn_zoo_tpu/agents/c51.py): the categorical Q-learning loss
on the C51 net over the shared support linspace(−10, 10, 51), no TD clip,
priorities |loss|; an ε-greedy actor (ε end 0.01, eval ε 0.001); Adam lr
2.5e-4 and eps 0.01/32 after a global-norm clip at 10. `support` is shared
by the rainbow agent."""

from __future__ import annotations

import torch

from dqn_zoo_torch import nets, ops
from dqn_zoo_torch.agents.base import AgentSpec, LossOutput, register_agent
from dqn_zoo_torch.agents.dqn import epsilon_greedy_act


def support(spec, device="cpu") -> torch.Tensor:
  """linspace(−vmax, vmax, num_atoms) in f32, each atom the f32 nearest to
  −vmax + 2·vmax·i/(num_atoms − 1). jnp.linspace's compiled f32 product can
  land an ulp or so of vmax away from that."""
  return torch.linspace(-spec.vmax, spec.vmax, spec.num_atoms,
                        dtype=torch.float64, device=device).float()


def c51_loss(spec, network, online_params, target_params, batch, weights):
  """The online net on s_tm1 (under grad) and the target net on s_t, whose
  own distribution picks the greedy next action."""
  del spec
  sup = network.support(batch.s_tm1.device)
  logits_q_tm1 = network.apply(online_params, batch.s_tm1).q_logits
  with torch.no_grad():
    logits_target_t = network.apply(target_params, batch.s_t).q_logits
  losses = ops.batch_categorical_q_learning(
      sup, logits_q_tm1, batch.a_tm1, batch.r_t, batch.discount_t, sup,
      logits_target_t)
  return LossOutput(loss=torch.mean(losses * weights),
                    priorities=torch.abs(losses.detach()))


SPEC = register_agent(AgentSpec(
    name="c51",
    make_network=lambda spec, n: nets.c51_atari_network(
        n, support(spec), compute_dtype=spec.compute_dtype),
    loss=c51_loss,
    act=epsilon_greedy_act,
    exploration_epsilon_end=0.01,
    eval_exploration_epsilon=0.001,
    optimizer="adam",
    learning_rate=0.00025,
    optimizer_epsilon=0.01 / 32,
    max_global_grad_norm=10.0,
))
