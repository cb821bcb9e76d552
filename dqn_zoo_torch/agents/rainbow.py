"""Rainbow (port of dqn_zoo_tpu/agents/rainbow.py): the categorical double-Q
loss on the noisy dueling C51 net, weighted by the replay's importance
weights, with new priorities clip(|loss|, 0, 100); a greedy actor whose
exploration is the noisy nets'; n-step 3 under prioritized replay (priority
exponent 0.5, uniform mixture 1e-3, IS exponent 0.4 → 1.0), Adam lr
2.5e-4/4 and eps 0.005/32 after a global-norm clip at 10, min fill 2 %,
target period 3.2e4 frames, ε 0 in training and in eval.

The reference draws each apply's noise from a key inside `rainbow_loss` and
`greedy_noisy_act`; here the noise sets are arguments, drawn by the engine
(`RainbowAtariNetwork.draw_noise`).
"""

from __future__ import annotations

import torch

from dqn_zoo_torch import nets, ops
from dqn_zoo_torch.agents.base import AgentSpec, LossOutput, register_agent
from dqn_zoo_torch.agents.c51 import support


def rainbow_loss(spec, network, online_params, target_params, batch, weights,
                 noise_tm1, noise_sel, noise_t):
  """Three applies, each with its own noise set: the online net on s_tm1
  (under grad), the online net on s_t (the double-Q selector) and the
  target net on s_t."""
  sup = network.support(batch.s_tm1.device)
  logits_q_tm1 = network.apply(online_params, batch.s_tm1,
                               noise_tm1).q_logits
  with torch.no_grad():
    q_t = network.apply(online_params, batch.s_t, noise_sel).q_values
    logits_target_t = network.apply(target_params, batch.s_t,
                                    noise_t).q_logits
  losses = ops.batch_categorical_double_q_learning(
      sup, logits_q_tm1, batch.a_tm1, batch.r_t, batch.discount_t, sup,
      logits_target_t, q_t)
  return LossOutput(loss=torch.mean(losses * weights),
                    priorities=torch.clamp(torch.abs(losses.detach()), 0.0,
                                           100.0))


@torch.no_grad()
def greedy_noisy_act(spec, network, params, obs, epsilon, explore_u,
                     random_action, noise):
  """Greedy with respect to one noisy-net sample; ε is still honoured, so
  the same actor serves eval (where rainbow's ε is 0)."""
  del spec
  q = network.apply(params, obs, noise).q_values
  actions = ops.epsilon_greedy_sample(q, epsilon, explore_u, random_action)
  return actions, torch.max(q, dim=-1).values


SPEC = register_agent(AgentSpec(
    name="rainbow",
    make_network=lambda spec, n: nets.rainbow_atari_network(
        n, support(spec), spec.noisy_weight_init,
        compute_dtype=spec.compute_dtype),
    loss=rainbow_loss,
    act=greedy_noisy_act,
    act_takes_noise=True,
    loss_takes_noise=True,
    greedy_actor=True,
    exploration_epsilon_begin=0.0,
    exploration_epsilon_end=0.0,
    eval_exploration_epsilon=0.0,
    n_step=3,
    min_replay_capacity_fraction=0.02,
    priority_exponent=0.5,
    uniform_sample_probability=1e-3,
    importance_sampling_begin=0.4,
    importance_sampling_end=1.0,
    optimizer="adam",
    learning_rate=0.00025 / 4,
    optimizer_epsilon=0.005 / 32,
    max_global_grad_norm=10.0,
    target_network_update_period=int(3.2e4),
))
