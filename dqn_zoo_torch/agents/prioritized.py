"""Prioritized-replay double DQN (port of dqn_zoo_tpu/agents/prioritized.py):
double_q's loss weighted by the replay's importance-sampling weights, new
priorities |td error|; priority exponent 0.6, uniform mixture 1e-3, IS
exponent 0.4 → 1.0 over training, lr / 4 and eps × (1/4)²."""

from dqn_zoo_torch import nets
from dqn_zoo_torch.agents.base import AgentSpec, register_agent
from dqn_zoo_torch.agents.dqn import epsilon_greedy_act, q_learning_loss

SPEC = register_agent(AgentSpec(
    name="prioritized",
    make_network=lambda spec, n: nets.double_dqn_atari_network(
        n, compute_dtype=spec.compute_dtype),
    loss=q_learning_loss(double_q=True),
    act=epsilon_greedy_act,
    exploration_epsilon_end=0.01,
    eval_exploration_epsilon=0.01,
    target_network_update_period=int(1.2e5),
    learning_rate=0.00025 / 4,
    optimizer_epsilon=(0.01 / 32**2) * (1.0 / 4) ** 2,
    priority_exponent=0.6,
    uniform_sample_probability=1e-3,
    importance_sampling_begin=0.4,
    importance_sampling_end=1.0,
))
