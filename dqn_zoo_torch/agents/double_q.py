"""Double DQN (port of dqn_zoo_tpu/agents/double_q.py): the double-Q TD error
clipped at ±1/32 under an L2 loss, on the DQN net with a shared-bias last
layer; ε end 0.01, eval ε 0.01, target period 1.2e5 frames."""

from dqn_zoo_torch import nets
from dqn_zoo_torch.agents.base import AgentSpec, register_agent
from dqn_zoo_torch.agents.dqn import epsilon_greedy_act, q_learning_loss

SPEC = register_agent(AgentSpec(
    name="double_q",
    make_network=lambda spec, n: nets.double_dqn_atari_network(
        n, compute_dtype=spec.compute_dtype),
    loss=q_learning_loss(double_q=True),
    act=epsilon_greedy_act,
    exploration_epsilon_end=0.01,
    eval_exploration_epsilon=0.01,
    target_network_update_period=int(1.2e5),
))
