from dqn_zoo_torch.agents.base import (AgentSpec, CenteredRMSProp,
                                       LossOutput, all_agent_names,
                                       get_agent, make_optimizer)
