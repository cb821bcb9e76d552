from dqn_zoo_torch.agents.base import (Adam, AdamState, AgentSpec,
                                       CenteredRMSProp, LossOutput,
                                       RMSPropState, all_agent_names,
                                       get_agent, make_optimizer)
