from dqn_zoo_torch.engine.superstep import (Engine, EngineConfig, EngineState,
                                            EvalState, Metrics, SuperstepDraws)
