from dqn_zoo_torch.nets.atari import (C51NetworkOutputs, DqnAtariNetwork,
                                      IqnAtariNetwork, IqnInputs, IqnOutputs,
                                      QNetworkOutputs, RainbowAtariNetwork,
                                      RainbowNoise, dqn_atari_network,
                                      dqn_torso, double_dqn_atari_network,
                                      dqn_value_head, iqn_atari_network,
                                      rainbow_atari_network)
