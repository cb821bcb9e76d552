from dqn_zoo_torch.nets.atari import (DqnAtariNetwork, IqnAtariNetwork,
                                      IqnInputs, IqnOutputs, QNetworkOutputs,
                                      dqn_atari_network, dqn_torso,
                                      dqn_value_head, iqn_atari_network)
