from dqn_zoo_torch.nets.atari import (DqnAtariNetwork, QNetworkOutputs,
                                      dqn_atari_network, dqn_torso,
                                      dqn_value_head)
