from dqn_zoo_torch.parallel.distributed import (DistributedTrainer,
                                                init_distributed)
