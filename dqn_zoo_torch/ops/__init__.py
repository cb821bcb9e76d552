from dqn_zoo_torch.ops.policy import epsilon_greedy_sample, greedy_sample
from dqn_zoo_torch.ops.value_learning import (
    batch_categorical_double_q_learning, batch_categorical_q_learning,
    batch_double_q_learning, batch_q_learning, batch_quantile_q_learning,
    categorical_l2_project,
    clip_gradient, double_q_learning, huber_loss, l2_loss, q_learning,
    quantile_q_learning, quantile_regression_loss)
