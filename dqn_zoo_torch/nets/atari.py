"""The DQN Atari network (port of dqn_zoo_tpu/nets/atari.py:58-131).

Parameters are a dict of tensors shaped like the JAX pytree:
  {"torso": {"conv1"|"conv2"|"conv3": {"w": HWIO, "b"}},
   "head": {"hidden": {"w": (3136, 512), "b"}, "out": {"w": (512, A), "b"}}}
The torso flattens in (y, x, c) order as JAX flattens NHWC, so
`head.hidden.w` carries across from JAX without a row permutation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dqn_zoo_torch.nets import core, torso_cuda


class QNetworkOutputs(NamedTuple):
  q_values: torch.Tensor


def dqn_torso(params, x: torch.Tensor) -> torch.Tensor:
  """uint8 (B, 84, 84, 4) → [0, 1] → conv 32×8×8/4 → 64×4×4/2 → 64×3×3/1,
  ReLU each, flatten to 3136. Kernel K3 on CUDA, its plain version on CPU."""
  return torso_cuda.dqn_torso(
      params["conv1"]["w"], params["conv1"]["b"],
      params["conv2"]["w"], params["conv2"]["b"],
      params["conv3"]["w"], params["conv3"]["b"], x)


def dqn_value_head(params, h: torch.Tensor) -> torch.Tensor:
  """linear 512 → ReLU → linear num_outputs."""
  return core.linear(core.relu(core.linear(h, params["hidden"])),
                     params["out"])


class DqnAtariNetwork:
  """Classic DQN net: `init(generator, device)` and `apply(params, x)`."""

  def __init__(self, num_actions: int):
    self.num_actions = num_actions

  def init(self, gen: torch.Generator, device):
    return {
        "torso": {
            "conv1": core.conv2d_init(gen, 8, 8, 4, 32, device),
            "conv2": core.conv2d_init(gen, 4, 4, 32, 64, device),
            "conv3": core.conv2d_init(gen, 3, 3, 64, 64, device),
        },
        "head": {
            "hidden": core.linear_init(gen, 3136, 512, device),
            "out": core.linear_init(gen, 512, self.num_actions, device),
        },
    }

  def apply(self, params, x: torch.Tensor) -> QNetworkOutputs:
    return QNetworkOutputs(q_values=dqn_value_head(
        params["head"], dqn_torso(params["torso"], x)))


def dqn_atari_network(num_actions: int) -> DqnAtariNetwork:
  return DqnAtariNetwork(num_actions)
