"""The DQN and IQN Atari networks (port of dqn_zoo_tpu/nets/atari.py:58-131
and :256-316).

Parameters are a dict of tensors shaped like the JAX pytree:
  {"torso": {"conv1"|"conv2"|"conv3": {"w": HWIO, "b"}},
   "head": {"hidden": {"w": (3136, 512), "b"}, "out": {"w": (512, A), "b"}}}
and, for IQN, also "tau_embed": {"w": (latent, 3136), "b"}.
The torso flattens in (y, x, c) order as JAX flattens NHWC, so
`head.hidden.w` carries across from JAX without a row permutation.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from dqn_zoo_torch.nets import core, iqn_head, torso_cuda


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


class IqnInputs(NamedTuple):
  state: torch.Tensor  # (B, 84, 84, 4) uint8
  taus: torch.Tensor  # (B, S) in [0, 1)


class IqnOutputs(NamedTuple):
  q_values: torch.Tensor  # (B, A): mean over τ, detached
  q_dist: torch.Tensor  # (B, S, A)


class IqnAtariNetwork:
  """Implicit quantile net: `init(generator, device)` and
  `apply(params, IqnInputs)`.

  τ embedding: cos(π·i·τ), i = 1..latent_dim → linear(3136) → ReLU; head
  input = τ embedding · state embedding (broadcast over the τ samples); the
  shared value head is applied per τ sample; q = mean over samples. The
  cosine features are plain PyTorch; everything from there to q_dist is
  kernel K4a on CUDA and its plain version on the CPU (nets/iqn_head.py).
  """

  def __init__(self, num_actions: int, latent_dim: int):
    self.num_actions = num_actions
    self.latent_dim = latent_dim

  def init(self, gen: torch.Generator, device):
    return {
        "torso": {
            "conv1": core.conv2d_init(gen, 8, 8, 4, 32, device),
            "conv2": core.conv2d_init(gen, 4, 4, 32, 64, device),
            "conv3": core.conv2d_init(gen, 3, 3, 64, 64, device),
        },
        "tau_embed": core.linear_init(gen, self.latent_dim, 3136, device),
        "head": {
            "hidden": core.linear_init(gen, 3136, 512, device),
            "out": core.linear_init(gen, 512, self.num_actions, device),
        },
    }

  def cos_embedding(self, taus: torch.Tensor) -> torch.Tensor:
    """(B, S) → (B, S, latent_dim): cos(π·i·τ), i = 1..latent_dim."""
    pi_mult = torch.arange(1, self.latent_dim + 1, dtype=torch.float32,
                           device=taus.device) * math.pi
    return torch.cos(pi_mult[None, None, :] * taus[:, :, None])

  def apply(self, params, inputs: IqnInputs) -> IqnOutputs:
    state_embedding = dqn_torso(params["torso"], inputs.state)
    hd = params["head"]
    q_dist = iqn_head.iqn_head(
        params["tau_embed"]["w"], params["tau_embed"]["b"],
        hd["hidden"]["w"], hd["hidden"]["b"], hd["out"]["w"], hd["out"]["b"],
        self.cos_embedding(inputs.taus), state_embedding)
    return IqnOutputs(q_values=torch.mean(q_dist, dim=1).detach(),
                      q_dist=q_dist)


def iqn_atari_network(num_actions: int, latent_dim: int) -> IqnAtariNetwork:
  return IqnAtariNetwork(num_actions, latent_dim)
