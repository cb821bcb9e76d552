"""The DQN, double-DQN, C51, QR-DQN, IQN and rainbow Atari networks (port
of dqn_zoo_tpu/nets/atari.py:58-202, :205-253 and :256-316).

Parameters are a dict of tensors shaped like the JAX pytree:
  {"torso": {"conv1"|"conv2"|"conv3": {"w": HWIO, "b"}},
   "head": {"hidden": {"w": (3136, 512), "b"}, "out": {"w": (512, A), "b"}}}
and, for IQN, also "tau_embed": {"w": (latent, 3136), "b"}. The double-DQN
network's "out" has a (1,) bias shared by all actions; the C51 network's
"out" has A·atoms outputs, the QR-DQN network's quantiles·A. The rainbow
network has "torso", "advantage" and "value", each stream {"hidden",
"out"} of noisy layers ({"mu": {"w"[, "b"]}, "sigma": {"w", "b"}},
nets/core.py).
The torso flattens in (y, x, c) order as JAX flattens NHWC, so
`head.hidden.w` carries across from JAX without a row permutation.

Every factory takes `compute_dtype` (float32 or bfloat16, nets/core.py), as
the JAX package's do. The torso is chosen from it once, when the network is
built: kernel K3 for float32 (its plain version on the CPU), the cast
convolutions of `core.conv2d` for bfloat16 (cuDNN on the card), as the
reference's fused torso computes in f32 only and its bf16 torso is XLA's
convolutions. The IQN head stays f32 under bfloat16, as the reference's
does; its own `head_matmul_dtype` puts the fused head's products on bf16
operands (K4a, K4b and K4c in their bf16 mode).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, NamedTuple

import torch

from dqn_zoo_torch.nets import core, iqn_head, torso_cuda


class QNetworkOutputs(NamedTuple):
  q_values: torch.Tensor


class C51NetworkOutputs(NamedTuple):
  q_values: torch.Tensor  # (B, A): expected return under the support, detached
  q_logits: torch.Tensor  # (B, A, atoms)


class QRNetworkOutputs(NamedTuple):
  q_values: torch.Tensor  # (B, A): mean over the quantiles, detached
  q_dist: torch.Tensor  # (B, quantiles, A)


class _PerDevice:
  """A 1-D host tensor (a support, the quantile midpoints) and its copies,
  each made on its device once: `self(device)`."""

  def __init__(self, values: torch.Tensor):
    if values.dim() != 1:
      raise ValueError(f"expected a 1-D tensor; got {tuple(values.shape)}.")
    self._values = values
    self._on: Dict[torch.device, torch.Tensor] = {}

  def __len__(self) -> int:
    return self._values.shape[0]

  def __call__(self, device) -> torch.Tensor:
    device = torch.device(device)
    if device not in self._on:
      self._on[device] = self._values.to(device)
    return self._on[device]


def dqn_torso(params, x: torch.Tensor) -> torch.Tensor:
  """uint8 (B, 84, 84, 4) → [0, 1] → conv 32×8×8/4 → 64×4×4/2 → 64×3×3/1,
  ReLU each, flatten to 3136. Kernel K3 on CUDA, its plain version on CPU."""
  return torso_cuda.dqn_torso(
      params["conv1"]["w"], params["conv1"]["b"],
      params["conv2"]["w"], params["conv2"]["b"],
      params["conv3"]["w"], params["conv3"]["b"], x)


def dqn_torso_cast(params, x: torch.Tensor,
                   compute_dtype=torch.bfloat16) -> torch.Tensor:
  """The same torso through `core.conv2d` at `compute_dtype`, on either
  device: the reference's XLA torso."""
  h = x.to(torch.float32) * (1.0 / 255.0)
  for name, stride in (("conv1", 4), ("conv2", 2), ("conv3", 1)):
    h = core.relu(core.conv2d(h, params[name]["w"], params[name]["b"],
                              stride, compute_dtype))
  return core.flatten(h)


def torso_for(compute_dtype) -> Callable[..., torch.Tensor]:
  """The torso a network of `compute_dtype` runs: K3 (`dqn_torso`) for
  float32, `dqn_torso_cast` for bfloat16."""
  dtype = core.torch_dtype(compute_dtype)
  if dtype == torch.float32:
    return dqn_torso
  return functools.partial(dqn_torso_cast, compute_dtype=dtype)


def dqn_value_head(params, h: torch.Tensor,
                   compute_dtype=torch.float32) -> torch.Tensor:
  """linear 512 → ReLU → linear num_outputs."""
  hidden = core.linear(h, params["hidden"], compute_dtype)
  return core.linear(core.relu(hidden), params["out"], compute_dtype)


class DqnAtariNetwork:
  """Classic DQN net: `init(generator, device)` and `apply(params, x)`.
  With `shared_bias` the last layer has one bias for all actions."""

  def __init__(self, num_actions: int, shared_bias: bool = False,
               compute_dtype=torch.float32):
    self.num_actions = num_actions
    self.shared_bias = shared_bias
    self.compute_dtype = core.torch_dtype(compute_dtype)
    self.torso = torso_for(self.compute_dtype)

  def init(self, gen: torch.Generator, device):
    return {
        "torso": {
            "conv1": core.conv2d_init(gen, 8, 8, 4, 32, device),
            "conv2": core.conv2d_init(gen, 4, 4, 32, 64, device),
            "conv3": core.conv2d_init(gen, 3, 3, 64, 64, device),
        },
        "head": {
            "hidden": core.linear_init(gen, 3136, 512, device),
            "out": (core.linear_shared_bias_init if self.shared_bias
                    else core.linear_init)(gen, 512, self.num_actions,
                                           device),
        },
    }

  def apply(self, params, x: torch.Tensor) -> QNetworkOutputs:
    return QNetworkOutputs(q_values=dqn_value_head(
        params["head"], self.torso(params["torso"], x), self.compute_dtype))


def dqn_atari_network(num_actions: int,
                      compute_dtype=torch.float32) -> DqnAtariNetwork:
  return DqnAtariNetwork(num_actions, compute_dtype=compute_dtype)


def double_dqn_atari_network(num_actions: int,
                             compute_dtype=torch.float32) -> DqnAtariNetwork:
  """The DQN net with a shared-bias last layer (JAX nets/atari.py:133)."""
  return DqnAtariNetwork(num_actions, shared_bias=True,
                         compute_dtype=compute_dtype)


class C51AtariNetwork:
  """C51 categorical net: the DQN torso and value head with A·atoms
  outputs, reshaped (B, A, atoms); q_values = Σ softmax · support,
  detached."""

  def __init__(self, num_actions: int, support: torch.Tensor,
               compute_dtype=torch.float32):
    self.num_actions = num_actions
    self.support = _PerDevice(support)
    self.num_atoms = len(self.support)
    self._body = DqnAtariNetwork(num_actions * self.num_atoms,
                                 compute_dtype=compute_dtype)

  def init(self, gen: torch.Generator, device):
    return self._body.init(gen, device)

  def apply(self, params, x: torch.Tensor) -> C51NetworkOutputs:
    q_logits = self._body.apply(params, x).q_values.reshape(
        -1, self.num_actions, self.num_atoms)
    q_dist = torch.softmax(q_logits.detach(), dim=-1)
    q_values = torch.sum(q_dist * self.support(x.device)[None, None, :],
                         dim=2)
    return C51NetworkOutputs(q_values=q_values, q_logits=q_logits)


def c51_atari_network(num_actions: int, support: torch.Tensor,
                      compute_dtype=torch.float32) -> C51AtariNetwork:
  return C51AtariNetwork(num_actions, support, compute_dtype)


class QRAtariNetwork:
  """QR-DQN quantile net: the DQN torso and value head with quantiles·A
  outputs, reshaped quantiles first, (B, quantiles, A), as the JAX net
  lays them out; q_values = the mean over the quantiles, detached."""

  def __init__(self, num_actions: int, quantiles: torch.Tensor,
               compute_dtype=torch.float32):
    self.num_actions = num_actions
    self.quantiles = _PerDevice(quantiles)
    self.num_quantiles = len(self.quantiles)
    self._body = DqnAtariNetwork(self.num_quantiles * num_actions,
                                 compute_dtype=compute_dtype)

  def init(self, gen: torch.Generator, device):
    return self._body.init(gen, device)

  def apply(self, params, x: torch.Tensor) -> QRNetworkOutputs:
    q_dist = self._body.apply(params, x).q_values.reshape(
        -1, self.num_quantiles, self.num_actions)
    return QRNetworkOutputs(q_values=torch.mean(q_dist.detach(), dim=1),
                            q_dist=q_dist)


def qr_atari_network(num_actions: int, quantiles: torch.Tensor,
                     compute_dtype=torch.float32) -> QRAtariNetwork:
  return QRAtariNetwork(num_actions, quantiles, compute_dtype)


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
  `compute_dtype` sets the torso's; the head is f32 unless
  `head_matmul_dtype` is torch.bfloat16, which rounds the head's product
  operands to bf16 (the reference's `head_matmul_dtype`).
  """

  def __init__(self, num_actions: int, latent_dim: int,
               compute_dtype=torch.float32, head_matmul_dtype=None):
    self.num_actions = num_actions
    self.latent_dim = latent_dim
    self.compute_dtype = core.torch_dtype(compute_dtype)
    self.torso = torso_for(self.compute_dtype)
    self.head_matmul_dtype = iqn_head.matmul_dtype(head_matmul_dtype)

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
    state_embedding = self.torso(params["torso"], inputs.state)
    hd = params["head"]
    q_dist = iqn_head.iqn_head(
        params["tau_embed"]["w"], params["tau_embed"]["b"],
        hd["hidden"]["w"], hd["hidden"]["b"], hd["out"]["w"], hd["out"]["b"],
        self.cos_embedding(inputs.taus), state_embedding,
        mm=self.head_matmul_dtype)
    return IqnOutputs(q_values=torch.mean(q_dist, dim=1).detach(),
                      q_dist=q_dist)


def iqn_atari_network(num_actions: int, latent_dim: int,
                      compute_dtype=torch.float32,
                      head_matmul_dtype=None) -> IqnAtariNetwork:
  return IqnAtariNetwork(num_actions, latent_dim, compute_dtype,
                         head_matmul_dtype)


class RainbowNoise(NamedTuple):
  """The noise of one rainbow apply: for each of the four noisy layers its
  input-side vector (fan_in,) and output-side vector (outputs,), each
  sign(e)·√|e| of a truncated normal (core.noise_draw), broadcast over the
  batch. A leading axis, where the engine adds one, indexes draws."""
  advantage_hidden_in: torch.Tensor  # (3136,)
  advantage_hidden_out: torch.Tensor  # (512,)
  advantage_out_in: torch.Tensor  # (512,)
  advantage_out_out: torch.Tensor  # (A * atoms,)
  value_hidden_in: torch.Tensor  # (3136,)
  value_hidden_out: torch.Tensor  # (512,)
  value_out_in: torch.Tensor  # (512,)
  value_out_out: torch.Tensor  # (atoms,)


class RainbowAtariNetwork:
  """Dueling noisy C51 net: `init(generator, device)`,
  `apply(params, x, noise)` and `draw_noise(generator, device)`.

  advantage stream: noisy 512 → ReLU → noisy A·atoms, no bias;
  value stream: noisy 512 → ReLU → noisy atoms, no bias;
  q_logits = value + advantage − mean_a(advantage), a softmax over atoms,
  q_values = Σ softmax · support. The torso is `torso_for(compute_dtype)`
  (K3 for f32); the noisy layers are plain products at `compute_dtype`.
  """

  def __init__(self, num_actions: int, support: torch.Tensor,
               noisy_weight_init: float, compute_dtype=torch.float32):
    self.num_actions = num_actions
    self.support = _PerDevice(support)
    self.num_atoms = len(self.support)
    self.noisy_weight_init = noisy_weight_init
    self.compute_dtype = core.torch_dtype(compute_dtype)
    self.torso = torso_for(self.compute_dtype)

  def init(self, gen: torch.Generator, device):
    nl = lambda fan_in, n, bias: core.noisy_linear_init(
        gen, fan_in, n, self.noisy_weight_init, bias, device)
    a, n = self.num_actions, self.num_atoms
    return {
        "torso": {
            "conv1": core.conv2d_init(gen, 8, 8, 4, 32, device),
            "conv2": core.conv2d_init(gen, 4, 4, 32, 64, device),
            "conv3": core.conv2d_init(gen, 3, 3, 64, 64, device),
        },
        "advantage": {"hidden": nl(3136, 512, True),
                      "out": nl(512, a * n, False)},
        "value": {"hidden": nl(3136, 512, True), "out": nl(512, n, False)},
    }

  def noise_sizes(self):
    """The lengths of RainbowNoise's fields, in field order."""
    a, n = self.num_actions, self.num_atoms
    return [3136, 512, 512, a * n, 3136, 512, 512, n]

  def draw_noise(self, gen: torch.Generator, device,
                 lead=()) -> RainbowNoise:
    """One noise set (or a `lead`-shaped array of them) in one draw."""
    sizes = self.noise_sizes()
    e = core.noise_draw(gen, tuple(lead) + (sum(sizes),), device)
    return RainbowNoise(*torch.split(e, sizes, dim=-1))

  def _stream(self, p, h, eps_hidden_in, eps_hidden_out, eps_out_in,
              eps_out_out):
    h = core.relu(core.noisy_linear(h, p["hidden"], eps_hidden_in,
                                    eps_hidden_out, self.compute_dtype))
    return core.noisy_linear(h, p["out"], eps_out_in, eps_out_out,
                             self.compute_dtype)

  def apply(self, params, x: torch.Tensor,
            noise: RainbowNoise) -> C51NetworkOutputs:
    embed = self.torso(params["torso"], x)
    advantage = self._stream(params["advantage"], embed, *noise[:4])
    advantage = advantage.reshape(-1, self.num_actions, self.num_atoms)
    value = self._stream(params["value"], embed, *noise[4:])
    value = value.reshape(-1, 1, self.num_atoms)
    q_logits = value + advantage - torch.mean(advantage, dim=-2,
                                              keepdim=True)
    q_dist = torch.softmax(q_logits.detach(), dim=-1)
    q_values = torch.sum(q_dist * self.support(x.device)[None, None, :], dim=2)
    return C51NetworkOutputs(q_values=q_values, q_logits=q_logits)


def rainbow_atari_network(num_actions: int, support: torch.Tensor,
                          noisy_weight_init: float,
                          compute_dtype=torch.float32) -> RainbowAtariNetwork:
  return RainbowAtariNetwork(num_actions, support, noisy_weight_init,
                             compute_dtype)
