"""Agent specification (port of dqn_zoo_tpu/agents/base.py).

`AgentSpec` keeps the reference's fields and defaults, in environment-frame
units. Its `loss` and `act` are plain functions over tensors; randomness is
passed in (see ops/policy.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Tuple

import numpy as np
import torch


class LossOutput(NamedTuple):
  loss: torch.Tensor  # scalar
  priorities: torch.Tensor  # (B,) raw new priorities


# loss(spec, network, online_params, target_params, batch, weights
#      [, tau_tm1, tau_sel, tau_t when spec.loss_takes_taus]
#      [, noise_tm1, noise_sel, noise_t when spec.loss_takes_noise])
LossFn = Callable[..., LossOutput]
# act(spec, network, params, obs_u8, epsilon, explore_u, random_action
#     [, taus (B, tau_samples_policy) when spec.act_takes_taus]
#     [, noise when spec.act_takes_noise])
#   -> (actions (B,), values (B,))
ActFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class AgentSpec:
  name: str
  make_network: Callable[..., Any]  # (spec, num_actions) -> network
  loss: LossFn
  act: ActFn
  # The engine draws τ samples, U[0, 1) of shape (B, tau_samples_policy),
  # for every act and hands them to `act` as its last argument (IQN).
  act_takes_taus: bool = False
  # The engine draws three τ sets for every update, U[0, 1) of shapes
  # (batch, tau_samples_s_tm1), (batch, tau_samples_policy) and
  # (batch, tau_samples_s_t), and hands them to `loss` as its last three
  # arguments (IQN).
  loss_takes_taus: bool = False
  # The engine draws one noise set of the network's noisy layers
  # (`network.draw_noise`) for every act and hands it to `act` as its last
  # argument (rainbow).
  act_takes_noise: bool = False
  # The engine draws three noise sets for every update (the online net on
  # s_tm1, the online selector on s_t, the target net on s_t) and hands them
  # to `loss` as its last three arguments (rainbow).
  loss_takes_noise: bool = False

  # Replay (priority_exponent 0 → uniform replay).
  n_step: int = 1
  min_replay_capacity_fraction: float = 0.05
  priority_exponent: float = 0.0
  uniform_sample_probability: float = 0.0
  importance_sampling_begin: float = 0.0
  importance_sampling_end: float = 0.0
  normalize_weights: bool = True

  # Optimizer.
  optimizer: str = "rmsprop"  # "rmsprop" (centered) or "adam"
  learning_rate: float = 0.00025
  optimizer_epsilon: float = 0.01 / 32**2
  rmsprop_decay: float = 0.95
  max_global_grad_norm: float = 0.0  # 0 → no clipping

  # Exploration / periods (environment frames).
  exploration_epsilon_begin: float = 1.0
  exploration_epsilon_end: float = 0.1
  exploration_epsilon_decay_frame_fraction: float = 0.02
  eval_exploration_epsilon: float = 0.05
  greedy_actor: bool = False
  # The nets' product operands: "float32" or "bfloat16" (nets/core.py);
  # parameters, gradients and the optimizer stay f32.
  compute_dtype: str = "float32"
  target_network_update_period: int = int(4e4)
  learn_period: int = 16
  batch_size: int = 32

  # Loss / network hyperparameters.
  grad_error_bound: float = 1.0 / 32
  vmax: float = 10.0
  num_atoms: int = 51
  num_quantiles: int = 201
  huber_param: float = 1.0
  tau_latent_dim: int = 64
  tau_samples_policy: int = 64
  tau_samples_s_tm1: int = 64
  tau_samples_s_t: int = 64
  noisy_weight_init: float = 0.1


class RMSPropState(NamedTuple):
  mu: List[torch.Tensor]  # first moments, one per parameter leaf
  nu: List[torch.Tensor]  # second moments


class CenteredRMSProp:
  """optax.rmsprop(centered=True) with eps inside the root.

    mu ← (1−ρ)·g + ρ·mu,   nu ← (1−ρ)·g² + ρ·nu
    p  ← p − lr · g · rsqrt(nu − mu² + eps)
  from zero moments. torch.optim.RMSprop(centered=True) adds eps outside
  the root, which moves the denominator's floor from about 3.1e-3 to about
  9.8e-6 at DQN's eps, so it is not used.
  """

  def __init__(self, learning_rate: float, decay: float, eps: float):
    self.learning_rate = learning_rate
    self.decay = decay
    self.eps = eps

  def init(self, leaves: List[torch.Tensor]) -> RMSPropState:
    return RMSPropState(mu=[torch.zeros_like(p) for p in leaves],
                        nu=[torch.zeros_like(p) for p in leaves])

  @torch.no_grad()
  def step(self, leaves: List[torch.Tensor], grads: List[torch.Tensor],
           state: RMSPropState) -> None:
    """Updates the parameter leaves and the state in place."""
    d = self.decay
    for p, g, mu, nu in zip(leaves, grads, state.mu, state.nu):
      mu.copy_((1 - d) * g + d * mu)
      nu.copy_((1 - d) * (g * g) + d * nu)
      update = torch.rsqrt(nu - mu * mu + self.eps) * g
      p.add_(update * (-self.learning_rate))


class AdamState(NamedTuple):
  count: torch.Tensor  # () int64 on the CPU: steps taken
  mu: List[torch.Tensor]  # first moments, one per parameter leaf
  nu: List[torch.Tensor]  # second moments


class Adam:
  """optax.adam(lr, b1=0.9, b2=0.999, eps): eps outside the root, bias
  correction by the step count.

    mu ← b1·mu + (1−b1)·g,   nu ← b2·nu + (1−b2)·g²,   t ← t + 1
    p  ← p − lr · (mu / (1−b1ᵗ)) / (sqrt(nu / (1−b2ᵗ)) + eps)
  from zero moments. The count lives on the host, so the bias corrections
  are plain numbers (f32, as optax's) and a step reads nothing back from
  the device.
  """

  def __init__(self, learning_rate: float, eps: float, b1: float = 0.9,
               b2: float = 0.999):
    self.learning_rate = learning_rate
    self.eps = eps
    self.b1 = b1
    self.b2 = b2

  def init(self, leaves: List[torch.Tensor]) -> AdamState:
    return AdamState(count=torch.zeros((), dtype=torch.int64),
                     mu=[torch.zeros_like(p) for p in leaves],
                     nu=[torch.zeros_like(p) for p in leaves])

  @torch.no_grad()
  def step(self, leaves: List[torch.Tensor], grads: List[torch.Tensor],
           state: AdamState) -> None:
    """Updates the parameter leaves and the state in place."""
    state.count.add_(1)
    t = np.float32(int(state.count))
    # 1 − bᵗ in f32, as optax takes it: in f64, 1 − 0.999 is 1.3e-5 off
    # optax's first-step correction, which moves a step by ~6e-6 of lr.
    c1 = float(np.float32(1) - np.float32(self.b1) ** t)
    c2 = float(np.float32(1) - np.float32(self.b2) ** t)
    for p, g, mu, nu in zip(leaves, grads, state.mu, state.nu):
      mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
      nu.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
      update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
      p.add_(update * (-self.learning_rate))


class ClipByGlobalNorm:
  """optax.chain(optax.clip_by_global_norm(max_norm), inner): the gradients
  as they are if their global norm √Σg² is below max_norm, else (g / norm)
  · max_norm (optax 0.2.6's form; torch.nn.utils.clip_grad_norm_ scales by
  max / (norm + 1e-6) instead). The choice is a select on the device: no
  host read. The clip keeps no state, so `init` and the state are the inner
  optimizer's."""

  def __init__(self, inner, max_norm: float):
    self.inner = inner
    self.max_norm = max_norm

  def init(self, leaves: List[torch.Tensor]):
    return self.inner.init(leaves)

  @torch.no_grad()
  def step(self, leaves: List[torch.Tensor], grads: List[torch.Tensor],
           state) -> None:
    # Sums of squares, as optax takes them: torch's f32 norm kernels on the
    # CPU lose ~1e-5 relative over a 3136 x 512 leaf.
    norm = torch.sqrt(torch.stack([torch.sum(g * g) for g in grads]).sum())
    keep = norm < self.max_norm
    self.inner.step(leaves, [torch.where(keep, g, (g / norm) * self.max_norm)
                             for g in grads], state)


def make_optimizer(spec: AgentSpec):
  if spec.optimizer == "rmsprop":
    opt = CenteredRMSProp(spec.learning_rate, spec.rmsprop_decay,
                          spec.optimizer_epsilon)
  elif spec.optimizer == "adam":
    opt = Adam(spec.learning_rate, spec.optimizer_epsilon)
  else:
    raise ValueError(spec.optimizer)
  if spec.max_global_grad_norm > 0:
    opt = ClipByGlobalNorm(opt, spec.max_global_grad_norm)
  return opt


_REGISTRY = {}


def register_agent(spec: AgentSpec) -> AgentSpec:
  _REGISTRY[spec.name] = spec
  return spec


def get_agent(name: str) -> AgentSpec:
  from dqn_zoo_torch.agents import (c51, double_q, dqn,  # noqa: F401
                                   iqn, prioritized, qrdqn, rainbow)
  if name not in _REGISTRY:
    raise KeyError(f"Agent {name!r} is not ported yet; have "
                   f"{sorted(_REGISTRY)}.")
  return _REGISTRY[name]


def all_agent_names():
  from dqn_zoo_torch.agents import (c51, double_q, dqn,  # noqa: F401
                                   iqn, prioritized, qrdqn, rainbow)
  return sorted(_REGISTRY)
