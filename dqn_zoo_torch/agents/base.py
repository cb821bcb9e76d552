"""Agent specification (port of dqn_zoo_tpu/agents/base.py).

`AgentSpec` keeps the reference's fields and defaults, in environment-frame
units. Its `loss` and `act` are plain functions over tensors; randomness is
passed in (see ops/policy.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Tuple

import torch


class LossOutput(NamedTuple):
  loss: torch.Tensor  # scalar
  priorities: torch.Tensor  # (B,) raw new priorities


# loss(spec, network, online_params, target_params, batch, weights)
LossFn = Callable[..., LossOutput]
# act(spec, network, params, obs_u8, epsilon, explore_u, random_action
#     [, taus (B, tau_samples_policy) when spec.act_takes_taus])
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
  are plain numbers and a step reads nothing back from the device.
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
    t = int(state.count)
    c1 = 1.0 - self.b1 ** t
    c2 = 1.0 - self.b2 ** t
    for p, g, mu, nu in zip(leaves, grads, state.mu, state.nu):
      mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
      nu.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
      update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
      p.add_(update * (-self.learning_rate))


def make_optimizer(spec: AgentSpec):
  if spec.max_global_grad_norm > 0:
    raise NotImplementedError(
        "max_global_grad_norm > 0 is not ported yet (slice B).")
  if spec.optimizer == "rmsprop":
    return CenteredRMSProp(spec.learning_rate, spec.rmsprop_decay,
                           spec.optimizer_epsilon)
  if spec.optimizer == "adam":
    return Adam(spec.learning_rate, spec.optimizer_epsilon)
  raise ValueError(spec.optimizer)


_REGISTRY = {}


def register_agent(spec: AgentSpec) -> AgentSpec:
  _REGISTRY[spec.name] = spec
  return spec


def get_agent(name: str) -> AgentSpec:
  from dqn_zoo_torch.agents import dqn, iqn  # noqa: F401
  if name not in _REGISTRY:
    raise KeyError(f"Agent {name!r} is not ported yet; have "
                   f"{sorted(_REGISTRY)}.")
  return _REGISTRY[name]


def all_agent_names():
  from dqn_zoo_torch.agents import dqn, iqn  # noqa: F401
  return sorted(_REGISTRY)
