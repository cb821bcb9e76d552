"""Layers as plain functions over dicts of tensors (port of nets/core.py).

Parameters keep the JAX package's layout so that a checkpoint's pytree maps
across leaf for leaf (convert.py): conv weights HWIO (kh, kw, in, out),
dense weights (in, out). Activations are NHWC at every public boundary.

A noisy layer's noise is an argument, drawn by the caller (`noise_draw`,
from a `torch.Generator`) or handed in from values a test computed with JAX.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def legacy_uniform_init(gen: torch.Generator, shape: Sequence[int],
                        fan_in: int, device) -> torch.Tensor:
  """Uniform ±1/√fan_in — DQN's historical init for weights and biases."""
  c = 1.0 / math.sqrt(fan_in)
  u = torch.rand(tuple(shape), generator=gen, device=device)
  return (u * 2.0 - 1.0) * c


def conv2d_init(gen, kh: int, kw: int, in_ch: int, out_ch: int,
                device) -> Params:
  fan_in = in_ch * kh * kw
  return {"w": legacy_uniform_init(gen, (kh, kw, in_ch, out_ch), fan_in,
                                   device),
          "b": legacy_uniform_init(gen, (out_ch,), fan_in, device)}


def linear_init(gen, fan_in: int, num_outputs: int, device) -> Params:
  return {"w": legacy_uniform_init(gen, (fan_in, num_outputs), fan_in,
                                   device),
          "b": legacy_uniform_init(gen, (num_outputs,), fan_in, device)}


def linear_shared_bias_init(gen, fan_in: int, num_outputs: int,
                            device) -> Params:
  """A dense layer with one (1,) bias broadcast over all outputs (the
  double-Q network's last layer, nets/core.py:156-181 of the JAX package);
  `linear` applies it."""
  return {"w": legacy_uniform_init(gen, (fan_in, num_outputs), fan_in,
                                   device),
          "b": legacy_uniform_init(gen, (1,), fan_in, device)}


def hwio_to_oihw(w: torch.Tensor) -> torch.Tensor:
  return w.permute(3, 2, 0, 1)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           stride: int) -> torch.Tensor:
  """VALID conv, NHWC in and out, HWIO weights (turned OIHW for F.conv2d)."""
  y = F.conv2d(x.permute(0, 3, 1, 2), hwio_to_oihw(w), b, stride=stride)
  return y.permute(0, 2, 3, 1)


def linear(x: torch.Tensor, p: Params) -> torch.Tensor:
  """x @ w + b; a (1,) bias broadcasts over the outputs."""
  return x @ p["w"] + p["b"]


def relu(x: torch.Tensor) -> torch.Tensor:
  return torch.relu(x)


def flatten(x: torch.Tensor) -> torch.Tensor:
  """All but the batch axis, in memory order (y, x, c for NHWC)."""
  return x.reshape(x.shape[0], -1)


def noisy_linear_init(gen, fan_in: int, num_outputs: int,
                      weight_init_stddev: float, with_bias: bool,
                      device) -> Params:
  """A factorised-Gaussian NoisyNet layer (nets/core.py:183-228 of the JAX
  package): {"mu": {"w"[, "b"]}, "sigma": {"w", "b"}}. μ takes the legacy
  uniform init; σ starts at weight_init_stddev / √fan_in. `mu.b` exists
  only with a bias, `sigma.b` always."""
  sigma0 = weight_init_stddev / math.sqrt(fan_in)
  mu = {"w": legacy_uniform_init(gen, (fan_in, num_outputs), fan_in, device)}
  if with_bias:
    mu["b"] = legacy_uniform_init(gen, (num_outputs,), fan_in, device)
  sigma = {"w": torch.full((fan_in, num_outputs), sigma0, device=device),
           "b": torch.full((num_outputs,), sigma0, device=device)}
  return {"mu": mu, "sigma": sigma}


def noisy_linear(x: torch.Tensor, p: Params, eps_in: torch.Tensor,
                 eps_out: torch.Tensor) -> torch.Tensor:
  """x (B, fan_in) → (B, n) in the JAX package's order: μ = x @ μ.w (+ μ.b),
  σ = (ε_in · x) @ σ.w + σ.b, then μ + σ · ε_out. ε_in (fan_in,) and ε_out
  (n,) are one draw broadcast over the batch. μ and σ stay two products:
  folding them into one weight would round the sums differently."""
  mu = x @ p["mu"]["w"]
  if "b" in p["mu"]:
    mu = mu + p["mu"]["b"]
  sigma = (eps_in * x) @ p["sigma"]["w"] + p["sigma"]["b"]
  return mu + sigma * eps_out


def noise_sqrt(e: torch.Tensor) -> torch.Tensor:
  """sign(e)·√|e|, the NoisyNet noise transform. The root is taken in f64
  and rounded once to f32, so it is correctly rounded, as XLA's f32 root
  is; torch's vectorised f32 root on the CPU is not (one ulp off in about
  one value of 140)."""
  return torch.sign(e) * torch.sqrt(torch.abs(e).double()).to(e.dtype)


def noise_draw(gen: torch.Generator, shape: Sequence[int],
               device) -> torch.Tensor:
  """`noise_sqrt` of a standard normal truncated to ±2 (not rescaled: the
  distribution of jax.random.truncated_normal(-2, 2))."""
  e = torch.empty(tuple(shape), device=device)
  torch.nn.init.trunc_normal_(e, 0.0, 1.0, -2.0, 2.0, generator=gen)
  return noise_sqrt(e)
