"""Layers as plain functions over dicts of tensors (port of nets/core.py).

Parameters keep the JAX package's layout so that a checkpoint's pytree maps
across leaf for leaf (convert.py): conv weights HWIO (kh, kw, in, out),
dense weights (in, out). Activations are NHWC at every public boundary.
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
