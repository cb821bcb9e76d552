"""Layers as plain functions over dicts of tensors (port of nets/core.py).

Parameters keep the JAX package's layout so that a checkpoint's pytree maps
across leaf for leaf (convert.py): conv weights HWIO (kh, kw, in, out),
dense weights (in, out). Activations are NHWC at every public boundary.

A noisy layer's noise is an argument, drawn by the caller (`noise_draw`,
from a `torch.Generator`) or handed in from values a test computed with JAX.

`compute_dtype` (float32 or bfloat16, `torch_dtype`) is the operand type of
the products, as in the JAX package; parameters, activations and gradients
stay f32. Under bfloat16 each layer's arithmetic is the JAX package's bf16
layer as XLA compiles it on the CPU, on both devices:
  dense and noisy products: both operands rounded to bf16 (to nearest
    even), f32 accumulation, f32 output; the casts are explicit under
    autograd, so the gradients reaching x and w are rounded to bf16 as the
    casts' transposes round them (torch.autocast would round the outputs);
  conv: the operands rounded to bf16, f32 accumulation and an f32 output
    (the JAX source asks for a bf16 output, and XLA's CPU compiler drops
    that rounding); backward: the cotangent rounded to bf16, f32 gradients
    (`bf16_operand`, `bf16_cotangent`).
The products are plain f32 library calls of the rounded operands (cuBLAS
and cuDNN on the card, TF32 off): the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Union

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
DTypeLike = Union[str, torch.dtype, None]

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(compute_dtype: DTypeLike) -> torch.dtype:
  """torch.float32 or torch.bfloat16 from a name ("float32", "bfloat16"),
  a torch dtype or None (float32); ValueError on anything else."""
  if compute_dtype is None:
    return torch.float32
  if isinstance(compute_dtype, str):
    if compute_dtype not in COMPUTE_DTYPES:
      raise ValueError(f"compute_dtype must be one of {list(COMPUTE_DTYPES)};"
                       f" got {compute_dtype!r}.")
    return COMPUTE_DTYPES[compute_dtype]
  if compute_dtype not in COMPUTE_DTYPES.values():
    raise ValueError("compute_dtype must be torch.float32 or torch.bfloat16; "
                     f"got {compute_dtype}.")
  return compute_dtype


def round_to(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
  """t rounded to `dtype` (to nearest even, as XLA's convert rounds) and
  back to f32; t itself for float32. Differentiable: the gradient is
  rounded the same way."""
  return t if dtype == torch.float32 else t.to(dtype).to(torch.float32)


class _Bf16Operand(torch.autograd.Function):
  """x rounded to bf16 (as f32); the gradient passes unrounded."""

  @staticmethod
  def forward(ctx, x):
    return x.to(torch.bfloat16).to(torch.float32)

  @staticmethod
  def backward(ctx, g):
    return g


class _Bf16Cotangent(torch.autograd.Function):
  """x unchanged; the gradient rounded to bf16 (as f32)."""

  @staticmethod
  def forward(ctx, x):
    return x.view_as(x)

  @staticmethod
  def backward(ctx, g):
    return g.to(torch.bfloat16).to(torch.float32)


bf16_operand = _Bf16Operand.apply
bf16_cotangent = _Bf16Cotangent.apply


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
           stride: int, compute_dtype=torch.float32) -> torch.Tensor:
  """VALID conv, NHWC in and out, HWIO weights (turned OIHW for F.conv2d).
  bfloat16: the module docstring's conv, then the f32 bias."""
  xn, wn = x.permute(0, 3, 1, 2), hwio_to_oihw(w)
  if compute_dtype == torch.float32:
    y = F.conv2d(xn, wn, b, stride=stride)
  else:
    y = bf16_cotangent(F.conv2d(bf16_operand(xn), bf16_operand(wn),
                                stride=stride)) + b[:, None, None]
  return y.permute(0, 2, 3, 1)


def dot(x: torch.Tensor, w: torch.Tensor,
        compute_dtype=torch.float32) -> torch.Tensor:
  """x @ w with both operands rounded to `compute_dtype`, f32 output."""
  return round_to(x, compute_dtype) @ round_to(w, compute_dtype)


def linear(x: torch.Tensor, p: Params,
           compute_dtype=torch.float32) -> torch.Tensor:
  """x @ w + b; a (1,) bias broadcasts over the outputs."""
  return dot(x, p["w"], compute_dtype) + p["b"]


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
                 eps_out: torch.Tensor,
                 compute_dtype=torch.float32) -> torch.Tensor:
  """x (B, fan_in) → (B, n) in the JAX package's order: μ = x @ μ.w (+ μ.b),
  σ = (ε_in · x) @ σ.w + σ.b, then μ + σ · ε_out. ε_in (fan_in,) and ε_out
  (n,) are one draw broadcast over the batch. μ and σ stay two products:
  folding them into one weight would round the sums differently."""
  mu = dot(x, p["mu"]["w"], compute_dtype)
  if "b" in p["mu"]:
    mu = mu + p["mu"]["b"]
  sigma = dot(eps_in * x, p["sigma"]["w"], compute_dtype) + p["sigma"]["b"]
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
