"""What the reference's network families share, in plain PyTorch.

Nothing here imports the program. Every product runs in float32 with TF32
off (`precision="f32"`); `precision="tf32"` rounds every operand of every
product, forward and backward, to TF32 first (10 mantissa bits, to nearest,
ties away), which is the arithmetic of the card's TF32 tensor cores: the
control that the comparison has to fail.

Parameter trees are nested dicts with the layout the agents' published
networks use: conv weights HWIO, dense weights (in, out).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

PRECISIONS = ("f32", "tf32")


def strict_f32() -> None:
  """Full f32 products on the card: the reference never runs on TF32 by
  accident (the control rounds its operands itself)."""
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
  """f32 rounded to TF32 (13 low mantissa bits cleared, to nearest with
  ties away from zero), as f32."""
  i = x.contiguous().view(torch.int32)
  return ((i + 0x1000) & -0x2000).view(torch.float32)


class _Tf32Mm(torch.autograd.Function):
  @staticmethod
  def forward(ctx, a, b):
    a, b = round_tf32(a), round_tf32(b)
    ctx.save_for_backward(a, b)
    return a @ b

  @staticmethod
  def backward(ctx, g):
    a, b = ctx.saved_tensors
    g = round_tf32(g)
    return g @ b.transpose(-1, -2), a.transpose(-1, -2) @ g


class _Tf32Conv(torch.autograd.Function):
  @staticmethod
  def forward(ctx, x, w, stride):
    x, w = round_tf32(x), round_tf32(w)
    ctx.save_for_backward(x, w)
    ctx.stride = stride
    return F.conv2d(x, w, stride=stride)

  @staticmethod
  def backward(ctx, g):
    x, w = ctx.saved_tensors
    g = round_tf32(g)
    gx = torch.nn.grad.conv2d_input(x.shape, w, g, stride=ctx.stride)
    gw = torch.nn.grad.conv2d_weight(x, w.shape, g, stride=ctx.stride)
    return gx, gw, None


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
  return a @ b if precision == "f32" else _Tf32Mm.apply(a, b)


def conv(x_nchw, w_hwio, b, stride: int, precision: str) -> torch.Tensor:
  """VALID convolution of NCHW input by HWIO weights, NCHW output."""
  w = w_hwio.permute(3, 2, 0, 1)
  if precision == "f32":
    y = F.conv2d(x_nchw, w, stride=stride)
  else:
    y = _Tf32Conv.apply(x_nchw, w, stride)
  return y + b[None, :, None, None]


def dense(x, p, precision: str) -> torch.Tensor:
  return mm(x, p["w"], precision) + p["b"]


# --- the Nature DQN torso (Mnih et al. 2015) ---------------------------------

TORSO = (("conv1", 8, 4, 4, 32), ("conv2", 4, 2, 32, 64),
         ("conv3", 3, 1, 64, 64))
EMBED = 7 * 7 * 64


def torso(params, frames_u8: torch.Tensor, precision: str) -> torch.Tensor:
  """uint8 (B, 84, 84, 4) stacks → (B, 3136): pixels / 255, three ReLU
  convolutions, flattened in (y, x, channel) order."""
  h = frames_u8.permute(0, 3, 1, 2).to(torch.float32) / 255.0
  for name, _, stride, _, _ in TORSO:
    h = torch.relu(conv(h, params[name]["w"], params[name]["b"], stride,
                        precision))
  return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


def uniform_leaf(u: torch.Tensor, fan_in: int) -> torch.Tensor:
  """U[-1/√fan_in, 1/√fan_in) from U[0, 1): the DQN papers' initializer."""
  return (u * 2.0 - 1.0) * (1.0 / math.sqrt(fan_in))


def init_uniform(gen: torch.Generator, device,
                 specs: Sequence[tuple]) -> List[torch.Tensor]:
  """One U[0, 1) draw for all leaves, cut into (shape, fan_in) leaves."""
  sizes = [int(np.prod(shape)) for shape, _ in specs]
  u = torch.rand((sum(sizes),), generator=gen, device=device)
  return [uniform_leaf(part, fan).reshape(shape)
          for part, (shape, fan) in zip(torch.split(u, sizes), specs)]


def torso_specs() -> List[tuple]:
  out = []
  for _, k, _, cin, cout in TORSO:
    out += [((k, k, cin, cout), k * k * cin), ((cout,), k * k * cin)]
  return out


def torso_tree(leaves: List[torch.Tensor]) -> dict:
  return {name: {"w": leaves[2 * i], "b": leaves[2 * i + 1]}
          for i, (name, *_) in enumerate(TORSO)}


# --- frames: max-pool, luma, antialiased bilinear resize to 84 x 84 ---------

def _resize_matrix(src: int, dst: int) -> np.ndarray:
  """(dst, src) weights of an antialiased linear (triangle) downscale: a
  triangle of half-width src/dst source pixels around each output pixel's
  centre, each row normalised to sum 1."""
  scale = src / dst
  centres = (np.arange(dst) + 0.5) * scale - 0.5
  dist = np.abs(np.arange(src)[None, :] - centres[:, None]) / scale
  w = np.clip(1.0 - dist, 0.0, None).astype(np.float32)
  # Normalised in f32, row by row, as jax.image.resize's f32 weights are.
  return np.stack([row / row.sum() for row in w])


def frames_to_84(f_penult: torch.Tensor, f_last: torch.Tensor,
                 precision: str = "f32") -> torch.Tensor:
  """(B, 210, 160, 3) uint8 twice → (B, 84, 84) uint8: the pixelwise max of
  the two frames, luma 0.299 R + 0.587 G + 0.114 B truncated to a byte,
  the resize rounded half to even."""
  x = torch.maximum(f_penult, f_last).to(torch.float32)
  w = (0.299, 0.587, 1.0 - (0.299 + 0.587))
  y = x[..., 0] * w[0] + x[..., 1] * w[1] + x[..., 2] * w[2]
  y = torch.clamp(y, max=255.0).to(torch.uint8).to(torch.float32)
  dev = x.device
  ry = torch.from_numpy(_resize_matrix(y.shape[-2], 84)).to(dev)
  cx = torch.from_numpy(_resize_matrix(y.shape[-1], 84)).to(dev)
  out = mm(mm(ry, y, precision), cx.t().contiguous(), precision)
  return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


# --- optimizer: Adam (Kingma and Ba 2015) as optax has it ---------------------

class Adam:
  """mu ← b1 mu + (1 − b1) g, nu ← b2 nu + (1 − b2) g², then
  p ← p − lr (mu / (1 − b1ᵗ)) / (√(nu / (1 − b2ᵗ)) + eps); before it, where
  `max_norm` > 0, the gradients scaled by max_norm / ‖g‖ when their global
  norm ‖g‖ exceeds max_norm."""

  def __init__(self, lr: float, eps: float, max_norm: float = 0.0,
               b1: float = 0.9, b2: float = 0.999):
    self.lr, self.eps, self.max_norm, self.b1, self.b2 = lr, eps, max_norm, \
        b1, b2
    self.t = 0
    self.mu: Optional[List[torch.Tensor]] = None
    self.nu: Optional[List[torch.Tensor]] = None

  def clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
    if self.max_norm <= 0:
      return grads
    norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads))
    if float(norm) <= self.max_norm:
      return grads
    return [g * (self.max_norm / float(norm)) for g in grads]

  @torch.no_grad()
  def step(self, params: List[torch.Tensor], grads: List[torch.Tensor]):
    """Updates `params` in place; returns the gradients as the moments
    took them (clipped)."""
    grads = self.clip(grads)
    if self.mu is None:
      self.mu = [torch.zeros_like(p) for p in params]
      self.nu = [torch.zeros_like(p) for p in params]
    self.t += 1
    # 1 − bᵗ in f32, as optax (dqn_zoo's optimizer library) takes it.
    t = np.float32(self.t)
    c1 = float(np.float32(1) - np.float32(self.b1) ** t)
    c2 = float(np.float32(1) - np.float32(self.b2) ** t)
    for p, g, mu, nu in zip(params, grads, self.mu, self.nu):
      mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
      nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
      p.sub_(self.lr * (mu / c1) / (torch.sqrt(nu / c2) + self.eps))
    return grads


def flat(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
  """{'a/b/c': leaf} of a nested dict, keys sorted at every level."""
  if not isinstance(tree, dict):
    return {prefix: tree}
  out = {}
  for k in sorted(tree):
    out.update(flat(tree[k], f"{prefix}/{k}" if prefix else k))
  return out


def linear_schedule(t: float, begin_value: float, end_value: float,
                    begin_t: float, end_t: float) -> float:
  frac = min(max((t - begin_t) / (end_t - begin_t), 0.0), 1.0)
  return (1.0 - frac) * begin_value + frac * end_value


def huber(x: torch.Tensor, kappa: float) -> torch.Tensor:
  a = torch.abs(x)
  return torch.where(a <= kappa, 0.5 * x * x, kappa * (a - 0.5 * kappa))


def top2_margin(q: torch.Tensor) -> float:
  """The smallest gap between a row's best and second-best value over the
  rows, as a share of the values' mean absolute size: how near the
  reference's choice of next action came to a tie that another summation
  order could break the other way."""
  top = torch.topk(q, 2, dim=-1).values
  return float(((top[:, 0] - top[:, 1]).min()) / q.abs().mean().clamp(
      min=1e-30))
