"""Kernel K3: the DQN torso forward on the card, and its autograd wrapper.

Port of dqn_zoo_tpu/nets/torso_pallas.py (`dqn_torso_fused`). The CUDA
source is csrc/dqn_torso.cu, in two variants:
  K3a forward only (acting and target nets, under no_grad): the conv1/conv2
      activations never leave shared memory;
  K3b with residuals (the online net under grad): also writes z1 and z2,
      which the backward pass reads.
The backward is plain PyTorch convolution-gradient ops, as the JAX package's
is XLA outside its kernel. `torso_plain` is the plain version: three
F.conv2d calls on the same HWIO weights turned OIHW.

Weights stay HWIO here, as JAX keeps them: the kernel reads them as they
are; only the plain version and the backward permute to OIHW.
"""

from __future__ import annotations

import torch

from dqn_zoo_torch import kernels
from dqn_zoo_torch.nets.core import conv2d, flatten, hwio_to_oihw

SHAPES = {"w1": (8, 8, 4, 32), "b1": (32,), "w2": (4, 4, 32, 64),
          "b2": (64,), "w3": (3, 3, 64, 64), "b3": (64,)}
MACS_PER_SAMPLE = 20 * 20 * 32 * 256 + 9 * 9 * 64 * 512 + 7 * 7 * 64 * 576

_ARGS = [kernels.P] * 10 + [kernels.I, kernels.I, kernels.P]
FWD = kernels.register(kernels.Kernel(
    "dqn_torso_fwd", "dqn_torso.cu", "dz_dqn_torso", _ARGS))
FWD_RES = kernels.register(kernels.Kernel(
    "dqn_torso_fwd_residuals", "dqn_torso.cu", "dz_dqn_torso", _ARGS))


def torso_plain_residuals(w1, b1, w2, b2, w3, b3, x: torch.Tensor):
  """(out (B, 3136), z1 (B, 20, 20, 32), z2 (B, 9, 9, 64)), NHWC."""
  h = x.to(torch.float32) * (1.0 / 255.0)
  z1 = torch.relu(conv2d(h, w1, b1, 4))
  z2 = torch.relu(conv2d(z1, w2, b2, 2))
  return flatten(torch.relu(conv2d(z2, w3, b3, 1))), z1, z2


def torso_plain(w1, b1, w2, b2, w3, b3, x: torch.Tensor) -> torch.Tensor:
  """(B, 84, 84, 4) u8 → (B, 3136) f32, flattened in (y, x, c) order."""
  return torso_plain_residuals(w1, b1, w2, b2, w3, b3, x)[0]


def torso_plain_masked(w1, b1, w2, b2, w3, b3, x: torch.Tensor, masks):
  """The plain torso with given ReLU masks (NHWC, one per layer) in place of
  its own: autograd through it is a reference for the kernel's gradients
  that does not depend on which ReLU branch a pre-activation within f32
  rounding of 0 took."""
  h = x.to(torch.float32) * (1.0 / 255.0)
  h = conv2d(h, w1, b1, 4) * masks[0]
  h = conv2d(h, w2, b2, 2) * masks[1]
  return flatten(conv2d(h, w3, b3, 1) * masks[2])


def _check(ws, x: torch.Tensor) -> None:
  if x.device.type != "cuda" or x.dtype != torch.uint8 or x.dim() != 4 or \
      tuple(x.shape[1:]) != (84, 84, 4) or not x.is_contiguous():
    raise ValueError(
        "dqn_torso takes a contiguous uint8 CUDA tensor of shape "
        f"(B, 84, 84, 4); got {x.dtype} {tuple(x.shape)} on {x.device}.")
  for (name, shape), w in zip(SHAPES.items(), ws):
    if w.device != x.device or w.dtype != torch.float32 or \
        tuple(w.shape) != shape or not w.is_contiguous() or \
        w.data_ptr() % 16:
      raise ValueError(
          f"dqn_torso {name}: need a 16-byte aligned contiguous float32 "
          f"tensor of shape {shape} on {x.device}; got {w.dtype} "
          f"{tuple(w.shape)} on {w.device}.")


def torso_forward(ws, x: torch.Tensor, residuals: bool):
  """Launches K3b (residuals=True: returns out, z1, z2) or K3a (out)."""
  _check(ws, x)
  b = x.shape[0]
  dev = x.device
  out = torch.empty((b, 3136), dtype=torch.float32, device=dev)
  if residuals:
    z1 = torch.empty((b, 20, 20, 32), dtype=torch.float32, device=dev)
    z2 = torch.empty((b, 9, 9, 64), dtype=torch.float32, device=dev)
    zp1, zp2 = z1.data_ptr(), z2.data_ptr()
  else:
    z1 = z2 = None
    zp1 = zp2 = None
  kernel = FWD_RES if residuals else FWD
  kernel.launch(x.data_ptr(), *(w.data_ptr() for w in ws), out.data_ptr(),
                zp1, zp2, b, int(residuals), kernels.stream_ptr(dev))
  return (out, z1, z2) if residuals else out


class _Torso(torch.autograd.Function):
  """K3b forward; backward by plain convolution-gradient ops (no dx)."""

  @staticmethod
  def forward(ctx, w1, b1, w2, b2, w3, b3, x):
    out, z1, z2 = torso_forward((w1, b1, w2, b2, w3, b3), x, residuals=True)
    ctx.save_for_backward(x, w2, w3, z1, z2, out)
    return out

  @staticmethod
  def backward(ctx, dflat):
    grads = torso_backward(*ctx.saved_tensors, dflat)
    return grads + (None,)


def torso_backward(x, w2, w3, z1, z2, out, dflat):
  """(dw1, db1, dw2, db2, dw3, db3) of sum(out · dflat), weights HWIO, from
  the saved input and post-ReLU activations; no gradient for the uint8 x."""
  b = x.shape[0]
  grad = torch.nn.grad
  nchw = lambda t: t.permute(0, 3, 1, 2)
  to_hwio = lambda t: t.permute(2, 3, 1, 0).contiguous()
  dpre3 = nchw(dflat.reshape(b, 7, 7, 64) * (out.reshape(b, 7, 7, 64) > 0))
  z2n, z1n = nchw(z2), nchw(z1)
  dw3 = grad.conv2d_weight(z2n, (64, 64, 3, 3), dpre3, stride=1)
  db3 = dpre3.sum((0, 2, 3))
  dpre2 = grad.conv2d_input(z2n.shape, hwio_to_oihw(w3), dpre3,
                            stride=1) * (z2n > 0)
  dw2 = grad.conv2d_weight(z1n, (64, 32, 4, 4), dpre2, stride=2)
  db2 = dpre2.sum((0, 2, 3))
  dpre1 = grad.conv2d_input(z1n.shape, hwio_to_oihw(w2), dpre2,
                            stride=2) * (z1n > 0)
  x0 = nchw(x.to(torch.float32) * (1.0 / 255.0))
  dw1 = grad.conv2d_weight(x0, (32, 4, 8, 8), dpre1, stride=4)
  db1 = dpre1.sum((0, 2, 3))
  return (to_hwio(dw1), db1, to_hwio(dw2), db2, to_hwio(dw3), db3)


def dqn_torso(w1, b1, w2, b2, w3, b3, x: torch.Tensor,
              compute_dtype=torch.float32) -> torch.Tensor:
  """(B, 84, 84, 4) u8 → (B, 3136) f32 embedding.

  CPU tensors take the plain version (autograd through F.conv2d). On CUDA:
  K3b inside the autograd Function when a gradient is wanted, else K3a.
  K3 computes in f32 only, as the reference's fused torso does: any other
  `compute_dtype` raises (the bf16 torso is nets/atari.dqn_torso_cast)."""
  if compute_dtype != torch.float32:
    raise ValueError(f"K3 computes in float32; it cannot honour "
                     f"compute_dtype={compute_dtype}.")
  if x.device.type == "cpu":
    return torso_plain(w1, b1, w2, b2, w3, b3, x)
  ws = (w1, b1, w2, b2, w3, b3)
  if torch.is_grad_enabled() and any(w.requires_grad for w in ws):
    return _Torso.apply(*ws, x)
  return torso_forward(ws, x, residuals=False)


def bound_counts(batch: int, residuals: bool):
  """(bytes, flops) K3 must move and do: input, weights and output once
  (and z1, z2 for K3b); two flops per multiply-add."""
  nweights = sum(int(torch.Size(s).numel()) for s in SHAPES.values())
  per = 84 * 84 * 4 + 3136 * 4
  if residuals:
    per += (20 * 20 * 32 + 9 * 9 * 64) * 4
  return batch * per + 4 * nweights, 2 * MACS_PER_SAMPLE * batch
