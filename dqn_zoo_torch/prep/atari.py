"""Atari preprocessing (port of dqn_zoo_tpu/prep/atari.py).

`rgb_to_y`, `resize_bilinear` and `pooled_frame_to_84_plain` are the plain
PyTorch versions of kernel K2 (prep/cuda_prep.py); `pooled_frame_to_84`
dispatches on the resize method and on the frames' device. The `pil` method
is max, `rgb_to_y_fused` and Pillow's exact resample (prep/pil_resize.py),
on any device and without K2, as the JAX package's is.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch


RGB2Y_WEIGHTS = (0.299, 0.587, 1.0 - (0.299 + 0.587))
OUT = 84


@functools.lru_cache(maxsize=None)
def resize_weights(src: int, dst: int) -> np.ndarray:
  """(dst, src) antialiased linear (triangle) resampling matrix.

  The model of jax.image.resize(method='linear', antialias=True): sample
  positions at pixel centres, triangle support dilated by the scale factor,
  rows normalised to sum 1.
  """
  scale = dst / src
  out = np.zeros((dst, src), np.float32)
  inv = 1.0 / scale
  for i in range(dst):
    center = (i + 0.5) * inv - 0.5
    lo = int(np.floor(center - inv))
    hi = int(np.ceil(center + inv))
    for j in range(max(lo, 0), min(hi + 1, src)):
      out[i, j] = max(0.0, 1.0 - abs(j - center) * scale)
    s = out[i].sum()
    if s > 0:
      out[i] /= s
  return out


def rgb_to_y(frames: torch.Tensor) -> torch.Tensor:
  """uint8 (..., H, W, 3) → uint8 (..., H, W) luma, truncating like astype."""
  f = frames.to(torch.float32)
  w = torch.tensor(RGB2Y_WEIGHTS, dtype=torch.float32, device=frames.device)
  y = f[..., 0] * w[0] + f[..., 1] * w[1] + f[..., 2] * w[2]
  return torch.clamp(y, max=255.0).to(torch.uint8)


def rgb_to_y_fused(frames: torch.Tensor) -> torch.Tensor:
  """rgb_to_y as XLA compiles the JAX package's on the CPU: its dot fuses
  each product into the running sum, fma(b, w2, fma(g, w1, r w0)), each
  rounded once to f32 (envs.f32.fma). The `pil` path takes it, so that its
  observations are the JAX package's bit for bit; the separate roundings of
  `rgb_to_y`, which K2 shares, move ~1 pixel in 20,000 of random frames by
  one level."""
  from dqn_zoo_torch.envs.f32 import fma
  f = frames.to(torch.float32)
  w0, w1, w2 = RGB2Y_WEIGHTS
  y = fma(f[..., 2], w2, fma(f[..., 1], w1, fma(f[..., 0], w0, 0.0)))
  return torch.clamp(y, max=255.0).to(torch.uint8)


def resize_bilinear(images: torch.Tensor) -> torch.Tensor:
  """uint8 (..., H, W) → uint8 (..., 84, 84), antialiased bilinear.

  Ry · Y · Cxᵀ with the `resize_weights` matrices, rounded half to even."""
  h, w = images.shape[-2:]
  dev = images.device
  ry = torch.from_numpy(resize_weights(h, OUT)).to(dev)
  cx = torch.from_numpy(resize_weights(w, OUT)).to(dev)
  out = ry @ images.to(torch.float32) @ cx.T
  return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def pooled_frame_to_84_plain(frame_penult: torch.Tensor,
                             frame_last: torch.Tensor) -> torch.Tensor:
  """(B, 210, 160, 3) u8 ×2 → (B, 84, 84) u8: max, luma, resize."""
  return resize_bilinear(rgb_to_y(torch.maximum(frame_penult, frame_last)))


def pooled_frame_to_84(frame_penult: torch.Tensor, frame_last: torch.Tensor,
                       resize_method: str = "fast") -> torch.Tensor:
  """The 84×84 observation of an action-repeat group's two last frames.

  Either frame may be all zero (episode-boundary padding). `fast`: on CUDA
  tensors kernel K2, on CPU tensors its plain version. `pil`: the reference
  pipeline bit for bit, Pillow's resample of the fused luma."""
  if resize_method == "pil":
    from dqn_zoo_torch.prep.pil_resize import resize_pil_exact
    return resize_pil_exact(rgb_to_y_fused(torch.maximum(frame_penult,
                                                         frame_last)))
  if resize_method != "fast":
    raise ValueError(f"Unknown resize_method {resize_method!r}.")
  from dqn_zoo_torch.prep import cuda_prep
  return cuda_prep.pooled_frame_to_84(frame_penult, frame_last)


def aggregate_rewards(group_rewards: torch.Tensor,
                      max_abs_reward: float = 1.0) -> torch.Tensor:
  return torch.clamp(group_rewards.sum(-1), -max_abs_reward, max_abs_reward)


def aggregate_discounts(group_discounts: torch.Tensor,
                        additional_discount: float = 0.99) -> torch.Tensor:
  return torch.prod(group_discounts, dim=-1) * additional_discount


class FrameStackState(NamedTuple):
  """Per-env stack of the last 4 observations, oldest-first channel order."""

  frames: torch.Tensor  # (B, 84, 84, 4) uint8
  count: torch.Tensor  # (B,) int32 — number of valid frames in the stack


def frame_stack_init(batch: int, device, size: int = 84,
                     stack: int = 4) -> FrameStackState:
  return FrameStackState(
      frames=torch.zeros((batch, size, size, stack), dtype=torch.uint8,
                         device=device),
      count=torch.zeros((batch,), dtype=torch.int32, device=device),
  )


def frame_stack_update(state: FrameStackState, obs84: torch.Tensor,
                       is_first: torch.Tensor) -> FrameStackState:
  """Appends obs84 (B, 84, 84) to each env's stack (functional).

  On FIRST the stack resets to [obs, 0, 0, 0]; while count < 4 the frame is
  appended at channel `count`; once full the stack shifts left and the frame
  lands at channel 3 — the reference's Deque(4) + trailing zero pad."""
  k = state.frames.shape[-1]
  first = is_first[:, None, None, None]
  frames = torch.where(first, torch.zeros_like(state.frames), state.frames)
  count = torch.where(is_first, torch.zeros_like(state.count), state.count)
  shifted = torch.cat([frames[..., 1:], torch.zeros_like(frames[..., :1])],
                      dim=-1)
  full = (count >= k)[:, None, None, None]
  base = torch.where(full, shifted, frames)
  write_idx = torch.clamp(count, max=k - 1)
  onehot = torch.arange(k, device=count.device) == write_idx[:, None]
  new_frames = torch.where(onehot[:, None, None, :], obs84[..., None], base)
  return FrameStackState(frames=new_frames,
                         count=torch.clamp(count + 1, max=k))
