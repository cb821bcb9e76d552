"""Kernel K1: contiguous-window frame gather, the replay sample's data path.

Port of dqn_zoo_tpu/replay/window_gather.py (`gather_windows_pallas`). A
sampled transition needs the K-frame stacks of rows k and k+m*, which lie in
K + n consecutive ring rows; one contiguous window per sample covers both.

Rows are stored unpadded, (S, C+W, 84, 84) uint8: the JAX package padded
them to (64, 128) for the TPU's DMA tiling, but 7056 bytes is already a
multiple of 16, which is all the card's bulk copies need. The CUDA source
is csrc/window_gather.cu; `gather_windows_plain` is its plain version. The
kernel reads int64 or int32 indices as they are, so a call on the card is
one launch.
"""

from __future__ import annotations

import torch

from dqn_zoo_torch import kernels

KERNEL = kernels.register(kernels.Kernel(
    "gather_windows", "window_gather.cu", "dz_gather_windows",
    [kernels.P] * 4 + [kernels.I] * 6 + [kernels.P]))


def gather_windows_plain(frames: torch.Tensor, stream: torch.Tensor,
                         start: torch.Tensor, window: int) -> torch.Tensor:
  """frames (S, R, F, F) u8; stream/start (B,) ints → (B, W, F, F).

  Indices follow lax.dynamic_slice: a negative index counts from the end,
  then the window is clamped into range."""
  s, r = frames.shape[:2]
  st, s0 = stream.long(), start.long()
  st = torch.clamp(torch.where(st < 0, st + s, st), 0, s - 1)
  s0 = torch.clamp(torch.where(s0 < 0, s0 + r, s0), 0, r - window)
  w = torch.arange(window, device=frames.device)
  return frames[st[:, None], s0[:, None] + w[None, :]]


def gather_windows(frames: torch.Tensor, stream: torch.Tensor,
                   start: torch.Tensor, window: int) -> torch.Tensor:
  """Same contract as gather_windows_plain.

  CPU tensors take the plain version; CUDA tensors launch K1 or raise. The
  indices reach the kernel as they are: int64 (the replay's sample path) or
  int32, both of one type."""
  dev = frames.device
  if dev.type == "cpu":
    return gather_windows_plain(frames, stream, start, window)
  if dev.type != "cuda" or frames.dtype != torch.uint8 or \
      frames.dim() != 4 or not frames.is_contiguous() or \
      frames.data_ptr() % 16:
    raise ValueError(
        "gather_windows takes a contiguous, 16-byte aligned uint8 CUDA frame "
        f"store of shape (S, R, H, W); got {frames.dtype} "
        f"{tuple(frames.shape)} on {dev}.")
  s, r, h, w = frames.shape
  row_bytes = h * w
  if row_bytes % 16 != 0 or not 0 < window <= r:
    raise ValueError(f"rows of {row_bytes} bytes (need a multiple of 16) or "
                     f"window {window} outside (0, {r}].")
  index_type = stream.dtype
  if stream.dim() != 1 or stream.shape != start.shape or \
      start.dtype != index_type or \
      index_type not in (torch.int32, torch.int64):
    raise ValueError("stream and start must be (B,) tensors, both int32 or "
                     f"both int64; got {stream.dtype} {tuple(stream.shape)} "
                     f"and {start.dtype} {tuple(start.shape)}.")
  if stream.device != dev or start.device != dev:
    raise ValueError("indices must be on the frame store's device.")
  stream, start = stream.contiguous(), start.contiguous()
  b = stream.shape[0]
  out = torch.empty((b, window, h, w), dtype=torch.uint8, device=dev)
  KERNEL.launch(frames.data_ptr(), stream.data_ptr(), start.data_ptr(),
                out.data_ptr(), b, s, r, window, row_bytes,
                4 if index_type == torch.int32 else 8,
                kernels.stream_ptr(dev))
  return out
