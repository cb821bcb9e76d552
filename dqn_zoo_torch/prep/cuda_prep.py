"""Kernel K2: pooled frames → 84×84 observation, on the card.

Port of dqn_zoo_tpu/prep/pallas_prep.py (`pooled_frame_to_84_pallas`). The
CUDA source is csrc/pooled_frame_to_84.cu; its plain version is
prep/atari.pooled_frame_to_84_plain. The resize matrices are the port's own
(`prep.atari.resize_weights`), passed to the kernel with each row's nonzero
band so that it sums only the taps that count.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from dqn_zoo_torch import kernels
from dqn_zoo_torch.envs.api import FRAME_HEIGHT, FRAME_WIDTH
from dqn_zoo_torch.prep.atari import (OUT, pooled_frame_to_84_plain,
                                      resize_weights)

KERNEL = kernels.register(kernels.Kernel(
    "pooled_frame_to_84", "pooled_frame_to_84.cu", "dz_pooled_frame_to_84",
    [kernels.P] * 7 + [kernels.I, kernels.P]))

_CONSTS: Dict[torch.device, tuple] = {}


def _band(w: np.ndarray) -> np.ndarray:
  """(rows, 2) int32 [first, last + 1) of each row's nonzero weights."""
  out = np.zeros((w.shape[0], 2), np.int32)
  for i, row in enumerate(w):
    nz = np.nonzero(row)[0]
    out[i] = (nz[0], nz[-1] + 1) if nz.size else (0, 0)
  return out


def resize_constants(device: torch.device):
  """(Ry, Cx, Ry band, Cx band) on `device`, made once per device."""
  if device not in _CONSTS:
    ry = resize_weights(FRAME_HEIGHT, OUT)
    cx = resize_weights(FRAME_WIDTH, OUT)
    _CONSTS[device] = tuple(
        torch.from_numpy(a).to(device)
        for a in (ry, cx, _band(ry), _band(cx)))
  return _CONSTS[device]


def pooled_frame_to_84(frame_penult: torch.Tensor,
                       frame_last: torch.Tensor) -> torch.Tensor:
  """(B, 210, 160, 3) u8 ×2 → (B, 84, 84) u8.

  CPU tensors take the plain version; CUDA tensors launch K2 or raise."""
  if frame_penult.device.type == "cpu":
    return pooled_frame_to_84_plain(frame_penult, frame_last)
  shape = (frame_penult.shape[0], FRAME_HEIGHT, FRAME_WIDTH, 3)
  for f in (frame_penult, frame_last):
    if f.device.type != "cuda" or f.dtype != torch.uint8 or \
        tuple(f.shape) != shape or not f.is_contiguous():
      raise ValueError(
          "pooled_frame_to_84 takes two contiguous uint8 CUDA tensors of "
          f"shape (B, 210, 160, 3); got {f.dtype} {tuple(f.shape)} on "
          f"{f.device}, contiguous={f.is_contiguous()}.")
  if frame_last.device != frame_penult.device:
    raise ValueError("frames are on different devices.")
  dev = frame_penult.device
  ry, cx, ry_band, cx_band = resize_constants(dev)
  out = torch.empty((shape[0], OUT, OUT), dtype=torch.uint8, device=dev)
  KERNEL.launch(frame_penult.data_ptr(), frame_last.data_ptr(),
                ry.data_ptr(), cx.data_ptr(), ry_band.data_ptr(),
                cx_band.data_ptr(), out.data_ptr(), shape[0],
                kernels.stream_ptr(dev))
  return out


def bound_counts(batch: int):
  """(bytes, flops) K2 must move and do for `batch` envs: both frames read
  once, the observation written once, and a multiply-add per nonzero tap of
  the two resize passes."""
  ry = resize_weights(FRAME_HEIGHT, OUT)
  cx = resize_weights(FRAME_WIDTH, OUT)
  taps = int(np.count_nonzero(ry)) * FRAME_WIDTH + \
      int(np.count_nonzero(cx)) * OUT
  nbytes = batch * (2 * FRAME_HEIGHT * FRAME_WIDTH * 3 + OUT * OUT)
  return nbytes, batch * 2 * taps
