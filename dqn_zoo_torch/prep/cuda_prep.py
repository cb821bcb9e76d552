"""Kernel K2: pooled frames → 84×84 observation, on the card.

Port of dqn_zoo_tpu/prep/pallas_prep.py (`pooled_frame_to_84_pallas`). The
CUDA source is csrc/pooled_frame_to_84.cu; its plain version is
prep/atari.pooled_frame_to_84_plain. The kernel's grid cuts each env's 84
output rows into bands; `band_plan` tells it which input rows each band
reads and the nonzero taps of the port's own resize matrices
(`prep.atari.resize_weights`), so that it sums only the taps that count.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple

import numpy as np
import torch

from dqn_zoo_torch import kernels
from dqn_zoo_torch.envs.api import FRAME_HEIGHT, FRAME_WIDTH
from dqn_zoo_torch.prep.atari import (OUT, pooled_frame_to_84_plain,
                                      resize_weights)

KERNEL = kernels.register(kernels.Kernel(
    "pooled_frame_to_84", "pooled_frame_to_84.cu", "dz_pooled_frame_to_84",
    [kernels.P] * 4 + [kernels.I] * 4 + [kernels.P]))

BAND_ROWS = 6  # output rows a block computes on the main path
TAPS = 5  # weight slots of a tap record (Ry has 4-5 taps, Cx 3-4)
REC = 2 + TAPS  # a tap record: first tap, tap count, weights (f32 bits)
THREADS, STAGE = 256, 3  # a block's threads, and the plan words each stages
SMEM_LIMIT = 200 * 1024  # a block's shared memory (above 48 KB by opt-in)
MAX_BATCH = 65535  # envs on the grid's second axis


class BandPlan(NamedTuple):
  band_rows: int
  bands: int
  max_rows: int  # the most input rows a band reads
  # int32: bands x (first input row, rows), then the 84 tap records of Ry's
  # rows, then those of Cx's rows.
  plan: np.ndarray


def tap_table(w: np.ndarray):
  """(first, count, weights (rows, TAPS)) of each row's nonzero run of `w`."""
  first = np.zeros(w.shape[0], np.int32)
  count = np.zeros(w.shape[0], np.int32)
  out = np.zeros((w.shape[0], TAPS), np.float32)
  for i, row in enumerate(w):
    nz = np.nonzero(row)[0]
    first[i], count[i] = nz[0], nz[-1] + 1 - nz[0]
    if count[i] > TAPS:
      raise ValueError(f"row {i} has {count[i]} taps, more than {TAPS}")
    out[i, :count[i]] = row[first[i]:first[i] + count[i]]
  return first, count, out


def _records(w: np.ndarray) -> np.ndarray:
  first, count, taps = tap_table(w)
  return np.concatenate([first[:, None], count[:, None], taps.view(np.int32)],
                        axis=1)


def smem_bytes(max_rows: int) -> int:
  """A block's shared memory: both frames' rows and their f32 luma
  (csrc/pooled_frame_to_84.cu, `smem_bytes`)."""
  return 2 * max_rows * FRAME_WIDTH * 3 + max_rows * FRAME_WIDTH * 4


@functools.lru_cache(maxsize=None)
def band_plan(band_rows: int = BAND_ROWS) -> BandPlan:
  """The bands of `band_rows` output rows and the taps K2 reads."""
  ry = _records(resize_weights(FRAME_HEIGHT, OUT))
  cx = _records(resize_weights(FRAME_WIDTH, OUT))
  ry_lo, ry_n = ry[:, 0], ry[:, 1]
  bands = -(-OUT // band_rows)
  spans = np.zeros((bands, 2), np.int32)
  for k in range(bands):
    rows = slice(k * band_rows, min((k + 1) * band_rows, OUT))
    y0 = ry_lo[rows].min()
    spans[k] = y0, (ry_lo[rows] + ry_n[rows]).max() - y0
  plan = np.concatenate([spans.ravel(), ry.ravel(), cx.ravel()])
  max_rows = int(spans[:, 1].max())
  if smem_bytes(max_rows) > SMEM_LIMIT:
    raise ValueError(f"bands of {band_rows} rows need "
                     f"{smem_bytes(max_rows)} bytes of shared memory a "
                     f"block, more than {SMEM_LIMIT}")
  # Once luma is done, the band's f32 vertical sums take the first frame's
  # rows and the tap records it stages the second's.
  stage = (band_rows + OUT) * REC
  if band_rows * FRAME_WIDTH * 4 > max_rows * FRAME_WIDTH * 3 or \
      4 * stage > max_rows * FRAME_WIDTH * 3 or stage > STAGE * THREADS:
    raise ValueError(f"bands of {band_rows} rows do not fit the kernel's "
                     "staging of its tap records")
  return BandPlan(band_rows, bands, max_rows, plan)


_DEVICE_PLANS: Dict[tuple, tuple] = {}


def launch(frame_penult: torch.Tensor, frame_last: torch.Tensor,
           band_rows: int, entry) -> torch.Tensor:
  """Calls `entry` (K2's C entry, or one of a variant's built from the same
  source) on the frames with the plan of `band_rows`; returns the output.
  The frames are as `pooled_frame_to_84` checks them."""
  dev = frame_penult.device
  key = (dev, band_rows)
  if key not in _DEVICE_PLANS:
    p = band_plan(band_rows)
    _DEVICE_PLANS[key] = (p, torch.from_numpy(p.plan).to(dev))
  p, plan = _DEVICE_PLANS[key]
  out = torch.empty((frame_penult.shape[0], OUT, OUT), dtype=torch.uint8,
                    device=dev)
  entry(frame_penult.data_ptr(), frame_last.data_ptr(), plan.data_ptr(),
        out.data_ptr(), frame_penult.shape[0], p.bands, p.band_rows,
        p.max_rows, kernels.stream_ptr(dev))
  return out


def pooled_frame_to_84(frame_penult: torch.Tensor,
                       frame_last: torch.Tensor) -> torch.Tensor:
  """(B, 210, 160, 3) u8 ×2 → (B, 84, 84) u8.

  CPU tensors take the plain version; CUDA tensors launch K2 or raise."""
  if frame_penult.device.type == "cpu":
    return pooled_frame_to_84_plain(frame_penult, frame_last)
  shape = (frame_penult.shape[0], FRAME_HEIGHT, FRAME_WIDTH, 3)
  for f in (frame_penult, frame_last):
    if f.device.type != "cuda" or f.dtype != torch.uint8 or \
        tuple(f.shape) != shape or not f.is_contiguous() or \
        f.data_ptr() % 16:
      raise ValueError(
          "pooled_frame_to_84 takes two contiguous, 16-byte aligned uint8 "
          f"CUDA tensors of shape (B, 210, 160, 3); got {f.dtype} "
          f"{tuple(f.shape)} on {f.device}, contiguous={f.is_contiguous()}, "
          f"address {f.data_ptr():#x}.")
  if frame_last.device != frame_penult.device:
    raise ValueError("frames are on different devices.")
  if shape[0] > MAX_BATCH:
    raise ValueError(f"pooled_frame_to_84 takes at most {MAX_BATCH} envs; "
                     f"got {shape[0]}.")
  return launch(frame_penult, frame_last, BAND_ROWS, KERNEL.launch)


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
