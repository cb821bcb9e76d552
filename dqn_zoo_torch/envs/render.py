"""Mask-based batched frame rendering (port of dqn_zoo_tpu/envs/render.py)."""

from __future__ import annotations

import torch

from dqn_zoo_torch.envs.api import FRAME_HEIGHT, FRAME_WIDTH, constant


def _edge(v):
  """A box edge to compare with a row or column index: an int as it is (a
  Python scalar, which reaches the device without a copy; a tensor made
  from it on the host would be copied, and the copy waits for the
  device), a (B,) tensor as int32 (floats truncated like astype) with a
  trailing axis."""
  if isinstance(v, int):
    return v
  return v.to(torch.int32)[..., None]


def rect_mask(y0, y1, x0, x1, device) -> torch.Tensor:
  """Bool mask of the half-open box [y0, y1) × [x0, x1).

  Coordinates are ints or (B,) tensors; the result is (210, 160) for ints
  only and (B, 210, 160) otherwise. Separable: a row mask times a column
  mask, the same pixels as comparing every pixel's coordinates.
  """
  rows = torch.arange(FRAME_HEIGHT, dtype=torch.int32, device=device)
  cols = torch.arange(FRAME_WIDTH, dtype=torch.int32, device=device)
  y0, y1, x0, x1 = (_edge(v) for v in (y0, y1, x0, x1))
  rm = (rows >= y0) & (rows < y1)
  cm = (cols >= x0) & (cols < x1)
  return rm[..., :, None] & cm[..., None, :]


def compose(batch: int, device, background_rgb, *layers) -> torch.Tensor:
  """Paints (mask, rgb) layers over a constant background, later on top.

  Returns (B, 210, 160, 3) uint8; masks are (210, 160) or (B, 210, 160).
  Each pixel takes the index of its top layer, and one gather from the
  palette paints them all: the same frame as a select per layer. The
  palette is made once for each set of colours and device.
  """
  colours = (tuple(background_rgb),) + tuple(tuple(rgb) for _, rgb in layers)
  palette = constant(colours, torch.uint8, device)
  index = torch.zeros((batch, FRAME_HEIGHT, FRAME_WIDTH), dtype=torch.int64,
                      device=device)
  for k, (mask, _) in enumerate(layers, 1):
    index.masked_fill_(mask, k)
  return palette[index]
