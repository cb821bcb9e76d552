"""Bit-exact Pillow BILINEAR resize (port of dqn_zoo_tpu/prep/pil_resize.py).

The reference preprocessing resizes the pooled grayscale frame with
`Image.fromarray(pooled).resize((84, 84), Image.BILINEAR)` and pins the
result with a sha256 digest. Pillow's 8-bit resample (src/libImaging/
Resample.c) quantizes each output pixel's triangle-filter weights to fixed
point with 22 fractional bits, runs a horizontal pass and then a vertical
one, and rounds each pass back to 8 bits: clip8(2^21 + sum_k c_k p_k), where
clip8(v) = clamp(v >> 22, 0, 255).

The JAX package takes the two passes as int32 contractions. Torch has no
int32 product on CUDA, so here each pass is a float64 product with the
quantized coefficient matrix: every term and every partial sum is an integer
below 255 · 2^22 + 2^21 < 2^31, far inside float64's 2^53, so the product is
exact in any order of summation, and the rounding (add 2^21, floor of a
division by 2^22, clamp) is Pillow's. Float32 would be exact only below
2^24, and TF32 not at all.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

PRECISION_BITS = 32 - 8 - 2  # Resample.c: 22
_HALF = 1 << (PRECISION_BITS - 1)


@functools.lru_cache(maxsize=None)
def pil_bilinear_coeffs(in_size: int, out_size: int) -> np.ndarray:
  """Quantized Pillow coefficient matrix, shape (out_size, in_size) int32.

  Mirrors precompute_coeffs + normalize_coeffs_8bpc (Resample.c): double
  precision triangle weights over a support window, sum-normalized, then
  fixed-point quantized. Row r holds the weights of output pixel r.
  """
  scale = in_size / out_size
  filterscale = max(scale, 1.0)
  support = 1.0 * filterscale  # bilinear filter support = 1.0
  ss = 1.0 / filterscale
  out = np.zeros((out_size, in_size), np.int32)
  for xx in range(out_size):
    center = (xx + 0.5) * scale
    xmin = int(center - support + 0.5)
    if xmin < 0:
      xmin = 0
    xmax = int(center + support + 0.5)
    if xmax > in_size:
      xmax = in_size
    k = np.zeros(xmax - xmin, np.float64)
    for x in range(xmax - xmin):
      w = (x + xmin - center + 0.5) * ss
      w = abs(w)
      k[x] = (1.0 - w) if w < 1.0 else 0.0
    total = k.sum()
    if total != 0.0:
      k /= total
    # normalize_coeffs_8bpc: round half away from zero, C truncation.
    q = np.where(k < 0, -0.5 + k * (1 << PRECISION_BITS),
                 0.5 + k * (1 << PRECISION_BITS)).astype(np.int64)
    out[xx, xmin:xmax] = q.astype(np.int32)
  return out


@functools.lru_cache(maxsize=None)
def _coeffs(in_size: int, out_size: int, device: torch.device):
  """The coefficient matrix as float64 on `device`, copied there once."""
  return torch.from_numpy(pil_bilinear_coeffs(in_size, out_size).astype(
      np.float64)).to(device)


def _clip8(acc: torch.Tensor) -> torch.Tensor:
  """clip8(2^21 + acc) on exact float64 integers: the arithmetic shift by 22
  is a floor of an exact division by 2^22; negatives go to 0, and sums of
  2^30 or more to 255."""
  return torch.clamp(torch.floor((acc + _HALF) * 2.0**-PRECISION_BITS),
                     0, 255)


def resize_pil_exact(images: torch.Tensor, shape=(84, 84)) -> torch.Tensor:
  """uint8 (..., H, W) -> uint8 (..., out_h, out_w), bit for bit
  `PIL.Image.fromarray(img).resize((out_w, out_h), Image.BILINEAR)`.

  The horizontal pass first, then the vertical one, each rounded to 8 bits,
  as Pillow's two-pass resample."""
  out_h, out_w = shape
  in_h, in_w = images.shape[-2], images.shape[-1]
  x = images.to(torch.float64)
  if in_w != out_w:
    x = _clip8(x @ _coeffs(in_w, out_w, images.device).T)
  if in_h != out_h:
    x = _clip8(_coeffs(in_h, out_h, images.device) @ x)
  return x.to(torch.uint8)
