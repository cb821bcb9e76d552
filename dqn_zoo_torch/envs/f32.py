"""The reference's compiled f32 arithmetic, for games that must give its bits.

XLA, compiling the JAX package's games for the CPU, turns a division by a
constant into a product with the constant's f32 reciprocal, and fuses a
product that feeds a sum into one multiply-add, rounded once. Eager torch
does neither, on the CPU or on the card. A game writes those forms out with
these helpers where they can change a result, and then gives the
reference's bits on both devices: a product, a sum and a conversion are
IEEE operations on each.
"""

from __future__ import annotations

import numpy as np
import torch


def recip(c: float) -> float:
  """c's f32 reciprocal (1 / c rounded once to f32), as a Python float."""
  return float(np.float32(1.0) / np.float32(c))


def _wide(v):
  if isinstance(v, torch.Tensor):
    return v.to(torch.float64)
  return float(np.float32(v))  # a constant as the reference holds it


def fma(a, b, c) -> torch.Tensor:
  """a * b + c rounded once to f32: f32 tensors, or Python numbers taken at
  f32. In f64 the product of two f32 values is exact, and so is the sum
  where its two terms span at most 53 bits, as at every use in the games;
  the one rounding is then the conversion to f32."""
  return (_wide(a) * _wide(b) + _wide(c)).to(torch.float32)
