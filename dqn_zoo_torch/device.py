"""Device resolution for every entry point of the port.

Entry points run on CUDA unless the caller asks for the CPU. A missing card
is an error, never a quiet fall back to the CPU: a CPU run of a GPU trainer
would report CPU numbers under a GPU name.
"""

from __future__ import annotations

import torch


def set_numerics() -> None:
  """Full-f32 matmuls and convolutions on the card.

  The slice is f32 end to end, like the JAX reference. PyTorch leaves
  cuDNN convolutions in TF32 by default (about three decimal digits), which
  would put the plain torso version and the conv backward well outside the
  tolerances the kernels and the differential tests are held to. This is
  the one place the port sets them.
  """
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
  """`device` or CUDA when None; raises when CUDA is asked for but absent."""
  dev = torch.device("cuda" if device is None else device)
  if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(
        "CUDA is not available; pass device='cpu' to run the port on the "
        "CPU explicitly.")
  if dev.type not in ("cuda", "cpu"):
    raise ValueError(f"Unsupported device {dev}; use 'cuda' or 'cpu'.")
  set_numerics()
  return dev
