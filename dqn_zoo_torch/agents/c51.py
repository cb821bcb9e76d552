"""C51's support (port of dqn_zoo_tpu/agents/c51.py:17-19), shared by the
rainbow agent. The c51 agent itself is not ported yet."""

from __future__ import annotations

import torch


def support(spec, device="cpu") -> torch.Tensor:
  """linspace(−vmax, vmax, num_atoms) in f32, each atom the f32 nearest to
  −vmax + 2·vmax·i/(num_atoms − 1). jnp.linspace's compiled f32 product can
  land an ulp or so of vmax away from that."""
  return torch.linspace(-spec.vmax, spec.vmax, spec.num_atoms,
                        dtype=torch.float64, device=device).float()
