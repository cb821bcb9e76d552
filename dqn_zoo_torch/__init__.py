"""dqn_zoo_torch: the PyTorch/CUDA port of dqn_zoo_tpu.

The module names follow dqn_zoo_tpu so that each port module sits beside its
reference. The JAX package is the reference the port is tested against; this
package imports torch and numpy only, never jax and nothing of dqn_zoo_tpu.
Hand-written CUDA kernels live in `csrc/` and are built at first use
(`kernels.py`).
"""

__version__ = "0.1.0"
