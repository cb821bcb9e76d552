"""Differential tests: the plain versions of the port's kernels K1-K3 against
the JAX package's functions, on the same numpy-seeded inputs (CPU).

The CUDA kernels themselves are held against these plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqn_zoo_tpu import prep as jprep
from dqn_zoo_tpu.nets import torso_pallas
from dqn_zoo_tpu.prep.pallas_prep import _resize_weights as jax_weights
from dqn_zoo_tpu.replay import window_gather as jwg
from dqn_zoo_torch.nets import torso_cuda
from dqn_zoo_torch.prep import atari as tprep
from dqn_zoo_torch.prep import cuda_prep
from dqn_zoo_torch.replay import window_gather as twg
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


# --- K1: window gather (exact) ----------------------------------------------


@pytest.mark.parametrize("window", [1, 5, 7])
def test_k1_plain_matches_gather_windows_xla(window):
  rng = np.random.RandomState(window)
  s, r, b = 3, 12, 16
  frames84 = rng.randint(0, 256, (s, r, 84, 84), np.uint8)
  # The JAX store pads each row to (64, 128); the port stores it unpadded.
  padded = np.asarray(jwg.pad_frames(jnp.asarray(frames84)))
  stream = rng.randint(0, s, (b,)).astype(np.int32)
  start = rng.randint(0, r - window + 1, (b,)).astype(np.int32)
  # Out-of-range indices clamp like lax.dynamic_slice on both sides.
  stream[:2] = (-1, s + 2)
  start[2:4] = (-3, r)
  want = np.asarray(jwg.unpad_frames(
      jwg.gather_windows_xla(jnp.asarray(padded), jnp.asarray(stream),
                             jnp.asarray(start), window), 84))
  got = twg.gather_windows(torch.from_numpy(frames84),
                           torch.from_numpy(stream), torch.from_numpy(start),
                           window).numpy()
  np.testing.assert_array_equal(got, want)


# --- K2: pooled frame → 84×84 (±1, ≥ 98 % exact) ------------------------------


def test_k2_resize_weights_match_jax_package():
  for src in (210, 160):
    np.testing.assert_array_equal(tprep.resize_weights(src, 84),
                                  jax_weights(src, 84))


def test_k2_bands_cover_every_nonzero_weight():
  for w in (tprep.resize_weights(210, 84), tprep.resize_weights(160, 84)):
    first, count, taps = cuda_prep.tap_table(w)
    for i, (row, lo, n) in enumerate(zip(w, first, count)):
      hi = lo + n
      assert not row[:lo].any() and not row[hi:].any() and hi > lo
      np.testing.assert_array_equal(taps[i, :n], row[lo:hi])
      assert not taps[i, n:].any()


def _k2_compare(f1, f2):
  want = np.asarray(jprep.pooled_frame_to_84(jnp.asarray(f1),
                                             jnp.asarray(f2)))
  got = cuda_prep.pooled_frame_to_84(torch.from_numpy(f1),
                                     torch.from_numpy(f2)).numpy()
  assert got.dtype == np.uint8 and got.shape == want.shape
  diff = np.abs(got.astype(int) - want.astype(int))
  # Same tolerance as the JAX package's own kernel test: the resize sums in
  # another order, which moves a value across a .5 rounding edge rarely.
  assert (diff <= 1).all(), (diff.max(), (diff > 1).mean())
  assert (diff == 0).mean() > 0.98


def test_k2_plain_matches_jax_chain():
  rng = np.random.RandomState(0)
  _k2_compare(rng.randint(0, 256, (3, 210, 160, 3), np.uint8),
              rng.randint(0, 256, (3, 210, 160, 3), np.uint8))


def test_k2_plain_zero_penult_case():
  rng = np.random.RandomState(1)
  f2 = rng.randint(0, 256, (2, 210, 160, 3), np.uint8)
  _k2_compare(np.zeros_like(f2), f2)


def test_k2_rgb_to_y_matches_jax():
  rng = np.random.RandomState(2)
  f = rng.randint(0, 256, (2, 50, 40, 3), np.uint8)
  want = np.asarray(jprep.rgb_to_y(jnp.asarray(f))).astype(int)
  got = tprep.rgb_to_y(torch.from_numpy(f)).numpy().astype(int)
  # Luma truncates: a last-bit difference at an integer edge moves it by 1.
  assert np.abs(got - want).max() <= 1 and (got == want).mean() > 0.999


# --- K3: DQN torso forward and gradients ----------------------------------------


def _torso_inputs(b, seed=0):
  rng = np.random.RandomState(seed)
  ws = []
  for name, shape in torso_cuda.SHAPES.items():
    fan_in = int(np.prod(shape[:-1])) if name.startswith("w") else 256
    ws.append((rng.uniform(-1, 1, shape) / np.sqrt(fan_in)).astype(np.float32))
  x = rng.randint(0, 256, (b, 84, 84, 4), np.uint8)
  return ws, x


def test_k3_plain_forward_matches_torso_xla_reference():
  ws, x = _torso_inputs(3)
  want = np.asarray(torso_pallas.torso_xla_reference(
      *map(jnp.asarray, ws), jnp.asarray(x)))
  got = torso_cuda.dqn_torso(*map(torch.from_numpy, ws),
                             torch.from_numpy(x)).numpy()
  assert got.shape == (3, 3136)
  # f32 convolutions summed in another order on the CPU.
  np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_k3_plain_gradients_match_jax_grad():
  ws, x = _torso_inputs(2, seed=1)
  g = np.random.RandomState(2).randn(2, 3136).astype(np.float32)

  def f(*w):
    return jnp.sum(torso_pallas.torso_xla_reference(*w, jnp.asarray(x)) * g)

  want = jax.grad(f, argnums=tuple(range(6)))(*map(jnp.asarray, ws))
  tw = [torch.from_numpy(w).requires_grad_(True) for w in ws]
  out = torso_cuda.dqn_torso(*tw, torch.from_numpy(x))
  got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), tw)
  for a, b in zip(got, want):
    # Gradients sum over batch and space: more terms, looser than forward.
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                               atol=1e-5)


def test_k3_backward_formula_matches_jax_grad():
  """The CUDA autograd Function's backward (plain ops on saved residuals)
  runs here on residuals from the plain forward."""
  ws, x = _torso_inputs(2, seed=3)
  g = np.random.RandomState(4).randn(2, 3136).astype(np.float32)

  def f(*w):
    return jnp.sum(torso_pallas.torso_xla_reference(*w, jnp.asarray(x)) * g)

  want = jax.grad(f, argnums=tuple(range(6)))(*map(jnp.asarray, ws))
  tw = [torch.from_numpy(w) for w in ws]
  tx = torch.from_numpy(x)
  out, z1, z2 = torso_cuda.torso_plain_residuals(*tw, tx)
  got = torso_cuda.torso_backward(tx, tw[2], tw[4], z1, z2, out,
                                  torch.from_numpy(g))
  for a, b in zip(got, want):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                               atol=1e-5)


def test_k3_flatten_order_is_jax_nhwc():
  """Channel 0 of position (y=0, x=1) must land at flat index 64, as JAX
  flattens (7, 7, 64) NHWC; an NCHW flatten would put it at 1."""
  ws, x = _torso_inputs(1, seed=5)
  tw = list(map(torch.from_numpy, ws))
  _, _, z2 = torso_cuda.torso_plain_residuals(*tw, torch.from_numpy(x))
  out = torso_cuda.torso_plain(*tw, torch.from_numpy(x))
  want = torch.relu(torch.einsum(
      "hwc,hwcn->n", z2[0, 0:3, 1:4, :], tw[4]) + tw[5])
  np.testing.assert_allclose(out[0, 64:128].numpy(), want.numpy(), rtol=1e-5,
                             atol=1e-6)


def test_k3_masked_reference_with_own_masks_is_the_plain_torso():
  ws, x = _torso_inputs(2, seed=6)
  tw = list(map(torch.from_numpy, ws))
  tx = torch.from_numpy(x)
  out, z1, z2 = torso_cuda.torso_plain_residuals(*tw, tx)
  masks = [(t > 0).float() for t in (z1, z2, out.reshape(-1, 7, 7, 64))]
  torch.testing.assert_close(torso_cuda.torso_plain_masked(*tw, tx, masks),
                             out, rtol=0, atol=0)
