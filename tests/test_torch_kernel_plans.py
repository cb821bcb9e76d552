"""What the CPU can check of the K4a, K4c and K1 kernels' plans: the split
of D over blocks, that 3xTF32 products fit K4a's and K4c's tolerances at the
real widths, and K1's index handling at int64 against the JAX package.

The kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqn_zoo_tpu.replay import window_gather as jwg
from dqn_zoo_torch.nets import iqn_head
from dqn_zoo_torch.replay import window_gather as twg

D = 3136
CHUNKS = D // iqn_head.D_MULTIPLE


# --- K4a: D split over blocks --------------------------------------------------


@pytest.mark.parametrize("b,s", [(128, 64), (1024, 64), (1024, 128)])
def test_d_splits_is_one_where_the_row_tiles_fill_the_card(b, s):
  assert iqn_head.d_splits(b, s) == 1


def test_d_splits_fill_the_card_at_the_eval_shape():
  assert 128 <= 4 * iqn_head.d_splits(4, 64) <= iqn_head.SMS


@pytest.mark.parametrize("b,s", [(4, 64), (3, 24), (1, 1), (2, 8), (5, 512),
                                 (66, 64), (67, 64), (128, 64), (1024, 128)])
def test_d_splits_cover_d_once_in_whole_chunks(b, s):
  splits = iqn_head.d_splits(b, s, D)
  per = iqn_head.chunks_per_split(splits, D)
  # The kernel's split y walks chunks [y * per, min((y + 1) * per, CHUNKS)).
  runs = [range(y * per, min((y + 1) * per, CHUNKS)) for y in range(splits)]
  assert all(len(r) > 0 for r in runs)
  assert [c for r in runs for c in r] == list(range(CHUNKS))
  tiles = -(-b * s // iqn_head.ROWS_PER_BLOCK)
  assert tiles * splits <= max(tiles, iqn_head.SMS)


# --- K4a: 3xTF32 against the f32 tolerance -------------------------------------


def _tf32(x: torch.Tensor) -> torch.Tensor:
  """x rounded to TF32 (10 mantissa bits) to nearest, ties away from 0, as
  the kernel's cvt.rna.tf32.f32 does it."""
  bits = x.contiguous().view(torch.int32)
  return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """a @ b as the kernel takes it: small products first, then big x big."""
  ab, bb = _tf32(a), _tf32(b)
  a_small, b_small = _tf32(a - ab), _tf32(b - bb)
  return a_small @ bb + ab @ b_small + ab @ bb


def test_tf32_rounding_keeps_ten_mantissa_bits_to_nearest():
  one_ulp = 2.0**-10
  x = torch.tensor([1.0 + one_ulp / 2, 1.0 + one_ulp / 2 - 2.0**-23,
                    -(1.0 + one_ulp / 2), 3.0], dtype=torch.float32)
  want = torch.tensor([1.0 + one_ulp, 1.0, -(1.0 + one_ulp), 3.0])
  assert torch.equal(_tf32(x), want)


def test_3xtf32_fits_the_k4a_tolerance_and_one_tf32_product_does_not():
  """The kernel's two products at the real widths (64 rows, latent 64,
  D = 3136, H = 512), inputs as chip_smoke.py makes them: te and hi @ wh in
  3xTF32 stay within K4a's rtol 1e-4 / atol 1e-5 of the f32 chain; with a
  single TF32 product they do not."""
  rng = np.random.RandomState(0)
  n = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32))
  we, be = n(64, D) * 0.05, n(D) * 0.05
  wh, bh = n(D, 512) * 0.015, n(512) * 0.05
  cos, s_emb = n(64, 64), torch.relu(n(1, D))

  def h_of(product):
    hi = torch.relu(product(cos, we) + be) * s_emb
    return torch.relu(product(hi, wh) + bh)

  want = h_of(torch.matmul)
  torch.testing.assert_close(h_of(_3xtf32), want, rtol=1e-4, atol=1e-5)
  one_pass = h_of(lambda a, b: _tf32(a) @ _tf32(b))
  assert not torch.allclose(one_pass, want, rtol=1e-4, atol=1e-5)


# --- K4c: its three products in 3xTF32 against float64 ------------------------


def _k4c_outputs(product, we, be, wh, cos, s_emb, dh, s, mask):
  """K4c's arithmetic with its products (te_pre, dhi, dwe) taken by
  `product`; `mask` stands in for te_pre > 0, as the card checks hand the
  kernel's own bits to the plain version."""
  te_pre = product(cos, we) + be
  dhi = product(dh, wh.t())
  s_rows = s_emb.repeat_interleave(s, dim=0)
  dte = torch.where(mask, dhi * s_rows, torch.zeros_like(dhi))
  ds_emb = (dhi * torch.relu(te_pre)).reshape(-1, s, dhi.shape[1]).sum(1)
  return product(cos.t(), dte), dte.sum(0), ds_emb


def test_3xtf32_fits_the_k4c_tolerance_and_one_tf32_product_does_not():
  """K4c's products at the real widths (latent 64, D = 3136, H = 512) over
  1,024 rows, inputs as chip_smoke.py makes them: in 3xTF32 every output
  holds the card check's tolerance against float64 (relative Frobenius 1e-4;
  rtol 1e-4, atol 1e-5 x max|output|); with single TF32 products it does
  not."""
  rng = np.random.RandomState(1)
  n = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32))
  b, s = 16, 64
  we, be, wh = n(64, D) * 0.05, n(D) * 0.05, n(D, 512) * 0.015
  cos, s_emb = n(b * s, 64), torch.relu(n(b, D))
  dh = n(b * s, 512) * 0.05 * (n(b * s, 512) > 0)
  args64 = [x.double() for x in (we, be, wh, cos, s_emb, dh)]
  mask = (args64[3] @ args64[0] + args64[1]) > 0
  want = _k4c_outputs(torch.matmul, *args64, s, mask)

  def holds(got):
    for g, w in zip(got, want):
      g = g.double()
      if not (torch.linalg.vector_norm(g - w)
              <= 1e-4 * torch.linalg.vector_norm(w)):
        return False
      if not torch.allclose(g, w, rtol=1e-4, atol=1e-5 * float(w.abs().max())):
        return False
    return True

  args = (we, be, wh, cos, s_emb, dh)
  assert holds(_k4c_outputs(_3xtf32, *args, s, mask))
  assert not holds(_k4c_outputs(lambda x, y: _tf32(x) @ _tf32(y), *args, s,
                                mask))


# --- K1: int64 indices, as the replay's sample path hands them in ------------


def test_k1_wrapper_takes_int64_indices_like_the_jax_gather():
  rng = np.random.RandomState(3)
  s, r, b, window = 3, 12, 16, 5
  frames84 = rng.randint(0, 256, (s, r, 84, 84), np.uint8)
  stream = rng.randint(0, s, (b,)).astype(np.int64)
  start = rng.randint(0, r - window + 1, (b,)).astype(np.int64)
  stream[:3] = (-1, s + 2, -2 * s)
  start[3:6] = (-3, r, -r - 4)
  padded = jwg.pad_frames(jnp.asarray(frames84))
  want = np.asarray(jwg.unpad_frames(
      jwg.gather_windows_xla(padded, jnp.asarray(stream, jnp.int32),
                             jnp.asarray(start, jnp.int32), window), 84))
  st, sa = torch.from_numpy(stream), torch.from_numpy(start)
  got = twg.gather_windows(torch.from_numpy(frames84), st, sa, window)
  np.testing.assert_array_equal(got.numpy(), want)
  assert torch.equal(got, twg.gather_windows_plain(torch.from_numpy(frames84),
                                                   st.int(), sa.int(), window))
