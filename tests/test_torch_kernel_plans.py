"""What the CPU can check of the K4a, K4b, K4c and K1 kernels' plans: the
split of D over blocks, that 3xTF32 products fit K4a's, K4b's and K4c's
tolerances at the real widths, and K1's index handling at int64 against the
JAX package.

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


def _split(x: torch.Tensor):
  """x's big and small TF32 parts, as the kernels split it."""
  big = _tf32(x)
  return big, _tf32(x - big)


def _3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """a @ b as the kernel takes it: small products first, then big x big."""
  (ab, a_small), (bb, b_small) = _split(a), _split(b)
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


# --- K4b: te_pre and dwh in 3xTF32, in the kernel's order, against float64 --


def _trunc32(x: torch.Tensor) -> torch.Tensor:
  """float64 x to float32, rounded toward 0."""
  y = x.float()
  return torch.where(y.double().abs() > x.abs(),
                     torch.nextafter(y, torch.zeros_like(y)), y)


def _mma(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """One `mma.sync` as this plan models it: the products of TF32 operands
  exact, their sum added to the f32 accumulator c with truncation (the
  tensor cores round toward 0)."""
  return _trunc32(c.double() + a.double() @ b.double())


def _k4b_te_pre(cos, we, passes):
  """te_pre without its bias, as K4b takes it: 8 k-steps over latent 64,
  k-step 2p + h on latent 16p + 4t + 2h and + 1 (t = 0..3), even and odd
  k-steps in two accumulators; `passes` 3 (3xTF32, small products first) or
  1 (a single TF32 product)."""
  (cb, cs), (wb, ws) = _split(cos), _split(we)
  acc = [torch.zeros(cos.shape[0], we.shape[1]) for _ in range(2)]
  for kl in range(8):
    p, h = divmod(kl, 2)
    k = [16 * p + 4 * t + 2 * h + e for e in (0, 1) for t in range(4)]
    pairs = [(cs, wb), (cb, ws), (cb, wb)] if passes == 3 else [(cb, wb)]
    for x, w in pairs:
      acc[h] = _mma(acc[h], x[:, k], w[k])
  return acc[0] + acc[1]


def _k4b_dwh(hi, dh, passes, fold):
  """dwh = hi^T @ dh over k-steps of 8 rows, as K4b takes it: the products
  (3xTF32 or a single TF32 pass) go into a tile that a rounding f32 add
  folds into the accumulator every `fold` k-steps; with `fold` 0 the tile is
  never folded and is the accumulator."""
  (hb, hs), (db, ds) = _split(hi), _split(dh)
  pairs = [(hs, db), (hb, ds), (hb, db)] if passes == 3 else [(hb, db)]
  steps, chunk = hi.shape[0] // 8, 256
  acc = tile = torch.zeros(hi.shape[1], dh.shape[1])
  for k0 in range(0, steps, chunk):
    rows = slice(8 * k0, 8 * (k0 + chunk))
    prods = [x[rows].reshape(chunk, 8, -1).transpose(1, 2).double()
             @ w[rows].reshape(chunk, 8, -1).double() for x, w in pairs]
    for k in range(chunk):
      for p in prods:
        tile = _trunc32(tile.double() + p[k])
      if fold and (k0 + k + 1) % fold == 0:
        acc, tile = acc + tile, torch.zeros_like(tile)
  return acc if fold else tile


def _k4b_dbh(dh):
  """dbh as K4b sums it: lane t adds rows 2t and 2t + 1 of every k-step in
  row order, then the four lanes' sums are added (0 + 1) + (2 + 3)."""
  lanes = torch.zeros(4, dh.shape[1])
  for k in dh.reshape(-1, 4, 2, dh.shape[1]):
    lanes = lanes + k[:, 0]
    lanes = lanes + k[:, 1]
  return (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])


@pytest.fixture(scope="module")
def k4b_tile():
  """One block's tile at the real widths: 32 columns of D, latent 64, H =
  512, over a full row group of the learn shape (256 streams of 64 rows,
  16,384 rows, 2,048 k-steps of dwh), inputs as chip_smoke.py makes them;
  and the float64 te_pre, dwh, dbh."""
  rng = np.random.RandomState(2)
  n = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32))
  rows, s, dc = 16384, 64, 32
  we, be = n(64, dc) * 0.05, n(dc) * 0.05
  cos, s_rows = n(rows, 64), torch.relu(n(rows // s, dc)).repeat_interleave(
      s, dim=0)
  dh = n(rows, 512) * 0.05 * (n(rows, 512) > 0)
  te_pre = cos.double() @ we.double()
  hi = torch.relu(te_pre + be.double()) * s_rows.double()
  want = dict(te_pre=te_pre, dwh=hi.t() @ dh.double(), dbh=dh.double().sum(0))
  return (we, be, cos, s_rows, dh), want


def _k4b_outputs(we, be, cos, s_rows, dh, passes, fold=4):
  te_pre = _k4b_te_pre(cos, we, passes)
  hi = torch.relu(te_pre + be) * s_rows
  return dict(te_pre=te_pre, dwh=_k4b_dwh(hi, dh, passes, fold),
              dbh=_k4b_dbh(dh))


def _holds(got, want) -> bool:
  """chip_smoke.py's tolerance: relative Frobenius 1e-4 and rtol 1e-4, atol
  1e-5 x max|output|."""
  got = got.double()
  return bool(torch.linalg.vector_norm(got - want)
              <= 1e-4 * torch.linalg.vector_norm(want)) and torch.allclose(
                  got, want, rtol=1e-4, atol=1e-5 * float(want.abs().max()))


def test_3xtf32_fits_the_k4b_tolerance_and_one_tf32_product_does_not(
    k4b_tile):
  """K4b's te_pre^T and dwh products in 3xTF32, in the kernel's permuted
  k order and with dwh folded by a rounding add every 4 k-steps (kFold),
  hold the card check's tolerance against float64 over a full group of
  rows; with single TF32 products they do not."""
  args, want = k4b_tile
  got = _k4b_outputs(*args, passes=3)
  assert all(_holds(got[k], want[k]) for k in want)
  one_pass = _k4b_outputs(*args, passes=1)
  assert _holds(one_pass["dbh"], want["dbh"])  # no product
  assert not _holds(one_pass["te_pre"], want["te_pre"])
  assert not _holds(one_pass["dwh"], want["dwh"])


def test_k4b_dwh_needs_its_rounding_fold(k4b_tile):
  """With every product added straight into the accumulator, the tensor
  cores' truncation over 2,048 k-steps takes dwh past its elementwise
  tolerance (the card measured 2.6 times it, tools/torch_kernel_variants.py
  K4B), while a fold every k-step or every 4 k-steps keeps it within a tenth
  of it."""
  args, want = k4b_tile
  we, be, cos, s_rows, dh = args
  hi = torch.relu(_k4b_te_pre(cos, we, 3) + be) * s_rows
  for fold in (1, 4):
    got = _k4b_dwh(hi, dh, 3, fold).double()
    err = (got - want["dwh"]).abs()
    assert bool((err <= 0.1 * (1e-4 * want["dwh"].abs() + 1e-5 * float(
        want["dwh"].abs().max()))).all())
  assert not _holds(_k4b_dwh(hi, dh, 3, 0), want["dwh"])


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
