"""What the CPU can check of the K4a, K4b, K4c, K3, K2 and K1 kernels'
plans: the split of D over blocks, that 3xTF32 products fit K4a's, K4b's
and K4c's tolerances at the real widths, the bf16 kernels' grids, writes,
staged layouts and long sums read from their sources, K3's index maps,
K2's bands and its band-split algorithm against the plain version, and
K1's index handling at int64 against the JAX package.

The kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqn_zoo_tpu.replay import window_gather as jwg
from dqn_zoo_torch.nets import iqn_head
from dqn_zoo_torch.prep import atari as tprep
from dqn_zoo_torch.prep import cuda_prep
from dqn_zoo_torch.replay import window_gather as twg
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

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


# --- K3: the torso's layer routine, its index maps and its 3xTF32 sums ------

TORSO_CU = pathlib.Path(iqn_head.__file__).parent.parent / "csrc/dqn_torso.cu"


def _torso_layers():
  """The three `conv_layer` instantiations of csrc/dqn_torso.cu, in order:
  (input is uint8, KH, KW, S, CI, CO, W, OW, MT, stride of the reader of
  the output or 0)."""
  found = re.findall(r"conv_layer<(uint8_t|float), ([\d, ]+)>\(",
                     TORSO_CU.read_text())
  return [(kind == "uint8_t",) + tuple(int(v) for v in args.split(","))
          for kind, args in found]


def _swizzle(x, y, s):
  return ((x // s + y // s) & 1) << 2 if s else 0 * x


def _emulate_layer(layer, src, w, bias, scale):
  """One sample's `conv_layer` as its lanes run it, in float64: every
  address of every load and store as the kernel computes it, the mma's
  fragment layouts (A: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
  t + 4); B: b0 (t, g), b1 (t + 4, g); C: c0 (g, 2t), c1 (g, 2t + 1),
  c2 (g + 8, 2t), c3 (g + 8, 2t + 1)), exact products. `src` is the input
  as the kernel holds it in shared memory (uint8 pixels, or f32 swizzled
  for this layer's stride); returns the output as the kernel stores it,
  how often each element was stored, and the shared-memory bank conflicts
  of the A loads."""
  u8, kh, kw, s, ci, co, w_in, ow, mt, out_s = layer
  m_rows, r = ow * ow, kw * ci
  groups, slices = (-(-m_rows // 16) + mt - 1) // mt, co // 16
  g, t = np.arange(8)[:, None], np.arange(4)[None, :]  # lane 4g + t
  wf = w.reshape(-1)
  out = np.zeros(m_rows * co)
  writes = np.zeros(m_rows * co, np.int64)
  conflicts = 0
  for item in range(groups * slices):
    m0, n0 = item // slices * mt * 16, item % slices * 16
    rows = [[np.minimum(m0 + 16 * i + 8 * h + g, m_rows - 1)
             for h in (0, 1)] for i in range(mt)]
    acc = np.zeros((mt, 2, 16, 8))
    wl = 4 * t * co + n0 + 2 * g
    for ky in range(kh):
      for c in range(r // 16):
        a = np.zeros((mt, 2, 8, 4, 4))  # [i][h][g][t][element]
        for i in range(mt):
          for h in (0, 1):
            m = rows[i][h]
            base = s * (m // ow) * w_in + s * (m % ow)
            p = (base + ky * w_in) * ci + 4 * t
            if u8:
              addr = p + 16 * c
              a[i, h] = src[addr[..., None] + np.arange(4)] * scale
              words = np.broadcast_to(addr // 4, (8, 4)).reshape(-1)
              banks = words % 32
              conflicts += len(set(zip(words, banks))) - len(set(banks))
            else:
              odd = ((m % ow) + (m // ow) + ky // s) & 1
              kx, kq = 16 * c // ci, 16 * c % ci // 4
              f = ((kq >> 2) ^ (kx // s)) & 1
              addr = p + 16 * (f ^ odd) + kx * ci + 4 * (kq & ~4)
              a[i, h] = src[addr[..., None] + np.arange(4)]
              lanes = np.broadcast_to(addr, (8, 4)).reshape(-1)
              for q in range(4):  # a phase: 8 lanes, 16 bytes each
                ph = lanes[8 * q:8 * q + 8]
                groups16 = (ph // 4) % 8
                conflicts += len(set(ph)) - len(set(groups16))
        b = np.stack([wf[wl + (ky * r + 16 * c + j) * co + e]
                      for j in range(4) for e in (0, 1)]).reshape(4, 2, 8, 4)
        for sk in (0, 1):
          at = np.zeros((mt, 16, 8))
          for i in range(mt):
            at[i, :8, :4] = a[i, 0, :, :, 2 * sk]
            at[i, 8:, :4] = a[i, 1, :, :, 2 * sk]
            at[i, :8, 4:] = a[i, 0, :, :, 2 * sk + 1]
            at[i, 8:, 4:] = a[i, 1, :, :, 2 * sk + 1]
          bt = np.zeros((2, 8, 8))
          for j in (0, 1):
            bt[j, :4, :] = b[2 * sk, j].T  # b0 (k = t, n = g)
            bt[j, 4:, :] = b[2 * sk + 1, j].T
          for i in range(mt):
            for j in (0, 1):
              acc[i, j] += at[i] @ bt[j]
    for i in range(mt):
      for h in (0, 1):
        m = m0 + 16 * i + 8 * h + g
        frag = lambda j, e: acc[i, j][8 * h + g, 2 * t + e]  # c[2h + e]
        vals = np.stack([frag(0, 0), frag(1, 0), frag(0, 1), frag(1, 1)], -1)
        vals = np.maximum(vals + bias[(n0 + 4 * t)[..., None] + np.arange(4)],
                          0)
        q = (n0 >> 2) + t
        addr = m * co + ((q ^ _swizzle(m % ow, m // ow, out_s)) << 2)
        keep = np.broadcast_to(m < m_rows, (8, 4))
        for e in range(4):
          np.add.at(writes, (addr + e)[keep], 1)
          out[(addr + e)[keep]] = vals[..., e][keep]
  return out, writes, conflicts


def _unswizzle(z, w_in, c, s):
  """K3b's `copy_out`: a swizzled (W, W, C) activation to NHWC."""
  i = np.arange(w_in * w_in * c // 4)
  p, q = i // (c // 4), i % (c // 4)
  src = p * c + ((q ^ _swizzle(p % w_in, p // w_in, s)) << 2)
  return z[src[:, None] + np.arange(4)].reshape(w_in, w_in, c)


def _conv64(x, w, b, stride):
  """relu(conv(x, w) + b) in float64, NHWC and HWIO, VALID padding."""
  y = torch.nn.functional.conv2d(
      torch.from_numpy(x).permute(2, 0, 1)[None],
      torch.from_numpy(w).permute(3, 2, 0, 1), torch.from_numpy(b),
      stride=stride)
  return torch.relu(y)[0].permute(1, 2, 0).numpy()


def test_k3_layer_instantiations_chain_the_torso():
  layers = _torso_layers()
  assert [l[1:8] for l in layers] == [(8, 8, 4, 4, 32, 84, 20),
                                      (4, 4, 2, 32, 64, 20, 9),
                                      (3, 3, 1, 64, 64, 9, 7)]
  assert [l[0] for l in layers] == [True, False, False]
  # Each layer's output is swizzled for the stride of the layer that reads
  # it; the last goes to device memory unswizzled.
  assert [l[9] for l in layers] == [2, 1, 0]


@pytest.mark.parametrize("seed", [0, 1])
def test_k3_index_maps_compute_the_convolutions_exactly(seed):
  """The layer routine's index maps (row -> position with the padded rows
  clamped and masked, k = t, t + 4 of 4 consecutive elements, the column
  order, the swizzle of z1 and z2 and K3b's copies that undo it), emulated
  lane by lane in float64 on integer-valued data, give exactly F.conv2d's
  z1, z2 and output; every output element is stored once; the A loads of
  every layer are free of shared-memory bank conflicts."""
  rng = np.random.RandomState(seed)
  x = rng.randint(0, 256, (84, 84, 4)).astype(np.uint8)
  shapes = [(8, 8, 4, 32), (4, 4, 32, 64), (3, 3, 64, 64)]
  ws = [rng.randint(-2, 3, s).astype(np.float64) for s in shapes]
  bs = [rng.randint(-60, 61, s[-1]).astype(np.float64) for s in shapes]
  layers = _torso_layers()
  smem = x.reshape(-1).astype(np.float64)
  want = x.astype(np.float64)
  for n, (layer, w, b) in enumerate(zip(layers, ws, bs)):
    out, writes, conflicts = _emulate_layer(layer, smem, w, b, scale=1.0)
    assert (writes == 1).all()
    assert conflicts == 0, f"layer {n + 1}: {conflicts} bank conflicts"
    want = _conv64(want, w, b, layer[3])
    ow, co, out_s = layer[7], layer[5], layer[9]
    got = _unswizzle(out, ow, co, out_s)
    np.testing.assert_array_equal(got, want)
    assert (got > 0).mean() > 0.2  # the data exercises both ReLU branches
    smem = out


def _im2col(x, kh, kw, stride):
  """(B, H, W, C) -> (B * OH * OW, KH * KW * C), k in HWIO row order."""
  b, h, w, c = x.shape
  oh, ow = (h - kh) // stride + 1, (w - kw) // stride + 1
  p = x.unfold(1, kh, stride).unfold(2, kw, stride)  # (B, OH, OW, C, KH, KW)
  return p.permute(0, 1, 2, 4, 5, 3).reshape(b * oh * ow, kh * kw * c)


def _k3_layer_3xtf32(x, w, bias, stride, fold):
  """One layer as the kernel sums it: k-steps of 8 k (4 consecutive
  elements of a 16-k chunk taken as k = t, t + 4 of two k-steps), three
  TF32 products a k-step (small products first), each mma's sum added
  into its f32 accumulator with truncation; with `fold` each k-step's
  products go into a zeroed tile that a rounding f32 add folds in."""
  kh, kw, ci, co = w.shape
  b, ow = x.shape[0], (x.shape[1] - kh) // stride + 1
  (ab, a_s), (bb, b_s) = _split(_im2col(x, kh, kw, stride)), _split(
      w.reshape(-1, co))
  acc = torch.zeros(ab.shape[0], co)
  for k0 in range(0, kh * kw * ci, 16):
    for s in (0, 1):
      cols = [k0 + 4 * t + 2 * s + e for t in range(4) for e in (0, 1)]
      tile = torch.zeros_like(acc) if fold else acc
      for u, v in ((a_s, bb), (ab, b_s), (ab, bb)):
        tile = _mma(tile, u[:, cols], v[cols])
      acc = acc + tile if fold else tile
  return torch.relu(acc + bias).reshape(b, ow, ow, co)


def _k3_share(fold):
  """The largest error of z1, z2 and the output of the torso in 3xTF32
  (four samples, inputs and weights as chip_smoke.py makes them) against
  float64, as a share of rtol 1e-4, atol 1e-5."""
  rng = np.random.RandomState(4)
  x = torch.from_numpy(rng.randint(0, 256, (4, 84, 84, 4)).astype(np.uint8))
  shapes = [(8, 8, 4, 32), (4, 4, 32, 64), (3, 3, 64, 64)]
  ws = [torch.from_numpy(((rng.rand(*s) * 2 - 1) / np.sqrt(np.prod(s[:-1])))
                         .astype(np.float32)) for s in shapes]
  bs = [torch.from_numpy(((rng.rand(s[-1]) * 2 - 1) / 16).astype(np.float32))
        for s in shapes]
  h = x.to(torch.float32) * torch.tensor(1.0 / 255.0, dtype=torch.float32)
  h64 = x.double() / 255.0
  shares = []
  for w, b, stride in zip(ws, bs, (4, 2, 1)):
    h = _k3_layer_3xtf32(h, w, b, stride, fold)
    h64 = torch.relu(torch.nn.functional.conv2d(
        h64.permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1), b.double(),
        stride=stride)).permute(0, 2, 3, 1)
    shares.append(float(((h.double() - h64).abs()
                         / (1e-5 + 1e-4 * h64.abs())).max()))
  return shares


def test_k3_3xtf32_sums_fit_the_tolerance_without_a_fold():
  """Over the real k-depths (32, 64 and 72 k-steps in one accumulator) the
  tensor cores' truncating adds keep every layer within an eighth of the
  card check's rtol 1e-4 / atol 1e-5 without a fold (a fold every k-step:
  within a hundredth); the shares are printed (pytest -s)."""
  plain, folded = _k3_share(fold=False), _k3_share(fold=True)
  print(f"K3 3xTF32 error share of the tolerance (z1, z2, out): "
        f"no fold {plain}, fold every k-step {folded}")
  assert max(folded) < 0.05
  assert max(plain) < 0.25


# --- K2: the band plan, its shared memory, and the band-split algorithm ------

PREP_CU = pathlib.Path(iqn_head.__file__).parent.parent / \
    "csrc/pooled_frame_to_84.cu"
K2_BAND_ROWS = sorted({cuda_prep.BAND_ROWS - 1, cuda_prep.BAND_ROWS,
                       cuda_prep.BAND_ROWS + 1, 4, 12})


def _k2_tables(p):
  """(spans (bands, 2), Ry's (84, 2) and Cx's (84, 2) first tap and count,
  Ry's and Cx's weights (TAPS, 84)) of a plan, as the kernel reads them."""
  spans = p.plan[:2 * p.bands].reshape(p.bands, 2)
  ry, cx = p.plan[2 * p.bands:].reshape(2, 84, cuda_prep.REC)
  weights = lambda rec: np.ascontiguousarray(rec[:, 2:]).view(np.float32).T
  return spans, ry[:, :2], cx[:, :2], weights(ry), weights(cx)


def _k2_band_rows(band, band_rows):
  """The output rows block `band` writes (the kernel's i0 and nr)."""
  i0 = band * band_rows
  return range(i0, i0 + min(band_rows, 84 - i0))


@pytest.mark.parametrize("band_rows", K2_BAND_ROWS)
def test_k2_bands_write_each_row_once_and_load_every_tap(band_rows):
  p = cuda_prep.band_plan(band_rows)
  spans, ry, cx, wy, wx = _k2_tables(p)
  assert p.bands == -(-84 // band_rows)  # the launcher's check
  assert p.plan.dtype == np.int32 and p.plan.size == 2 * p.bands + 168 * 7
  written = [i for k in range(p.bands) for i in _k2_band_rows(k, band_rows)]
  assert sorted(written) == list(range(84))
  full_ry = tprep.resize_weights(210, 84)
  for k, (y0, rows) in enumerate(spans):
    assert 0 <= y0 and y0 + rows <= 210 and rows <= p.max_rows
    for i in _k2_band_rows(k, band_rows):
      nz = np.nonzero(full_ry[i])[0]
      # Every nonzero tap of the row lies in the band's loaded rows, and the
      # tap run the kernel walks is the row's nonzero run.
      assert y0 <= nz[0] and nz[-1] < y0 + rows
      assert (ry[i, 0], ry[i, 1]) == (nz[0], nz[-1] + 1 - nz[0])
      np.testing.assert_array_equal(wy[:ry[i, 1], i],
                                    full_ry[i, nz[0]:nz[-1] + 1])
  full_cx = tprep.resize_weights(160, 84)
  for j, (lo, n) in enumerate(cx):
    nz = np.nonzero(full_cx[j])[0]
    assert (lo, n) == (nz[0], nz[-1] + 1 - nz[0]) and lo + n <= 160
    np.testing.assert_array_equal(wx[:n, j], full_cx[j, lo:lo + n])


def test_k2_shared_memory_fits_without_an_opt_in():
  """The main path's band size and its neighbours take under 48 KB a block
  (no opt-in, several blocks an SM); the kernel's own formula, read from its
  source, is the wrapper's."""
  body = re.search(r"constexpr int smem_bytes\(int max_rows\) "
                   r"\{.*?return ([^;]+);", PREP_CU.read_text(), re.S).group(1)
  for band_rows in K2_BAND_ROWS:
    p = cuda_prep.band_plan(band_rows)
    from_source = eval(body, dict(kRowBytes=480, kW=160, max_rows=p.max_rows))
    assert from_source == cuda_prep.smem_bytes(p.max_rows)
    assert from_source <= cuda_prep.SMEM_LIMIT
    if abs(band_rows - cuda_prep.BAND_ROWS) <= 1:
      assert from_source < 48 * 1024
    # Once luma is done, the band's f32 vertical sums fit in the first
    # frame's rows and the tap records it stages in the second's (at most
    # 3 words a thread).
    assert band_rows * 160 * 4 <= p.max_rows * 480
    stage = (band_rows + 84) * cuda_prep.REC
    assert 4 * stage <= p.max_rows * 480 and stage <= 3 * 256
  main = cuda_prep.band_plan()
  assert (main.bands, main.max_rows) == (14, 17)
  assert cuda_prep.smem_bytes(main.max_rows) == 27200


def _fmaf(a, b, c):
  """fmaf(a, b, c) of float32 tensors, rounded once as the card rounds it:
  the product is exact in float64, the sum is rounded there to odd (53 >=
  24 + 2 bits), and that rounds to the float32 nearest the exact sum."""
  p = a.double() * b.double()
  c = c.double()
  s = p + c
  v = s - p
  err = (p - (s - v)) + (c - v)  # s + err is exactly p + c
  even = (s.view(torch.int64) & 1) == 0
  toward = torch.where(err > 0, torch.inf, -torch.inf).double()
  return torch.where((err != 0) & even, torch.nextafter(s, toward), s).float()


def test_fmaf_emulation_rounds_once():
  a = torch.tensor([1.0 + 2.0 ** -12], dtype=torch.float32)
  c = torch.tensor([-1.0 - 2.0 ** -11], dtype=torch.float32)
  # a * a + c = 2^-24 exactly: two roundings would lose it.
  assert float(_fmaf(a, a, c)) == 2.0 ** -24
  x = torch.tensor([3.0, 0.1], dtype=torch.float32)
  assert torch.equal(_fmaf(x, x, x), (x.double() * x + x).float())


def _k2_band_split(f1, f2, band_rows):
  """The kernel's algorithm in torch: each band pools and lumas only the
  input rows it loads, then sums its output rows' taps as fmaf chains."""
  p = cuda_prep.band_plan(band_rows)
  spans, ry, cx, wy, wx = (torch.from_numpy(t) for t in _k2_tables(p))
  w = torch.tensor(tprep.RGB2Y_WEIGHTS, dtype=torch.float32)
  out = torch.empty((f1.shape[0], 84, 84), dtype=torch.uint8)
  for k, (y0, rows) in enumerate(spans.tolist()):
    pooled = torch.maximum(f1[:, y0:y0 + rows], f2[:, y0:y0 + rows]).float()
    y = pooled[..., 0] * w[0] + pooled[..., 1] * w[1] + pooled[..., 2] * w[2]
    y = torch.clamp(torch.floor(y), max=255.0)
    for i in _k2_band_rows(k, band_rows):
      lo, n = int(ry[i, 0]) - y0, int(ry[i, 1])
      assert 0 <= lo and lo + n <= rows
      v = torch.zeros((f1.shape[0], 160))
      for t in range(n):
        v = _fmaf(wy[t, i].expand_as(v), y[:, lo + t], v)
      acc = torch.zeros((f1.shape[0], 84))
      for t in range(cuda_prep.TAPS):
        live = t < cx[:, 1]
        col = torch.clamp(cx[:, 0] + t, max=159)
        acc = torch.where(live, _fmaf(v[:, col], wx[t].expand_as(acc), acc),
                          acc)
      out[:, i] = torch.clamp(torch.round(acc), 0, 255).to(torch.uint8)
  return out


@pytest.mark.parametrize("band_rows", [cuda_prep.BAND_ROWS, 4, 12])
def test_k2_band_split_equals_the_plain_version(band_rows):
  rng = np.random.RandomState(11)
  f1 = rng.randint(0, 256, (3, 210, 160, 3), np.uint8)
  f2 = rng.randint(0, 256, (3, 210, 160, 3), np.uint8)
  f1[0] = 0  # the zero penultimate frame of an episode's first step
  f1[2, 100:] = f2[2, 100:] = 0  # a black lower half
  f1, f2 = torch.from_numpy(f1), torch.from_numpy(f2)
  got = _k2_band_split(f1, f2, band_rows)
  assert torch.equal(got, tprep.pooled_frame_to_84_plain(f1, f2))
  assert torch.equal(got, cuda_prep.pooled_frame_to_84(f1, f2))


# --- K4b and K4c in bf16 mode: their plan, read from their source -----------

BF16_CU = pathlib.Path(iqn_head.__file__).parent.parent / \
    "csrc/iqn_head_bwd_bf16.cu"
# (B, S): the learn shape, the act shape, a small one and a ragged one (S
# not a multiple of 64, so streams straddle the 64-row chunks).
BF16_SHAPES = [(1024, 64), (128, 64), (4, 64), (3, 24)]


def _bf16_consts():
  """csrc/iqn_head_bwd_bf16.cu's `constexpr int` constants, evaluated in
  their order (integer division as C's, all operands positive)."""
  consts = {}
  for name, expr in re.findall(r"constexpr int (\w+)\s*=\s*([^;]+);",
                               BF16_CU.read_text()):
    consts[name] = eval(" ".join(expr.split()).replace("/", "//"), {},
                        dict(consts))
  return consts


def test_bf16_tiles_and_limits_are_the_sources():
  c = _bf16_consts()
  assert (c["kBD"], c["kCD"], c["kBH"], c["kRC"], c["kL"], c["kH"]) == (
      iqn_head.BF16_TILE_D, iqn_head.BF16_TILE_D, iqn_head.BF16_TILE_H,
      iqn_head.BF16_CHUNK, iqn_head.LATENT, iqn_head.HIDDEN)
  assert c["kThreads"] == 256 and c["kKChunks"] * c["kKC"] == c["kH"]
  # Shared memory a block: K4b 177 KB and K4c 227 KB (1 KB of each to
  # align the tiles to the 1024 bytes wgmma's swizzle wants), within the
  # H100's 232,448 bytes a block.
  assert c["kSmemW"] == 181248 and c["kSmemD"] == 232448
  # K4b's dh stage is 4 blocks of 64 columns x 64 rows of 128 bytes, the
  # wgmma descriptors' 8-row atoms 1024 bytes apart and column blocks
  # kRC * 128 apart.
  assert c["kDhStageB"] == 4 * c["kRC"] * 128 and c["kDhStageB"] % 1024 == 0
  assert c["kCosStageB"] % 1024 == 0 and c["kWeTB"] % 1024 == 0
  assert max(c["kSmemW"], c["kSmemD"]) <= 232448
  # Each ring stage holds whole 16-byte pieces in rows of a multiple of 128
  # bytes (the XOR swizzle permutes the 8 pieces of each 128 bytes).
  for row_bytes in (c["kDhRowB"], c["kCosRowB"], c["kWhRowB"],
                    c["kRingRowB"], c["kDteRowB"]):
    assert row_bytes % 128 == 0


def _groups(units, groups):
  """The kernels' group_begin: group g's units [g n / G, (g + 1) n / G)."""
  return [(g * units // groups, (g + 1) * units // groups)
          for g in range(groups)]


@pytest.mark.parametrize("b,s", BF16_SHAPES)
def test_bf16_grids_cover_rows_and_columns_once(b, s):
  """K4b's groups of whole 64-row chunks and K4c's of whole streams cut the
  rows into non-empty runs, each row in one; the D tiles of 128 columns
  (the last ragged) and K4b's two H tiles cover every column once."""
  rows, c = b * s, _bf16_consts()
  chunks = -(-rows // c["kRC"])
  gw, gd = iqn_head.bf16_groups_w(b, s, D), iqn_head.bf16_groups_d(b, s, D)
  runs = _groups(chunks, gw)
  assert all(hi > lo for lo, hi in runs)
  covered = [r for lo, hi in runs
             for r in range(lo * c["kRC"], min(hi * c["kRC"], rows))]
  assert covered == list(range(rows))
  streams = _groups(b, gd)
  assert all(hi > lo for lo, hi in streams)
  assert [st for lo, hi in streams for st in range(lo, hi)] == list(range(b))
  tiles = iqn_head.bf16_tiles_d(D)
  cols = [x * c["kBD"] + j for x in range(tiles) for j in range(c["kBD"])
          if x * c["kBD"] + j < D]
  assert cols == list(range(D)) and tiles * c["kBD"] - D < c["kBD"]
  assert [y * c["kBH"] + j for y in range(c["kH"] // c["kBH"])
          for j in range(c["kBH"])] == list(range(c["kH"]))


def test_bf16_learn_grids_fill_the_card():
  """At the learn shape both grids give every one of the 132 SMs a block and
  lose little to the last wave: K4b 25 x 2 x 5 = 250 blocks, K4c 25 x 10 =
  250, two waves each."""
  b, s = 1024, 64
  tiles = iqn_head.bf16_tiles_d(D)
  w = tiles * 2 * iqn_head.bf16_groups_w(b, s, D)
  d = tiles * iqn_head.bf16_groups_d(b, s, D)
  assert (tiles, w, d) == (25, 250, 250)
  # The last D tile is half a tile: 49.5 tiles' work in 25 tiles' blocks.
  for blocks in (w, d):
    waves = -(-blocks // iqn_head.SMS)
    assert blocks >= iqn_head.SMS
    assert blocks * 49.5 / 50 / (waves * iqn_head.SMS) > 0.9


def _lane_tile(rows_per_warp_tile, cols_per_warp_tile):
  """(row, column) of accumulator (i, j, e) of every lane (g, t) of a warp
  whose tile is rows_per_warp_tile x cols_per_warp_tile in m16n8 tiles:
  row 16 i + g + 8 (e >> 1), column 8 j + 2 t + (e & 1) (mma.sync's C
  fragments, and wgmma's for the warp's 16 rows of its warpgroup)."""
  g, t = np.arange(8)[:, None], np.arange(4)[None, :]
  out = []
  for i in range(rows_per_warp_tile // 16):
    for j in range(cols_per_warp_tile // 8):
      for e in range(4):
        out.append(((16 * i + g + 8 * (e >> 1)) * np.ones_like(t),
                    (8 * j + 2 * t + (e & 1)) * np.ones_like(g)))
  return out


def test_bf16_warp_tiles_cover_a_block_tile_once():
  """Every element of a K4b block's 128 x 256 tile of dwh (two warpgroups'
  wgmma of 64 x 256, warp w rows 16 w .. + 15), of a K4c block's 64 x 128
  chunk of te_pre and dhi (two warpgroups' wgmma of 64 x 64, one a column
  half, warp w rows 16 (w & 3) .. + 15), of its 64 x 128 tile of dwe
  (mma.sync, warps 2 x 4 of 32 x 32), and of the 64 x 64 dcos part of a
  chunk (warps 4 x 2 of 16 x 32) is held by exactly one accumulator of one
  lane of one warp."""
  plans = (((16, 256), (128, 256), lambda w: (16 * w, 0)),
           ((16, 64), (64, 128), lambda w: (16 * (w & 3), 64 * (w >> 2))),
           ((32, 32), (64, 128), lambda w: (32 * (w >> 2), 32 * (w & 3))),
           ((16, 32), (64, 64), lambda w: (16 * (w & 3), 32 * (w >> 2))))
  for (wr, wc), (tr, tc), origin in plans:
    count = np.zeros((tr, tc), np.int64)
    for warp in range(8):
      r0, c0 = origin(warp)
      for r, col in _lane_tile(wr, wc):
        np.add.at(count, (r0 + r, c0 + col), 1)
    assert (count == 1).all()


def _k4c_ds_emb(b, s, groups, rc=64):
  """K4c's ds_emb walk, one column, with g = row + 1 (sums exact): per
  group, per 64-row chunk, the 4 row slices of 16. Where the chunk is one
  stream, each slice's sum (slice 0's after the one handed on from the
  last chunk) goes to hand[slice], and the four are added in slice order
  after the barrier; else the slices run in order, each stream's sum handed
  on through hand[slice + 1] (hand[0] after the last slice) when it runs on
  past a slice's rows. Returns {stream: (writes, value)} and whether a
  hand-on value was read before it was written."""
  out, stale = {}, False

  def record(st, x):
    n, _ = out.get(st, (0, 0))
    out[st] = (n + 1, x)

  def rows_sum(w0, a, e, end):
    return sum(r + 1 for r in range(w0, w0 + 16) if a <= r < min(e, end))

  for lo, hi in _groups(b, groups):
    row_lo, end = lo * s, hi * s
    hand = [None] * 4
    for r0 in range(row_lo, end, rc):
      st0 = min(r0 // s, b - 1)
      if st0 == min((r0 + rc - 1) // s, b - 1):
        a, e = st0 * s, st0 * s + s
        for sl in range(4):
          x = rows_sum(r0 + 16 * sl, a, e, end)
          if sl == 0 and a < r0:
            stale |= hand[0] is None
            x = (hand[0] or 0) + x
          hand[sl] = x
        x = ((hand[0] + hand[1]) + hand[2]) + hand[3]
        hand = [x if e > r0 + rc else None] + [None] * 3
        if e <= r0 + rc:
          record(st0, x)
        continue
      for sl in range(4):
        w0 = r0 + 16 * sl
        w1 = min(w0 + 16, end)
        src, dst = (0 if sl == 0 else sl), (0 if sl == 3 else sl + 1)
        for st in range(w0 // s, (w1 - 1) // s + 1) if w0 < w1 else ():
          a, e = st * s, st * s + s
          x = rows_sum(w0, a, e, end)
          if a < w0:
            stale |= hand[src] is None
            x = (hand[src] or 0) + x
            hand[src] = None  # read once
          if e > w1:
            hand[dst] = x
          else:
            record(st, x)
  return out, stale


@pytest.mark.parametrize("b,s", BF16_SHAPES + [(2, 1), (5, 96), (2, 200),
                                               (3, 8)])
def test_bf16_ds_emb_walk_sums_each_stream_once(b, s):
  groups = iqn_head.bf16_groups_d(b, s, D)
  out, stale = _k4c_ds_emb(b, s, groups)
  assert not stale
  assert sorted(out) == list(range(b))
  for st, (writes, value) in out.items():
    assert writes == 1
    assert value == sum(r + 1 for r in range(st * s, st * s + s))


def _mma16(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """One bf16 `mma.sync.m16n8k16` as this plan models it (batched over
  k-steps by the caller): bf16 x bf16 products exact, their sum added to
  the f32 accumulator with truncation."""
  return _trunc32(c.double() + a.double() @ b.double())


def _bf16(x: torch.Tensor) -> torch.Tensor:
  return x.to(torch.bfloat16).float()


def _k_order_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """a @ b (k = a's columns, b's rows, a multiple of 16) as one
  accumulator of the bf16 kernels sums it: 16 k a step, in k order, each
  step's exact products added with truncation."""
  acc = torch.zeros(a.shape[0], b.shape[1])
  steps = a.shape[1] // 16
  prods = (a.reshape(a.shape[0], steps, 16).permute(1, 0, 2).double()
           @ b.reshape(steps, 16, b.shape[1]).double())
  for k in range(steps):
    acc = _trunc32(acc.double() + prods[k])
  return acc


def test_bf16_products_fit_the_card_check_without_a_fold():
  """The bf16 kernels' long sums, emulated in their k order with the tensor
  cores' truncating adds and no rounding fold (the source has none): K4b's
  dwh over a whole row group of the learn shape (205 chunks, 13,120 rows,
  820 k-steps) for one 32-column slice of D, K4c's dhi (32 k-steps over H)
  and dwe over its row group (103 chunks, 6,592 rows), each within a fifth
  of the card check's 1e-4 relative Frobenius error against float64 sums of
  the same bf16 operands; dwh's truncation error is printed (pytest -s)."""
  assert "kFold" not in BF16_CU.read_text()
  rng = np.random.RandomState(5)
  n = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32))
  dc, s = 32, 64
  rows_w = -(-1024 // iqn_head.bf16_groups_w(1024, s, D)) * 64
  rows_d = -(-1024 // iqn_head.bf16_groups_d(1024, s, D)) * s
  assert (rows_w, rows_d) == (13120, 6592)
  we, be, wh = n(64, dc) * 0.05, n(dc) * 0.05, n(dc, 512) * 0.015
  cos = n(rows_w, 64)
  s_rows = torch.relu(n(rows_w // s + 1, dc)).repeat_interleave(s, 0)[:rows_w]
  dh = n(rows_w, 512) * 0.05 * (n(rows_w, 512) > 0)
  rel = lambda got, want: float(torch.linalg.vector_norm(got.double() - want)
                                / torch.linalg.vector_norm(want))
  hi = _bf16((torch.relu(_k_order_sum(_bf16(cos), _bf16(we)) + be)
              * s_rows))
  dwh = _k_order_sum(hi.t().contiguous(), _bf16(dh))
  dwh_err = rel(dwh, hi.double().t() @ _bf16(dh).double())
  print(f"bf16 dwh over {rows_w} rows, no fold: relative Frobenius "
        f"{dwh_err:.3e}")
  assert dwh_err <= 2e-5
  r = slice(0, rows_d)
  dhi = _k_order_sum(_bf16(dh[r]), _bf16(wh).t().contiguous())
  assert rel(dhi, _bf16(dh[r]).double() @ _bf16(wh).double().t()) <= 2e-5
  dte = _bf16(dhi * s_rows[r])
  dwe = _k_order_sum(_bf16(cos[r]).t().contiguous(), dte)
  assert rel(dwe, _bf16(cos[r]).double().t() @ dte.double()) <= 2e-5


def test_staging_plain_rounds_as_jax_and_sums_dbh():
  """The staging pass's plain version: its bf16 copies of dh, cos, we
  (transposed) and wh equal JAX's astype(bfloat16) bit for bit, ties to
  even, ±0, subnormals, ±inf and overflow included; its dbh equals
  jnp.sum(dh, axis=0) within rtol 1e-5, atol 1e-6 x max|dbh| (f32 sums in
  other orders); the wrapper takes it for CPU tensors."""
  rng = np.random.RandomState(6)
  b, s, d = 3, 24, 64
  special = np.array([0x3F808000, 0x3F818000, 0x3F80FFFF, 0x3F808001,
                      0x80000000, 0x00000000, 0x00000001, 0x807FFFFF,
                      0x00008000, 0x00018000, 0x7F800000, 0xFF800000,
                      0x7F7FFFFF, 0x7F7F7FFF, 0xBF808000, 0x80018000],
                     dtype=np.uint32).view(np.float32)
  arrays = dict(we=rng.randn(64, d), cos=rng.randn(b, s, 64),
                dh=rng.randn(b * s, 512) * 0.05, wh=rng.randn(d, 512))
  arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
  for k in ("we", "cos", "wh"):
    arrays[k].reshape(-1)[:16] = special
  t = {k: torch.from_numpy(v) for k, v in arrays.items()}
  got = iqn_head.iqn_head_stage_bf16(t["we"], t["cos"], t["dh"], t["wh"])
  bits = lambda x: np.asarray(x.astype(jnp.bfloat16)).view(np.uint16)
  want = dict(dh=bits(jnp.asarray(arrays["dh"])),
              cos=bits(jnp.asarray(arrays["cos"]).reshape(b * s, 64)),
              we_t=bits(jnp.asarray(arrays["we"]).T),
              wh=bits(jnp.asarray(arrays["wh"])))
  for name, w in want.items():
    g = getattr(got, name)
    assert g.dtype == torch.bfloat16
    np.testing.assert_array_equal(g.view(torch.int16).numpy().view(np.uint16),
                                  w)
  want_dbh = np.asarray(jnp.sum(jnp.asarray(arrays["dh"]), axis=0))
  np.testing.assert_allclose(got.dbh.numpy(), want_dbh, rtol=1e-5,
                             atol=1e-6 * np.abs(want_dbh).max())
  assert iqn_head.iqn_head_stage_bf16(t["we"], t["cos"], t["dh"]).wh is None


# --- K4a in bf16 mode: its plan, read from its source ------------------------

FWD_BF16_CU = pathlib.Path(iqn_head.__file__).parent.parent / \
    "csrc/iqn_head_bf16.cu"
# (B, S, A): the target and online shapes of the learn step, the act shape,
# eval (D split over blocks) and a ragged one (72 rows in a block of 128,
# streams of 24 rows, A = 18).
FWD_BF16_SHAPES = [(1024, 128, 6), (1024, 64, 6), (128, 64, 6), (4, 64, 6),
                   (3, 24, 18)]


def _fwd_bf16_consts():
  """csrc/iqn_head_bf16.cu's `constexpr int` constants, evaluated in their
  order (integer division as C's, all operands positive)."""
  consts = {}
  for name, expr in re.findall(r"constexpr int (\w+)\s*=\s*([^;]+);",
                               FWD_BF16_CU.read_text()):
    consts[name] = eval(" ".join(expr.split()).replace("/", "//"), {},
                        dict(consts))
  return consts


def test_k4a_bf16_tiles_and_limits_are_the_sources():
  """The wrapper's constants are the source's; a block takes at most the
  H100's 232,448 bytes of shared memory; the ring's stages and the wgmma
  tiles in them start on 1024-byte boundaries (the 128-byte swizzle's
  atoms), and the staged image of a chunk is the stage's bytes."""
  c = _fwd_bf16_consts()
  assert (c["kM"], c["kBH"], c["kKC"], c["kChunkB"], c["kL"], c["kH"]) == (
      iqn_head.BF16_FWD_ROWS, iqn_head.BF16_TILE_H, iqn_head.BF16_FWD_CHUNK,
      iqn_head.BF16_FWD_CHUNK_BYTES, iqn_head.LATENT, iqn_head.HIDDEN)
  assert c["kThreads"] == 256 and c["kM"] == 2 * 64  # a warpgroup's 64 rows
  assert c["kSmem"] <= 232448
  # 1 KB to align, the cosine tile, the stages, the epilogue's wo and bh
  # halves, an mbarrier a stage.
  assert c["kSmem"] == 1024 + c["kCosB"] + c["kStages"] * c["kStageB"] + \
      c["kWoB"] + c["kBhB"] + 8 * c["kStages"]
  assert (c["kWoB"] + c["kBhB"]) % 8 == 0  # the mbarriers' alignment
  # The epilogue's B fragment loads (output 8 nt + g, columns 2 t ..) fall
  # on 32 distinct banks.
  g, t = np.meshgrid(np.arange(8), np.arange(4), indexing="ij")
  assert len(set(((g * c["kWoS"] * 2 + 4 * t) // 4 % 32).ravel())) == 32
  assert c["kStageB"] % 1024 == 0 and c["kCosB"] % 1024 == 0
  assert c["kWhHalfB"] % 1024 == 0  # we^T follows the wh half
  assert c["kWhHalfB"] + c["kWeB"] + c["kBeB"] + 2 * c["kSembB"] <= \
      c["kStageB"]
  # One chunk: wh's two column halves (4 blocks of 64 columns x 64 rows of
  # 128 bytes each), we^T (64 rows of 128 bytes) and be, 16-byte multiples
  # for the bulk copies.
  assert c["kWhHalfB"] == 4 * c["kKC"] * 128 and c["kWeB"] == c["kKC"] * 128
  assert c["kChunkB"] == 2 * c["kWhHalfB"] + c["kWeB"] + c["kBeB"]
  assert all(c[k] % 16 == 0 for k in ("kWhHalfB", "kWeB", "kBeB", "kSembB",
                                      "kChunkB"))


def _fwd_bf16_lanes():
  """(row, column) in a block's 128 x 256 tile of every accumulator (j, e)
  of every lane (g, t) of every warp: warpgroup wg = warp / 4 takes rows
  64 wg .., warp wl = warp % 4 of it rows 16 wl + g (+ 8), column 8 j + 2 t
  (+ 1) (wgmma m64n256's accumulator layout, the kernel's r_a, r_b, col0)."""
  warp, g, t, j, e = np.meshgrid(np.arange(8), np.arange(8), np.arange(4),
                                 np.arange(32), np.arange(4), indexing="ij")
  rows = 64 * (warp >> 2) + 16 * (warp & 3) + g + 8 * (e >> 1)
  return rows.ravel(), (8 * j + 2 * t + (e & 1)).ravel()


def _fwd_bf16_q_lanes(a, kqt):
  """(row, output) of every q value a block's epilogue writes: per pass of
  kqt tiles of 8 outputs, lane (g, t)'s mma.sync C fragment of tile nt:
  rows r_a, r_b, outputs o0 + 8 nt + 2 t (+ 1)."""
  out = []
  for o0 in range(0, a, 8 * kqt):
    warp, g, t, nt, e = np.meshgrid(np.arange(8), np.arange(8), np.arange(4),
                                    np.arange(kqt), np.arange(4),
                                    indexing="ij")
    rows = 64 * (warp >> 2) + 16 * (warp & 3) + g + 8 * (e >> 1)
    outs = o0 + 8 * nt + 2 * t + (e & 1)
    out.append((rows.ravel(), outs.ravel()))
  return (np.concatenate([r for r, _ in out]),
          np.concatenate([o for _, o in out]))


@pytest.mark.parametrize("b,s,a", FWD_BF16_SHAPES)
def test_k4a_bf16_writes_every_output_once(b, s, a):
  """Over the grid (row tiles of 128, 2 halves of H, splits), every chunk
  of D is walked by one split, and every element of h (or of each split's
  partial of h_pre) and of each half's partial of q is written by exactly
  one lane of one block; the second kernel then writes each row of h and q
  once (one block a row, 4 columns a thread: q_halves one element a
  thread)."""
  c = _fwd_bf16_consts()
  rows = b * s
  tiles = -(-rows // c["kM"])
  halves = c["kH"] // c["kBH"]
  splits = iqn_head.bf16_fwd_splits(b, s, D)
  per = iqn_head.bf16_fwd_chunks_per_split(splits, D)
  nchunks = -(-D // c["kKC"])
  runs = [range(z * per, min((z + 1) * per, nchunks)) for z in range(splits)]
  assert all(len(r) > 0 for r in runs)
  assert [k for r in runs for k in r] == list(range(nchunks))
  lr, lc = _fwd_bf16_lanes()
  h = np.zeros((rows, c["kH"]), np.int64)
  for x in range(tiles):
    for y in range(halves):
      r, col = x * c["kM"] + lr, y * c["kBH"] + lc
      keep = r < rows
      np.add.at(h, (r[keep], col[keep]), 1)
  # One split: h itself; more: each split's raw partial, the same pattern.
  assert (h == 1).all()
  if splits == 1:
    qr, qo = _fwd_bf16_q_lanes(a, c["kQT"])
    qp = np.zeros((halves, rows, a), np.int64)
    for x in range(tiles):
      for y in range(halves):
        r = x * c["kM"] + qr
        keep = (r < rows) & (qo < a)
        np.add.at(qp[y], (r[keep], qo[keep]), 1)
    assert (qp == 1).all()
  else:
    assert c["kFinThreads"] * 4 == c["kH"]


def test_k4a_bf16_grids_fill_the_card_and_eval_still_splits():
  """The learn shapes give every one of the 132 SMs a block with little
  lost to the last wave (2,048 and 1,024 blocks); the act shape's 64 row
  tiles x 2 halves are 128 blocks, one wave on 128 of the 132 SMs, where a
  split of D would double the blocks and add a partials pass for 4 SMs;
  eval (B = 4) and the ragged shape split D to 100 and 98 blocks."""
  def blocks(b, s):
    tiles = -(-b * s // iqn_head.BF16_FWD_ROWS) * (
        iqn_head.HIDDEN // iqn_head.BF16_TILE_H)
    return tiles * iqn_head.bf16_fwd_splits(b, s, D)
  for b, s in ((1024, 128), (1024, 64)):
    n = blocks(b, s)
    assert iqn_head.bf16_fwd_splits(b, s, D) == 1 and n >= iqn_head.SMS
    assert n / (-(-n // iqn_head.SMS) * iqn_head.SMS) > 0.9
  assert iqn_head.bf16_fwd_splits(128, 64, D) == 1 and blocks(128, 64) == 128
  for b, s in ((4, 64), (3, 24)):
    assert iqn_head.bf16_fwd_splits(b, s, D) > 1
    assert 0.7 * iqn_head.SMS <= blocks(b, s) <= iqn_head.SMS
  assert (blocks(4, 64), blocks(3, 24)) == (100, 98)


def _unstage_fwd(img, d):
  """The bf16 bits of wh (D, 512) and we^T (D, 64) and the f32 be (D) a
  staged image holds (iqn_head_stage_fwd_bf16's layout undone), and
  whether its rows past D are zero."""
  c = img.shape[0]
  r = np.arange(64)[:, None]
  unswz = np.arange(8)[None, :] ^ (r & 7)  # position of logical piece p
  wh = img[:, :65536].copy().view(np.uint16).reshape(c, 2, 4, 64, 8, 8)
  wh = np.take_along_axis(wh, np.broadcast_to(
      unswz[None, None, None, :, :, None], wh.shape), axis=4)
  wh = wh.transpose(0, 3, 1, 2, 4, 5).reshape(c * 64, 512)
  wet = img[:, 65536:73728].copy().view(np.uint16).reshape(c, 64, 8, 8)
  wet = np.take_along_axis(wet, np.broadcast_to(
      unswz[None, :, :, None], wet.shape), axis=2).reshape(c * 64, 64)
  be = img[:, 73728:].copy().view(np.float32).reshape(-1)
  pad_zero = not (wh[d:].any() or wet[d:].any() or be[d:].any())
  return wh[:d], wet[:d], be[:d], pad_zero


@pytest.mark.parametrize("d", [D, 96])
def test_k4a_staging_plain_rounds_as_jax(d):
  """K4a's staging pass's plain version: its bf16 wh and we^T equal JAX's
  astype(bfloat16) bit for bit (ties to even, ±0, subnormals, ±inf and
  overflow planted), be is kept in f32 as it is, in the layout the kernel's
  stages read (undone here), the rows past D zero; the wrapper takes it for
  CPU tensors."""
  rng = np.random.RandomState(7)
  special = np.array([0x3F808000, 0x3F818000, 0x3F80FFFF, 0x3F808001,
                      0x80000000, 0x00000000, 0x00000001, 0x807FFFFF,
                      0x00008000, 0x00018000, 0x7F800000, 0xFF800000,
                      0x7F7FFFFF, 0x7F7F7FFF, 0xBF808000, 0x80018000],
                     dtype=np.uint32).view(np.float32)
  we = (rng.randn(64, d) * 0.05).astype(np.float32)
  be = (rng.randn(d) * 0.05).astype(np.float32)
  wh = (rng.randn(d, 512) * 0.015).astype(np.float32)
  for x in (we, be, wh):
    x.reshape(-1)[:16] = special
    x.reshape(-1)[-16:] = -special
  img = iqn_head.iqn_head_stage_fwd_bf16(*(torch.from_numpy(x)
                                           for x in (we, be, wh)))
  assert img.dtype == torch.uint8
  assert tuple(img.shape) == (-(-d // 64), iqn_head.BF16_FWD_CHUNK_BYTES)
  got_wh, got_wet, got_be, pad_zero = _unstage_fwd(img.numpy(), d)
  bits = lambda x: np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(
      np.uint16)
  np.testing.assert_array_equal(got_wh, bits(wh))
  np.testing.assert_array_equal(got_wet, bits(we.T))
  np.testing.assert_array_equal(got_be.view(np.uint32), be.view(np.uint32))
  assert pad_zero


def test_k4a_bf16_hi_wh_sum_fits_the_h_check_without_a_fold():
  """K4a's bf16 h_pre = hi @ wh emulated in the kernel's k order over all
  of D (196 k-steps of 16, each step's exact bf16 products added to the
  f32 accumulator with the tensor cores' truncation, no rounding fold: the
  source has none), after te_pre's 4 k-steps over latent 64 taken the same
  way: h = relu(h_pre + bh) stays within a tenth of the card check's 1e-4
  relative Frobenius error against float64 sums of the same bf16 operands
  (printed with pytest -s), for 128 rows of one stream each half and 64
  columns of H."""
  assert "kFold" not in FWD_BF16_CU.read_text()
  rng = np.random.RandomState(8)
  n = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32))
  rows, hc = 128, 64
  we, be, wh = n(64, D) * 0.05, n(D) * 0.05, n(D, hc) * 0.015
  bh = n(hc) * 0.05
  cos = n(rows, 64)
  s_rows = torch.relu(n(2, D)).repeat_interleave(64, 0)
  te_pre = _k_order_sum(_bf16(cos), _bf16(we))
  hi = _bf16(torch.relu(te_pre + be) * s_rows)
  h = torch.relu(_k_order_sum(hi, _bf16(wh)) + bh)
  want = torch.relu(hi.double() @ _bf16(wh).double() + bh.double())
  err = float(torch.linalg.vector_norm(h.double() - want)
              / torch.linalg.vector_norm(want))
  print(f"K4a bf16 h over D = {D}, no fold: relative Frobenius {err:.3e}")
  assert err <= 1e-5
