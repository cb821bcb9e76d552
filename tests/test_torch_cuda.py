"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: they skip without a card. On a machine with one (and without
JAX, which tests/conftest.py imports), run them with
  python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from dqn_zoo_torch import kernels
from dqn_zoo_torch.device import set_numerics
from dqn_zoo_torch.nets import iqn_head, torso_cuda
from dqn_zoo_torch.prep import atari as tprep
from dqn_zoo_torch.prep import cuda_prep
from dqn_zoo_torch.replay import window_gather as twg

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  set_numerics()
  return torch.device("cuda")


def _gen(seed):
  g = torch.Generator(device="cuda")
  g.manual_seed(seed)
  return g


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32],
                         ids=["int64", "int32"])
@pytest.mark.parametrize("batch,window", [(1024, 5), (3, 7), (1024, 7)])
def test_k1_matches_plain(dev, batch, window, dtype):
  g = _gen(0)
  frames = torch.randint(0, 256, (16, 40, 84, 84), generator=g, device=dev,
                         dtype=torch.uint8)
  # Negative and out-of-range indices clamp like lax.dynamic_slice.
  stream = torch.randint(-2, 18, (batch,), generator=g, device=dev,
                         dtype=dtype)
  start = torch.randint(-3, 42, (batch,), generator=g, device=dev,
                        dtype=dtype)
  stream[0], start[-1] = -40, 2**30
  before = twg.KERNEL.launches
  got = twg.gather_windows(frames, stream, start, window)
  torch.cuda.synchronize()
  assert twg.KERNEL.launches == before + 1
  assert torch.equal(got, twg.gather_windows_plain(frames, stream, start,
                                                   window))


def test_k1_reads_the_callers_index_tensors_as_they_are(dev, monkeypatch):
  """The replay's int64 indices reach the kernel by their own pointers: no
  converted copy, one launch."""
  frames = torch.randint(0, 256, (4, 12, 84, 84), generator=_gen(17),
                         device=dev, dtype=torch.uint8)
  stream = torch.tensor([0, 3, -1, 9], device=dev)
  start = torch.tensor([2, -5, 7, 30], device=dev)
  seen = []
  launch = twg.KERNEL.launch
  monkeypatch.setattr(twg.KERNEL, "launch",
                      lambda *args: (seen.append(args), launch(*args)))
  got = twg.gather_windows(frames, stream, start, 5)
  torch.cuda.synchronize()
  assert len(seen) == 1
  assert seen[0][1:3] == (stream.data_ptr(), start.data_ptr())
  assert torch.equal(got, twg.gather_windows_plain(frames, stream, start, 5))
  with pytest.raises(ValueError, match="int32"):
    twg.gather_windows(frames, stream, start.to(torch.int32), 5)


def _frames(dev, batch, seed):
  g = _gen(seed)
  f1 = torch.randint(0, 256, (batch, 210, 160, 3), generator=g, device=dev,
                     dtype=torch.uint8)
  f2 = torch.randint(0, 256, (batch, 210, 160, 3), generator=g, device=dev,
                     dtype=torch.uint8)
  f1[0] = 0  # the zero-penult (episode start) case
  return f1, f2


@pytest.mark.parametrize("batch", [128, 5, 4, 1, 33])
def test_k2_matches_plain(dev, batch):
  # Exact: luma is the plain version's f32 arithmetic, and each resize sum
  # is one fixed-order fmaf chain whose result lies far enough from a .5
  # rounding edge on these inputs that cuBLAS's order rounds it the same.
  f1, f2 = _frames(dev, batch, 1)
  before = cuda_prep.KERNEL.launches
  got = cuda_prep.pooled_frame_to_84(f1, f2)
  torch.cuda.synchronize()
  assert cuda_prep.KERNEL.launches == before + 1
  assert torch.equal(got, tprep.pooled_frame_to_84_plain(f1, f2))


@pytest.mark.parametrize("band_rows", [4, 12, 5])
def test_k2_band_sizes_give_the_same_bits(dev, band_rows):
  f1, f2 = _frames(dev, 6, 2)
  assert torch.equal(
      cuda_prep.launch(f1, f2, band_rows, cuda_prep.KERNEL.launch),
      cuda_prep.pooled_frame_to_84(f1, f2))


@pytest.mark.parametrize("batch", [128, 4])
def test_k2_launches_are_bit_identical(dev, batch):
  f1, f2 = _frames(dev, batch, 3)
  first = cuda_prep.pooled_frame_to_84(f1, f2)
  assert torch.equal(first, cuda_prep.pooled_frame_to_84(f1, f2))


def test_k2_shared_memory_is_the_wrappers_count(dev):
  fn = kernels.load("pooled_frame_to_84.cu").dz_pooled_frame_to_84_smem
  for band_rows in (4, 6, 12):
    p = cuda_prep.band_plan(band_rows)
    assert fn(p.max_rows) == cuda_prep.smem_bytes(p.max_rows)


def test_k2_wrapper_raises_on_frames_it_does_not_take(dev):
  f1, f2 = _frames(dev, 2, 4)
  before = cuda_prep.KERNEL.launches
  strided = torch.zeros((2, 210, 160, 4), dtype=torch.uint8,
                        device=dev)[..., :3]
  with pytest.raises(ValueError, match="contiguous"):
    cuda_prep.pooled_frame_to_84(strided, f2)
  with pytest.raises(ValueError, match="contiguous"):
    cuda_prep.pooled_frame_to_84(f1, f2.float())
  with pytest.raises(ValueError, match="contiguous"):
    cuda_prep.pooled_frame_to_84(f1, f2.to(torch.int8))
  unaligned = torch.zeros(2 * 210 * 160 * 3 + 1, dtype=torch.uint8,
                          device=dev)[1:].view(2, 210, 160, 3)
  with pytest.raises(ValueError, match="aligned"):
    cuda_prep.pooled_frame_to_84(f1, unaligned)
  assert cuda_prep.KERNEL.launches == before


def _torso_params(dev, seed):
  g = _gen(seed)
  ws = []
  for name, shape in torso_cuda.SHAPES.items():
    fan_in = int(np.prod(shape[:-1])) if name.startswith("w") else 256
    u = torch.rand(shape, generator=g, device=dev) * 2 - 1
    ws.append(u / fan_in ** 0.5)
  return ws


@pytest.mark.parametrize("batch", [128, 1024, 7, 4, 1])
def test_k3a_matches_plain(dev, batch):
  ws = _torso_params(dev, 2)
  x = torch.randint(0, 256, (batch, 84, 84, 4), generator=_gen(3),
                    device=dev, dtype=torch.uint8)
  with torch.no_grad():
    got = torso_cuda.dqn_torso(*ws, x)
  want = torso_cuda.torso_plain(*ws, x)
  torch.cuda.synchronize()
  # f32-accurate on both sides (3xTF32 in the kernel, TF32 off in the
  # plain version), summed in another order.
  torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_k3b_residuals_and_gradients_match_plain(dev):
  ws = _torso_params(dev, 4)
  x = torch.randint(0, 256, (64, 84, 84, 4), generator=_gen(5), device=dev,
                    dtype=torch.uint8)
  out, z1, z2 = torso_cuda.torso_forward(ws, x, residuals=True)
  want, wz1, wz2 = torso_cuda.torso_plain_residuals(*ws, x)
  torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-5)
  torch.testing.assert_close(z1, wz1, rtol=1e-4, atol=1e-5)
  torch.testing.assert_close(z2, wz2, rtol=1e-4, atol=1e-5)

  dy = torch.randn((64, 3136), generator=_gen(6), device=dev)
  a = [w.clone().requires_grad_(True) for w in ws]
  b = [w.clone().requires_grad_(True) for w in ws]
  ga = torch.autograd.grad((torso_cuda.dqn_torso(*a, x) * dy).sum(), a)
  # The reference takes the kernel's ReLU masks: a pre-activation within
  # f32 rounding of 0 may take the other branch in the plain forward and
  # move a weight gradient by a whole term (chip_smoke.py counts them).
  masks = [(t > 0).float() for t in (z1, z2, out.reshape(-1, 7, 7, 64))]
  gb = torch.autograd.grad(
      (torso_cuda.torso_plain_masked(*b, x, masks) * dy).sum(), b)
  for u, v in zip(ga, gb):
    assert float(torch.linalg.vector_norm(u - v)
                 / torch.linalg.vector_norm(v)) <= 1e-4


@pytest.mark.parametrize("batch", [1, 7, 1024])
def test_k3b_residuals_match_plain(dev, batch):
  ws = _torso_params(dev, 10)
  x = torch.randint(0, 256, (batch, 84, 84, 4), generator=_gen(11),
                    device=dev, dtype=torch.uint8)
  got = torso_cuda.torso_forward(ws, x, residuals=True)
  want = torso_cuda.torso_plain_residuals(*ws, x)
  for a, e in zip(got, want):
    torch.testing.assert_close(a, e, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("residuals", [False, True])
@pytest.mark.parametrize("batch", [1024, 7])
def test_k3_launches_are_bit_identical(dev, batch, residuals):
  ws = _torso_params(dev, 12)
  x = torch.randint(0, 256, (batch, 84, 84, 4), generator=_gen(13),
                    device=dev, dtype=torch.uint8)
  first = torso_cuda.torso_forward(ws, x, residuals=residuals)
  again = torso_cuda.torso_forward(ws, x, residuals=residuals)
  if not residuals:
    first, again = (first,), (again,)
  for a, e in zip(first, again):
    assert torch.equal(a, e)


def _head_inputs(dev, b, s, a, seed):
  """K4a's eight arguments at the published widths (latent 64, D = 3136,
  H = 512), at the scale of the reference's own test of its kernel."""
  g = _gen(seed)
  n = lambda *shape: torch.randn(shape, generator=g, device=dev)
  return (n(64, 3136) * 0.05, n(3136) * 0.05, n(3136, 512) * 0.015,
          n(512) * 0.05, n(512, a) * 0.05, n(a) * 0.05, n(b, s, 64),
          torch.relu(n(b, 3136)))


# (128, 64): one split of D; the others cut D over blocks (d_splits > 1).
@pytest.mark.parametrize("residuals", [False, True])
@pytest.mark.parametrize("b,s,a", [(128, 64, 6), (4, 64, 6), (3, 24, 18),
                                   (1, 1, 6), (2, 8, 6)])
def test_k4a_matches_plain(dev, b, s, a, residuals):
  args = _head_inputs(dev, b, s, a, 8)
  kernel = iqn_head.FWD_RES if residuals else iqn_head.FWD
  before = kernel.launches
  with torch.no_grad():
    if residuals:
      q, h = iqn_head.iqn_head_forward(*args, residuals=True)
    else:
      q = iqn_head.iqn_head(*args)  # the public entry: K4a on CUDA tensors
    want_q, want_h = iqn_head.iqn_head_plain_residuals(*args)
  torch.cuda.synchronize()
  assert kernel.launches == before + 1
  assert tuple(q.shape) == (b, s, a)
  # f32 against 3xTF32 on the tensor cores, summed in another order than
  # cuBLAS (TF32 is off there).
  torch.testing.assert_close(q, want_q, rtol=1e-4, atol=1e-5)
  if residuals:
    torch.testing.assert_close(h, want_h, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("b,s,residuals", [(128, 64, False),
                                            (1024, 64, True),
                                            (1024, 128, False)],
                         ids=["act", "learn_online", "learn_target"])
def test_k4a_matches_plain_at_18_actions(dev, b, s, residuals):
  """The head at an 18-action game's full-width shapes (qbert's six aside,
  star_gunner, tennis and zaxxon take all 18): the last column tile
  ragged, q (and h for the online net) within the same tolerances."""
  args = _head_inputs(dev, b, s, 18, 11)
  with torch.no_grad():
    got = iqn_head.iqn_head_forward(*args, residuals=residuals)
    want_q, want_h = iqn_head.iqn_head_plain_residuals(*args)
  q = got[0] if residuals else got
  assert tuple(q.shape) == (b, s, 18)
  torch.testing.assert_close(q, want_q, rtol=1e-4, atol=1e-5)
  if residuals:
    torch.testing.assert_close(got[1], want_h, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("residuals", [False, True])
def test_k4a_split_launches_are_bit_identical(dev, residuals):
  """At B = 4 the blocks share D and a second kernel adds their partials in
  split order, without atomics: two launches give the same bits."""
  args = _head_inputs(dev, 4, 64, 6, 18)
  assert iqn_head.d_splits(4, 64) > 1
  run = lambda: iqn_head.iqn_head_forward(*args, residuals=residuals)
  first, second = run(), run()
  torch.cuda.synchronize()
  if not residuals:
    first, second = (first,), (second,)
  for u, v in zip(first, second):
    assert torch.equal(u, v)


def test_k4a_wrapper_launches_or_raises(dev):
  args = list(_head_inputs(dev, 2, 8, 6, 9))
  before = iqn_head.FWD.launches
  with pytest.raises(ValueError, match="CUDA"):  # weights left on the CPU
    iqn_head.iqn_head(*(t.cpu() for t in args[:6]), *args[6:])
  with pytest.raises(ValueError, match="contiguous"):
    iqn_head.iqn_head(args[0], args[1], args[2].t().contiguous().t(),
                      *args[3:])
  with pytest.raises(ValueError, match="float32"):
    iqn_head.iqn_head(*args[:6], args[6].double(), args[7])
  # Under grad on the card it goes through the autograd Function: K4a with
  # residuals, and no launch of the forward-only variant.
  args[2].requires_grad_(True)
  before_res = iqn_head.FWD_RES.launches
  q = iqn_head.iqn_head(*args)
  assert q.requires_grad
  assert iqn_head.FWD_RES.launches == before_res + 1
  assert iqn_head.FWD.launches == before
  with torch.no_grad():
    iqn_head.iqn_head(*args)
  assert iqn_head.FWD.launches == before + 1
  assert iqn_head.FWD_RES.launches == before_res + 1


def _rel(got, want):
  return float(torch.linalg.vector_norm(got - want)
               / torch.linalg.vector_norm(want))


def _head_dh(dev, args, seed):
  """dh as the backward makes it: (dq @ woᵀ) masked by K4a's own h > 0."""
  b, s, _ = args[6].shape
  with torch.no_grad():
    _, h = iqn_head.iqn_head_forward(*args, residuals=True)
    dq = torch.randn((b * s, args[4].shape[1]), generator=_gen(seed),
                     device=dev)
    return ((dq @ args[4].t()) * (h > 0)).contiguous()


# (1024, 64): the learn shape, held as chip_smoke.py holds it (relative
# Frobenius only); the others also elementwise. (5, 512): two row groups of
# 2 and 3 streams; (128, 64) and (1024, 64): four; else one.
@pytest.mark.parametrize("b,s,a", [(1024, 64, 6), (128, 64, 6), (4, 64, 6),
                                   (3, 24, 18), (5, 512, 6)])
def test_k4b_matches_plain(dev, b, s, a):
  args = _head_inputs(dev, b, s, a, 10)
  we, be, _, _, _, _, cos_emb, s_emb = args
  dh = _head_dh(dev, args, 11)
  before = iqn_head.BWD_W.launches
  got = iqn_head.iqn_head_bwd_w(we, be, cos_emb, s_emb, dh)
  torch.cuda.synchronize()
  assert iqn_head.BWD_W.launches == before + 1
  want = iqn_head.iqn_head_bwd_w_plain(we, be, cos_emb, s_emb, dh)
  # f32 on both sides (TF32 is off): the kernel's products are 3xTF32, its
  # sums over rows in row order, cuBLAS's in another.
  for g, w in zip(got, want):
    assert tuple(g.shape) == tuple(w.shape)
    assert _rel(g, w) <= 1e-4
    if b < 1024:
      torch.testing.assert_close(g, w, rtol=1e-4,
                                 atol=1e-5 * float(w.abs().max()))


@pytest.mark.parametrize("b,s,a", [(1024, 64, 6), (3, 24, 18)])
def test_k4b_launches_are_bit_identical(dev, b, s, a):
  """Every sum over rows is taken in a fixed order (row groups added in
  group order): two launches give the same bits."""
  args = _head_inputs(dev, b, s, a, 21)
  we, be, _, _, _, _, cos_emb, s_emb = args
  dh = _head_dh(dev, args, 22)
  run = lambda: iqn_head.iqn_head_bwd_w(we, be, cos_emb, s_emb, dh)
  first, second = run(), run()
  torch.cuda.synchronize()
  for u, v in zip(first, second):
    assert torch.equal(u, v)


# (1024, 64): the learn shape, four row groups, held as chip_smoke.py holds
# it (relative Frobenius only); the others also elementwise.
@pytest.mark.parametrize("need_dcos", [True, False])
@pytest.mark.parametrize("b,s,a", [(1024, 64, 6), (128, 64, 6), (4, 64, 6),
                                   (3, 24, 18), (5, 512, 6)])
def test_k4c_matches_plain(dev, b, s, a, need_dcos):
  args = _head_inputs(dev, b, s, a, 12)
  we, be, wh, _, _, _, cos_emb, s_emb = args
  dh = _head_dh(dev, args, 13)
  before = iqn_head.BWD_D.launches
  *got, mask = iqn_head.iqn_head_bwd_d(we, be, wh, cos_emb, s_emb, dh,
                                       need_dcos=need_dcos,
                                       return_te_mask=True)
  torch.cuda.synchronize()
  assert iqn_head.BWD_D.launches == before + 1
  assert (got[3] is not None) == need_dcos
  # The plain version takes the kernel's own te_pre > 0 bits: an entry
  # within f32 rounding of 0 may take the other branch there and move dte by
  # a whole term (chip_smoke.py counts them).
  want = iqn_head.iqn_head_bwd_d_plain(we, be, wh, cos_emb, s_emb, dh,
                                       need_dcos=need_dcos, te_mask=mask)
  te_pre = cos_emb.reshape(b * s, -1) @ we + be
  assert int((mask.bool() != (te_pre > 0)).sum()) <= 8 * max(1, b // 128)
  for g, w in zip(got, want):
    if w is None:
      continue
    assert tuple(g.shape) == tuple(w.shape)
    assert _rel(g, w) <= 1e-4
    if b < 1024:
      torch.testing.assert_close(g, w, rtol=1e-4,
                                 atol=1e-5 * float(w.abs().max()))


@pytest.mark.parametrize("b,s,a", [(1024, 64, 6), (3, 24, 18)])
def test_k4c_launches_are_bit_identical(dev, b, s, a):
  """Every sum over rows is taken in a fixed order (row groups added in
  group order, dcos partials in block order): two launches give the same
  bits."""
  args = _head_inputs(dev, b, s, a, 19)
  we, be, wh, _, _, _, cos_emb, s_emb = args
  dh = _head_dh(dev, args, 20)
  run = lambda: iqn_head.iqn_head_bwd_d(we, be, wh, cos_emb, s_emb, dh,
                                        need_dcos=True, return_te_mask=True)
  first, second = run(), run()
  torch.cuda.synchronize()
  for u, v in zip(first, second):
    assert torch.equal(u, v)


def test_k4_function_gradients_match_plain(dev):
  """All eight gradients through the autograd Function (K4a with residuals,
  the wo-layer's plain ops, K4b, K4c) against autograd of the plain head
  with the kernels' own ReLU bits."""
  b, s, a = 16, 64, 6
  args = _head_inputs(dev, b, s, a, 14)
  dq = torch.randn((b, s, a), generator=_gen(15), device=dev)
  counters = (iqn_head.FWD_RES, iqn_head.BWD_W, iqn_head.BWD_D)
  before = [k.launches for k in counters]
  pa = [t.clone().requires_grad_(True) for t in args]
  ga = torch.autograd.grad((iqn_head.iqn_head(*pa) * dq).sum(), pa)
  torch.cuda.synchronize()
  assert [k.launches for k in counters] == [n + 1 for n in before]
  we, be, wh, _, wo, _, cos_emb, s_emb = args
  with torch.no_grad():
    _, h = iqn_head.iqn_head_forward(*args, residuals=True)
    dh = ((dq.reshape(b * s, a) @ wo.t()) * (h > 0)).contiguous()
    mask = iqn_head.iqn_head_bwd_d(we, be, wh, cos_emb, s_emb, dh,
                                   need_dcos=False, return_te_mask=True)[-1]
  pb = [t.clone().requires_grad_(True) for t in args]
  gb = torch.autograd.grad(
      (iqn_head.iqn_head_plain_masked(*pb, mask.float(), (h > 0).float())
       * dq).sum(), pb)
  for u, v in zip(ga, gb):
    assert tuple(u.shape) == tuple(v.shape)
    assert _rel(u, v) <= 1e-4


def test_k4_function_skips_dcos_when_the_features_want_no_gradient(dev):
  args = _head_inputs(dev, 4, 8, 6, 16)
  pa = [t.clone().requires_grad_(i < 6) for i, t in enumerate(args)]
  q = iqn_head.iqn_head(*pa)
  grads = torch.autograd.grad(q.sum(), pa[:6])
  torch.cuda.synchronize()
  assert all(bool(torch.isfinite(g).all()) for g in grads)


# --- the IQN head's bf16-operand mode (mm = bf16) -----------------------------
# Kernel and plain version both round the same operands to bf16 and
# accumulate exact products in f32, in other orders; an f32 value that
# differs in its last bits (te, hi, h, dte) may then round to a
# neighbouring bf16 value, 2^-8 to 2^-7 apart, in a few entries. So every
# output is held by its relative Frobenius error, not elementwise: <= 1e-4,
# but q <= 5e-4. q is a sum of only 512 products of bf16(h), and h, a sum
# of 3,136 terms, differs by ~25 f32 ulps between the two orders, so ~4e-4
# of its entries round to the other neighbour, each moving one product by
# 2^-8: ~1e-4 of q (1.2e-4 read at B = 4 on the card). The epilogue itself
# is held tighter: q from the kernel's own h within 1e-5.

BF16 = torch.bfloat16


# The iqn path's shapes, eval (D split over blocks), an 18-action act shape
# and a ragged one (72 rows in a block of 128, streams of 24 rows that
# straddle the warpgroups' rows, A = 18: the q epilogue's tiles ragged).
@pytest.mark.parametrize("b,s,a,residuals", [(128, 64, 6, False),
                                              (1024, 64, 6, True),
                                              (1024, 128, 6, False),
                                              (4, 64, 6, False),
                                              (128, 64, 18, True),
                                              (3, 24, 18, True)],
                         ids=["act", "learn_online", "learn_target", "eval",
                              "act_a18", "ragged"])
def test_k4a_bf16_matches_plain(dev, b, s, a, residuals):
  args = _head_inputs(dev, b, s, a, 23)
  kernel = iqn_head.FWD_RES_BF16 if residuals else iqn_head.FWD_BF16
  counters = (kernel, iqn_head.STAGE_FWD_BF16, iqn_head.FWD,
              iqn_head.FWD_RES)
  before = [k.launches for k in counters]
  with torch.no_grad():
    got = iqn_head.iqn_head_forward(*args, residuals=residuals, mm=BF16)
    again = iqn_head.iqn_head_forward(*args, residuals=residuals, mm=BF16)
    want_q, want_h = iqn_head.iqn_head_plain_residuals(*args, mm=BF16)
    f32_q = iqn_head.iqn_head_plain(*args)
  torch.cuda.synchronize()
  # Each call stages the weights once and launches the kernel once.
  assert [k.launches for k in counters] == \
      [before[0] + 2, before[1] + 2] + before[2:]
  got, again = ((got, again) if residuals else ((got,), (again,)))
  assert all(torch.equal(u, v) for u, v in zip(got, again))
  assert _rel(got[0], want_q) <= 5e-4
  assert _rel(got[0], want_q) < 0.1 * _rel(f32_q, want_q)  # it is bf16
  if residuals:
    assert _rel(got[1], want_h) <= 1e-4
    we, be, wh, bh, wo, bo, cos_emb, s_emb = args
    r = lambda t: t.to(BF16).float()
    q_from_h = (r(got[1]) @ r(wo) + bo).reshape(b, s, -1)
    assert _rel(got[0], q_from_h) <= 1e-5


@pytest.mark.parametrize("d", [3136, 96], ids=["d3136", "d96"])
def test_k4a_bf16_staging_matches_plain(dev, d):
  """K4a's staging pass writes the plain version's bytes bit for bit, also
  with ties, ±0, subnormals, ±inf and the largest float planted in we, be
  and wh, and at a D of 32 rows past a whole chunk (the last chunk's rows
  past D zero); one launch a call."""
  n = lambda *shape: torch.randn(shape, generator=_gen(30), device=dev)
  we, be, wh = n(64, d) * 0.05, n(d) * 0.05, n(d, 512) * 0.015
  bits = torch.from_numpy(np.array(
      [0x3F808000, 0x3F818000, 0x80000000, 0x00000001, 0x807FFFFF,
       0x7F800000, 0xFF800000, 0x7F7FFFFF], dtype=np.uint32).view(
           np.float32)).to(dev)
  we[0, :8], we[-1, -8:] = bits, -bits
  wh[0, :8], wh[-1, -8:] = bits, -bits
  be[:8] = bits
  before = iqn_head.STAGE_FWD_BF16.launches
  got = iqn_head.iqn_head_stage_fwd_bf16(we, be, wh)
  again = iqn_head.iqn_head_stage_fwd_bf16(we, be, wh)
  torch.cuda.synchronize()
  assert iqn_head.STAGE_FWD_BF16.launches == before + 2
  want = iqn_head.iqn_head_stage_fwd_bf16_plain(we, be, wh)
  assert got.dtype == torch.uint8 and tuple(got.shape) == tuple(want.shape)
  assert torch.equal(got, want) and torch.equal(got, again)


# (1024, 64): the learn shape (5 row groups of K4b, 10 of K4c); (128, 64):
# the same group counts over 8,192 rows; (3, 24): one and two groups, the
# last D tile ragged in both and streams that straddle the 64-row chunks.
@pytest.mark.parametrize("b,s", [(1024, 64), (128, 64), (3, 24)],
                         ids=["learn", "b128", "small"])
def test_k4b_k4c_bf16_match_plain(dev, b, s):
  """K4b and K4c in bf16 mode (their own kernels on staged bf16 operands),
  K4c with dcos and against the plain version with its own te_pre > 0
  bits; each launch repeated bit for bit."""
  args = _head_inputs(dev, b, s, 6, 24)
  we, be, wh, _, _, _, cos_emb, s_emb = args
  dh = _head_dh(dev, args, 25)
  counters = (iqn_head.BWD_W_BF16, iqn_head.BWD_D_BF16,
              iqn_head.STAGE_BF16, iqn_head.BWD_W, iqn_head.BWD_D)
  before = [k.launches for k in counters]
  w_args = (we, be, cos_emb, s_emb, dh)
  got_w = iqn_head.iqn_head_bwd_w(*w_args, mm=BF16)
  again_w = iqn_head.iqn_head_bwd_w(*w_args, mm=BF16)
  d_args = (we, be, wh, cos_emb, s_emb, dh)
  *got_d, mask = iqn_head.iqn_head_bwd_d(*d_args, return_te_mask=True,
                                         mm=BF16)
  again_d = iqn_head.iqn_head_bwd_d(*d_args, return_te_mask=True, mm=BF16)
  torch.cuda.synchronize()
  # Each call without staged operands stages its own: 4 staging passes.
  assert [k.launches for k in counters] == \
      [before[0] + 2, before[1] + 2, before[2] + 4] + before[3:]
  assert all(torch.equal(u, v) for u, v in zip(got_w, again_w))
  assert all(torch.equal(u, v) for u, v in zip((*got_d, mask), again_d))
  want_w = iqn_head.iqn_head_bwd_w_plain(*w_args, mm=BF16)
  f32_w = iqn_head.iqn_head_bwd_w_plain(*w_args)
  for g, w, f in zip(got_w, want_w, f32_w):
    assert tuple(g.shape) == tuple(w.shape)
    assert _rel(g, w) <= 1e-4
  assert _rel(got_w[0], want_w[0]) < 0.1 * _rel(f32_w[0], want_w[0])
  want_d = iqn_head.iqn_head_bwd_d_plain(*d_args, te_mask=mask, mm=BF16)
  for g, w in zip(got_d, want_d):
    assert tuple(g.shape) == tuple(w.shape)
    assert _rel(g, w) <= 1e-4


@pytest.mark.parametrize("b,s", [(1024, 64), (3, 24)], ids=["learn", "small"])
def test_bf16_staging_matches_plain(dev, b, s):
  """The staging pass's bf16 copies equal the plain version's bit for bit,
  also with ties, ±0, subnormals, ±inf and the largest float planted in
  dh; dbh, summed in another order, within rtol 1e-5 (atol 1e-6 x
  max|dbh|) on dh as the backward makes it; one launch a call, and the
  same bits on a repeat."""
  args = _head_inputs(dev, b, s, 6, 28)
  we, _, wh, _, _, _, cos_emb, _ = args
  dh = _head_dh(dev, args, 29)
  before = iqn_head.STAGE_BF16.launches
  got = iqn_head.iqn_head_stage_bf16(we, cos_emb, dh, wh)
  again = iqn_head.iqn_head_stage_bf16(we, cos_emb, dh, wh)
  want = iqn_head.iqn_head_stage_bf16_plain(we, cos_emb, dh, wh)
  torch.testing.assert_close(got.dbh, want.dbh, rtol=1e-5,
                             atol=1e-6 * float(want.dbh.abs().max()))
  assert all(torch.equal(u.view(torch.uint8), v.view(torch.uint8))
             for u, v in zip(got, again))
  bits = np.array([0x3F808000, 0x3F818000, 0x80000000, 0x00000001,
                   0x807FFFFF, 0x7F800000, 0xFF800000, 0x7F7FFFFF],
                  dtype=np.uint32).view(np.float32)
  dh[0, :8] = torch.from_numpy(bits).to(dev)
  dh[-1, -8:] = -torch.from_numpy(bits).to(dev)
  planted = iqn_head.iqn_head_stage_bf16(we, cos_emb, dh, wh)
  torch.cuda.synchronize()
  assert iqn_head.STAGE_BF16.launches == before + 3
  for got, want in ((got, want), (planted, iqn_head.iqn_head_stage_bf16_plain(
      we, cos_emb, dh, wh))):
    for name in ("dh", "cos", "we_t", "wh"):
      g, w = getattr(got, name), getattr(want, name)
      assert g.dtype == torch.bfloat16 and tuple(g.shape) == tuple(w.shape)
      assert torch.equal(g.view(torch.int16), w.view(torch.int16)), name


def test_k4_bf16_function_matches_the_cpu(dev):
  """iqn_head(mm=bf16) under grad on the card (K4a with residuals, K4b and
  K4c in bf16 mode) against the same Function on the CPU (the plain
  versions): q and all eight gradients within 1e-4 relative Frobenius."""
  b, s, a = 16, 64, 6
  args = _head_inputs(dev, b, s, a, 26)
  dq = torch.randn((b, s, a), generator=_gen(27), device=dev)
  counters = (iqn_head.FWD_RES_BF16, iqn_head.BWD_W_BF16,
              iqn_head.BWD_D_BF16, iqn_head.STAGE_BF16,
              iqn_head.STAGE_FWD_BF16)
  before = [k.launches for k in counters]
  outs = {}
  for d in (dev, "cpu"):
    p = [t.to(d).clone().requires_grad_(True) for t in args]
    q = iqn_head.iqn_head(*p, mm=BF16)
    outs[d] = (q.detach().cpu(), [g.cpu() for g in torch.autograd.grad(
        (q * dq.to(d)).sum(), p)])
  torch.cuda.synchronize()
  assert [k.launches for k in counters] == [n + 1 for n in before]
  (q, g), (cq, cg) = outs[dev], outs["cpu"]
  assert _rel(q, cq) <= 1e-4
  for u, v in zip(g, cg):
    assert _rel(u, v) <= 1e-4


def test_bf16_dqn_supersteps_on_the_card_match_the_cpu(dev):
  """dqn/pong at compute_dtype=bfloat16, 8 envs, on the card (K1, K2, the
  cast torso on cuDNN, no K3) and on the CPU: each of 12 supersteps (10
  learn steps) starts on both from the CPU's state and takes the same
  draws. Actions and replay rows equal, the loss within rtol 1e-3, and
  99.9 % of the weights within 2e-6 after the step, as test_torch_slice
  holds f32. Each step starts anew because bf16 makes ReLU branch flips
  common: an f32 difference in the last bits moves a bf16-rounded operand
  by 2^-8, enough to take a pre-activation near 0 across it, and a
  flipped hidden unit moves its weights by a share of one RMSProp step
  (on an H100, 6.6e-5 at the 9th of a chained run's learn steps; none in
  f32). One step bounds that: no weight moves by more than the saturated
  step, lr·4.6."""
  import dataclasses
  from dqn_zoo_torch.agents import get_agent
  from dqn_zoo_torch.engine import Engine, EngineConfig
  from dqn_zoo_torch.engine.superstep import leaves
  spec = dataclasses.replace(get_agent("dqn"), compute_dtype="bfloat16",
                             target_network_update_period=96)
  cfg = EngineConfig(agent=spec, game="pong", num_envs=8,
                     slots_per_stream=16, batch_size=16,
                     total_train_frames=20_000)
  engines = {d: Engine(cfg, device=d) for d in ("cpu", dev)}
  state = engines["cpu"].init(0)
  torso = (torso_cuda.FWD, torso_cuda.FWD_RES)
  before = [k.launches for k in torso]
  gen = torch.Generator().manual_seed(4)
  for step in range(12):
    draws = engines["cpu"].draw(gen)
    g = _to_device(state, dev)  # before the CPU's step, which works in place
    g = engines[dev].superstep(g, _to_device(draws, dev))
    c = engines["cpu"].superstep(state, draws)
    for f in ("frames", "action", "reward", "discount", "is_terminal"):
      assert torch.equal(getattr(g.replay, f).cpu(), getattr(c.replay, f)), \
          (f, step)
    assert g.telemetry.learn_steps == c.telemetry.learn_steps
    if c.telemetry.learn_steps:
      np.testing.assert_allclose(float(g.telemetry.last_loss),
                                 float(c.telemetry.last_loss), rtol=1e-3)
    diff = torch.cat([(x.cpu() - w).detach().abs().flatten()
                      for x, w in zip(leaves(g.online_params),
                                      leaves(c.online_params))])
    assert float(diff.max()) <= 4.6 * spec.learning_rate, (step, diff.max())
    assert float((diff <= 2e-6).float().mean()) >= 0.999, step
    state = c
  torch.cuda.synchronize()
  assert state.telemetry.learn_steps >= 10
  assert [k.launches for k in torso] == before  # K3 computes in f32 only


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
  with pytest.raises(ValueError):
    twg.gather_windows(torch.zeros((2, 8, 84, 84), device=dev),
                       torch.zeros(3, dtype=torch.int32, device=dev),
                       torch.zeros(3, dtype=torch.int32, device=dev), 5)
  z = torch.zeros((2, 210, 160, 3), dtype=torch.uint8, device=dev)
  with pytest.raises(ValueError):
    cuda_prep.pooled_frame_to_84(z, z[:, :, :, :1].contiguous())
  ws = _torso_params(dev, 7)
  with pytest.raises(ValueError):
    torso_cuda.torso_forward(ws, torch.zeros((2, 84, 84, 4), device=dev),
                             residuals=False)


def test_every_kernel_builds(dev):
  kernels.build_all()
  sources = {k.source for k in kernels.REGISTRY.values()}
  assert sources == {"window_gather.cu", "pooled_frame_to_84.cu",
                     "dqn_torso.cu", "iqn_head.cu", "iqn_head_bwd.cu",
                     "iqn_head_bwd_bf16.cu", "iqn_head_bf16.cu"}
  assert sources == {p.name for p in kernels.CSRC.glob("*.cu")}
  for k in kernels.REGISTRY.values():
    assert k._func() is not None


# --- prioritized replay on the card (no kernel of its own: the trees are
# PyTorch ops, whose CUDA scatter keeps an arbitrary one of duplicate writes)


@pytest.mark.parametrize("leaves", [20, 1])
def test_fanout_set_last_write_wins_on_the_card(dev, leaves):
  from dqn_zoo_torch.replay import fanout_tree as ft
  g = _gen(21)
  idx = torch.randint(0, leaves, (2048,), generator=g, device=dev)
  val = torch.rand((2048,), generator=g, device=dev)
  last = dict(zip(idx.tolist(), val.tolist()))
  for _ in range(3):  # the same bits on every repeat
    tree = ft.fanout_init(300, dev)
    ft.fanout_set(tree, idx, val)
    for i, v in last.items():
      assert float(tree[0][i]) == v
    want = tree[0].view(-1, 128).sum(-1)
    assert torch.equal(tree[1], want)


def test_prioritized_replay_on_the_card_matches_the_cpu(dev):
  """Inserts, a mixture sample with IS weights and a priority write with
  repeated leaves, on the card and on the CPU from the same rows. Dyadic
  priorities (α = 0.5 of squares of halves) keep every tree sum exact, so
  leaves, samples and trees agree exactly; weights rtol 1e-6."""
  from dqn_zoo_torch.replay import device_replay as dr
  cfg = dr.ReplayConfig(num_streams=6, slots_per_stream=40,
                        priority_exponent=0.5, uniform_sample_probability=0.25,
                        normalize_weights_chunk=32)
  states = {d: dr.replay_init(cfg, d) for d in ("cpu", dev)}
  rng = np.random.RandomState(5)
  for step in range(50):
    row = dict(
        frame=rng.randint(0, 256, (6, 84, 84)).astype(np.uint8),
        stack_count=np.full(6, min(step + 1, 4), np.int32),
        action=rng.randint(0, 6, 6).astype(np.int32),
        reward=rng.choice([-1.0, 0.0, 1.0], 6).astype(np.float32),
        discount=np.full(6, 0.99, np.float32),
        is_terminal=rng.uniform(size=6) < 0.1)
    u = torch.from_numpy(rng.uniform(size=(3, 64)).astype(np.float32))
    prio = torch.from_numpy(rng.choice(
        np.array([0.25, 1.0, 2.25, 4.0], np.float32), 64))
    got = {}
    for d, st in states.items():
      st = dr.replay_insert(cfg, st, **{k: torch.from_numpy(v).to(d)
                                        for k, v in row.items()})
      states[d] = st
      if int(dr.replay_size(st)) < 8:
        continue
      batch, leaves, weights = dr.replay_sample(cfg, st, u.to(d), 0.6)
      dr.replay_update_priorities(cfg, st, leaves, prio.to(d))
      got[d] = (batch, leaves, weights, st)
    if not got:
      continue
    (cb, cl, cw, cs), (gb, gl, gw, gs) = got["cpu"], got[dev]
    assert torch.equal(cl, gl.cpu())
    for a, b in zip(cb, gb):
      assert torch.equal(a, b.cpu())
    torch.testing.assert_close(gw.cpu(), cw, rtol=1e-6, atol=0)
    for a, b in zip(cs.value_tree + cs.indicator_tree,
                    gs.value_tree + gs.indicator_tree):
      assert torch.equal(a, b.cpu())
    assert torch.equal(cs.max_seen_priority, gs.max_seen_priority.cpu())


def test_seaquest_on_the_card_matches_the_cpu(dev):
  """Vector seaquest at B=16 for 24 groups, on the card and on the CPU from
  the same per-frame draws and actions: every output, frames included, and
  every state field bit for bit."""
  from dqn_zoo_torch.envs.api import get_game
  from dqn_zoo_torch.envs.vector import VectorAtariEnv

  def to(tree, d):
    if isinstance(tree, torch.Tensor):
      return tree.to(d)
    return type(tree)(*(to(x, d) for x in tree))

  b = 16
  game = get_game("seaquest")
  cpu_env = VectorAtariEnv(game, b, device="cpu")
  card_env = VectorAtariEnv(game, b, device=dev)
  gen = torch.Generator().manual_seed(2)
  cpu_state = cpu_env.init(gen)
  card_state = to(cpu_state, dev)
  for _ in range(24):
    draws = cpu_env.draws(gen)
    actions = torch.randint(0, 18, (b,), generator=gen)
    cpu_state, cpu_out = cpu_env.step(cpu_state, actions, draws)
    card_state, card_out = card_env.step(card_state, actions.to(dev),
                                         to(draws, dev))
    for a, w in zip(card_out + card_state.game_state,
                    cpu_out + cpu_state.game_state):
      assert torch.equal(a.cpu(), w)


@pytest.mark.parametrize("name", ["breakout", "space_invaders", "freeway",
                                  "asterix", "atlantis", "skiing", "assault",
                                  "beam_rider", "bowling", "boxing",
                                  "crazy_climber", "demon_attack", "enduro",
                                  "fishing_derby", "gopher", "ice_hockey",
                                  "ms_pacman", "phoenix", "qbert",
                                  "star_gunner", "tennis", "zaxxon"])
def test_game_on_the_card_matches_the_cpu(dev, name):
  """Each game ported beside seaquest, at B=16 for 24 groups under a
  48-frame episode cap (resets within the run), on the card and on the CPU
  from the same draws and actions: every output, frames included, and
  every state field bit for bit."""
  from dqn_zoo_torch.envs.api import get_game
  from dqn_zoo_torch.envs.vector import VectorAtariEnv, VectorEnvConfig

  def to(tree, d):
    if tree is None or isinstance(tree, torch.Tensor):
      return None if tree is None else tree.to(d)
    return type(tree)(*(to(x, d) for x in tree))

  b = 16
  game = get_game(name)
  cfg = VectorEnvConfig(episode_frame_cap=48)
  cpu_env = VectorAtariEnv(game, b, cfg, device="cpu")
  card_env = VectorAtariEnv(game, b, cfg, device=dev)
  gen = torch.Generator().manual_seed(4)
  cpu_state = cpu_env.init(gen)
  card_state = to(cpu_state, dev)
  for _ in range(24):
    draws = cpu_env.draws(gen)
    actions = torch.randint(0, game.num_actions, (b,), generator=gen)
    cpu_state, cpu_out = cpu_env.step(cpu_state, actions, draws)
    card_state, card_out = card_env.step(card_state, actions.to(dev),
                                         to(draws, dev))
    for a, w in zip(card_out + card_state.game_state,
                    cpu_out + cpu_state.game_state):
      assert torch.equal(a.cpu(), w)


@pytest.mark.parametrize("name", ["tennis", "star_gunner"])
def test_multiply_add_games_on_the_card_match_the_cpu(dev, name):
  """One raw frame of 4,096 states where the games' multiply-adds land:
  tennis balls at the paddles' reach at any offset and speed (the
  returns' `envs.f32.fma` with 2.2/7 and 2/7), star_gunner raiders at any
  jink velocity and 0-400 kills (the jink's and the speed's); on the card
  and on the CPU, the new state bit for bit."""
  from dqn_zoo_torch.envs.api import get_game

  n = 4096
  game = get_game(name)
  gen = torch.Generator().manual_seed(8)
  state = game.init(game.init_draws(gen, n, "cpu"))
  rand = lambda *shape: torch.rand(shape, generator=gen)
  if name == "tennis":
    down = rand(n) < 0.5
    px = 23.0 + 114.0 * rand(n)
    bvx = 6.4 * rand(n) - 3.2
    state = state._replace(
        serve_timer=torch.zeros(n, dtype=torch.int32), px=px,
        ox=px - 3.4 + 6.8 * rand(n), bx=px - 9.0 + 18.0 * rand(n) - bvx,
        bvx=bvx, bvy=torch.where(down, 2.6, -2.6),
        by=torch.where(down, 176.0, 46.0) + 9.0 * rand(n)
        - torch.where(down, 2.6, -2.6))
  else:
    state = state._replace(
        rvy=4.0 * rand(n, 3) - 2.0,
        wave=torch.randint(0, 401, (n,), generator=gen, dtype=torch.int32),
        rlive=rand(n, 3) < 0.9)
  draws = game.step_draws(gen, n, "cpu", 1)
  draws = type(draws)(*(x[0] for x in draws))
  to_dev = lambda t: type(t)(*(x.to(dev) for x in t))
  actions = torch.randint(0, game.num_actions, (n,), generator=gen)
  want = game.step(state, actions, draws)
  got = game.step(to_dev(state), actions.to(dev), to_dev(draws))
  for a, w in zip(got[1:] + tuple(got[0]), want[1:] + tuple(want[0])):
    assert torch.equal(a.cpu(), w)


def test_enduro_render_on_the_card_matches_the_cpu(dev):
  """Enduro's perspective (a product with 0.0025f, a square root taken in
  float64, the multiply-adds of `envs.f32`) for 24,576 cars, denser near
  the player, on the card and on the CPU: the frames bit for bit."""
  from dqn_zoo_torch.envs.games import enduro as en

  n = 4096
  gen = torch.Generator().manual_seed(9)
  state = en.GAME.init(en.GAME.init_draws(gen, n, "cpu"))
  u = torch.rand((n, en.NUM_CARS), generator=gen)
  state = state._replace(
      car_z=en.SPAWN_AHEAD * u * u,
      car_lane=torch.randint(0, en.NUM_LANES, (n, en.NUM_CARS),
                             generator=gen, dtype=torch.int32))
  want = en.GAME.render(state)
  got = en.GAME.render(type(state)(*(x.to(dev) for x in state)))
  assert torch.equal(got.cpu(), want)


def test_pil_preprocessing_on_the_card_matches_the_cpu(dev):
  """`pil` (max, fused luma, the exact resize in float64 products) on
  random frames, card against CPU, bit for bit."""
  rng = np.random.RandomState(8)
  f1, f2 = (torch.from_numpy(rng.randint(0, 256, (8, 210, 160, 3),
                                         np.uint8)) for _ in range(2))
  want = tprep.pooled_frame_to_84(f1, f2, "pil")
  got = tprep.pooled_frame_to_84(f1.to(dev), f2.to(dev), "pil")
  assert torch.equal(got.cpu(), want)


def _near(gen, edges, n, ulps=3):
  """n f32 values within `ulps` ulps of values drawn from `edges`."""
  edges = torch.tensor(edges, dtype=torch.float32)
  x = edges[torch.randint(0, len(edges), (n,), generator=gen)]
  up, down = torch.tensor(1e9), torch.tensor(-1e9)
  for _ in range(ulps):
    step = torch.randint(-1, 2, (n,), generator=gen)
    x = torch.where(step > 0, torch.nextafter(x, up),
                    torch.where(step < 0, torch.nextafter(x, down), x))
  return x


def _edge_states(name, gen, n):
  """n states of `name` at the edges of its floors and comparisons: the
  ball within 3 ulps of the brick grid's edges (breakout), the shot within
  3 ulps of an alien row's edge and inside a column (space_invaders); the
  ball within 3 ulps of a pin's rim (bowling); waves or buildings 0-40
  under the speed ramps' multiply-adds with drones, demons or pots at the
  walls or the top (assault, demon_attack, crazy_climber). Returns the
  states and the reward or life events the step must show."""
  from dqn_zoo_torch.envs.api import get_game
  from dqn_zoo_torch.envs.games import bowling as bw
  from dqn_zoo_torch.envs.games import breakout as bo
  from dqn_zoo_torch.envs.games import space_invaders as si

  game = get_game(name)
  state = game.init(game.init_draws(gen, n, "cpu"))
  zero = torch.zeros(n)
  rand = lambda *shape: torch.rand(shape, generator=gen)
  ints = lambda hi, *shape: torch.randint(0, hi, shape, generator=gen,
                                          dtype=torch.int32)
  rewarded = lambda out: int((out[1] > 0).sum())
  if name == "breakout":
    return state._replace(
        ball_dead=torch.zeros(n, dtype=torch.bool), ball_vx=zero,
        ball_vy=zero,
        ball_y=_near(gen, [56.0 + 6.0 * k for k in range(-1, 8)], n),
        ball_x=_near(gen, [7.0 + 8.0 * k for k in range(-1, 20)], n),
        bricks=rand(n, bo.ROWS, bo.COLS) < 0.7), rewarded
  if name == "space_invaders":
    gx = 20.0 + 40.0 * rand(n)
    gy = 40.0 + 40.0 * rand(n)
    return state._replace(
        aliens=rand(n, si.ROWS, si.COLS) < 0.7,
        grid_x=gx, grid_y=gy, shot_live=torch.ones(n, dtype=torch.bool),
        shot_x=gx + 16.0 * (ints(8, n) - 1) + 2.0 + 8.0 * rand(n),
        shot_y=gy + si.SHOT_SPEED + _near(
            gen, [14.0 * k for k in range(-1, 7)], n),
        wave=ints(10, n)), rewarded
  if name == "bowling":
    pin = torch.randint(0, bw.NUM_PINS, (n,), generator=gen)
    xy = torch.from_numpy(bw._PIN_XY)[pin]
    dx = (ints(13, n) - 6).float()
    side = torch.where(rand(n) < 0.5, -1.0, 1.0)
    return state._replace(
        ball_x=xy[:, 0] - dx - bw.BALL_SPEED,
        ball_y=xy[:, 1] + _near(gen, [0.0], n)
        + side * torch.sqrt(36.0 - dx * dx),
        hooked=torch.ones(n, dtype=torch.bool)), rewarded
  level = ints(41, n)
  dirs = torch.where(rand(n, 3) < 0.5, -1.0, 1.0)
  if name == "crazy_climber":
    pot_y = 150.0 + 12.0 * torch.randint(-1, 2, (n, 3), generator=gen)
    pot_y[:, 0] = 0.0  # a pot at the top takes the speed as its height
    knocked = lambda out: int((out[0].lives < state.lives).sum())
    return state._replace(
        building=level, pot_y=pot_y - 2.6 - 0.4 * level[:, None].float(),
        pot_col=state.col[:, None].expand(-1, 3).contiguous(),
        pot_live=torch.ones(n, 3, dtype=torch.bool),
        frame=ints(100_000, n), row=ints(25, n)), knocked
  lo, hi, speed = {"assault": (8.0, 138.0, 1.4 + 0.3 * level.float()),
                   "demon_attack": (8.0, 144.0, 1.2 + 0.3 * level.float())
                   }[name]
  x = torch.where(dirs > 0, hi, lo) + _near(gen, [0.0], n * 3).view(n, 3) \
      - dirs * speed[:, None]
  if name == "assault":
    return state._replace(
        wave=level, drone_x=x, drone_dir=dirs,
        drone_y=60.0 + 100.0 * rand(n, 3),
        drone_live=rand(n, 3) < 0.8,
        heat=torch.arange(n, dtype=torch.int32) % 100), \
        lambda out: int((out[0].drone_x != x).sum())
  return state._replace(
      wave=level, demon_x=x, demon_dir=dirs), \
      lambda out: int((out[0].demon_x != x).sum())


@pytest.mark.parametrize("name", ["breakout", "space_invaders", "bowling",
                                  "assault", "crazy_climber",
                                  "demon_attack"])
def test_game_steps_at_grid_edges_on_the_card_match_the_cpu(dev, name):
  """One raw frame of 4,096 states at the edges of the game's floors of
  reciprocal products, squared distances and multiply-adds
  (`_edge_states`), on the card and on the CPU: reward, done, life loss and
  the new state bit for bit, and the edge's events on both."""
  from dqn_zoo_torch.envs.api import get_game

  n = 4096
  game = get_game(name)
  gen = torch.Generator().manual_seed(6)
  state, events = _edge_states(name, gen, n)
  if game.per_frame_draws:
    draws = game.step_draws(gen, n, "cpu", 1)
    draws = type(draws)(*(x[0] for x in draws))
  else:
    draws = game.step_draws(gen, n, "cpu")
  to_dev = lambda t: None if t is None else type(t)(*(x.to(dev) for x in t))
  actions = torch.randint(0, game.num_actions, (n,), generator=gen)
  want = game.step(state, actions, draws)
  got = game.step(to_dev(state), actions.to(dev), to_dev(draws))
  for a, w in zip(got[1:] + tuple(got[0]), want[1:] + tuple(want[0])):
    assert torch.equal(a.cpu(), w)
  assert events(want) > 100


# --- the host env path ---------------------------------------------------------


def _to_device(tree, d, memo=None):
  """A copy of `tree` (tensors inside NamedTuples, tuples, lists and dicts)
  on `d`; leaves that are not tensors (counts, generators) stay. What is
  shared stays shared (uniform replay's value tree is its indicator
  tree)."""
  memo = {} if memo is None else memo
  if id(tree) in memo:
    return memo[id(tree)]
  if isinstance(tree, torch.Tensor):
    out = tree.detach().to(d, copy=True).requires_grad_(tree.requires_grad)
  elif isinstance(tree, dict):
    out = {k: _to_device(v, d, memo) for k, v in tree.items()}
  elif isinstance(tree, list):
    out = [_to_device(x, d, memo) for x in tree]
  elif isinstance(tree, tuple):
    items = [_to_device(x, d, memo) for x in tree]
    out = type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
  else:
    return tree
  memo[id(tree)] = out
  return out


def test_farm_uploads_every_group_to_the_card_double_buffered(dev):
  """64 groups of 128 pong envs uploaded from the two pinned buffer sets
  with no synchronize in the loop, each copy queued behind ~1 ms of card
  work: the farm must wait for a set's copy before writing into it again,
  or a later group lands in an earlier group's upload."""
  from dqn_zoo_torch.envs.cpp_bridge import CppVectorEnv
  b = 128
  env = CppVectorEnv("pong", b, seed=2, device=dev)
  rng = np.random.RandomState(3)
  host, card = [], []
  for _ in range(64):
    group = env.step(rng.randint(0, 6, b).astype(np.int32))
    host.append((group.obs84.copy(), group.reward_sum.copy(),
                 group.discount_prod.copy(), group.is_first, group.is_last,
                 group.frames_used))
    torch.cuda._sleep(2_000_000)
    card.append(env.upload(group))
  torch.cuda.synchronize()
  for want, got in zip(host, card):
    for w, g in zip(want, got):
      np.testing.assert_array_equal(g.cpu().numpy(), w)
  env.close()


def test_host_half_step_on_the_card_matches_the_cpu(dev):
  """The dqn/pong host engine at 8 envs on the card (K1, K3a, K3b) and on
  the CPU (their plain versions), from one state and the same draws, each
  over its own farm of the same seed: actions, replay rows and telemetry
  counts equal, the loss within rtol 1e-4 and the parameters within
  test_torch_slice's bounds."""
  import dataclasses
  from dqn_zoo_torch.agents import get_agent
  from dqn_zoo_torch.engine import EngineConfig
  from dqn_zoo_torch.engine.host_env import HostEnvEngine
  from dqn_zoo_torch.engine.superstep import leaves
  from dqn_zoo_torch.envs.cpp_bridge import CppVectorEnv
  b = 8
  spec = dataclasses.replace(get_agent("dqn"),
                             target_network_update_period=96)
  cfg = EngineConfig(agent=spec, game="pong", num_envs=b, slots_per_stream=16,
                     batch_size=16, total_train_frames=20_000)
  engines = {d: HostEnvEngine(cfg, CppVectorEnv(
      "pong", b, seed=6, num_threads=2, episode_frame_cap=64, device=d),
      device=d) for d in ("cpu", dev)}
  states = {"cpu": engines["cpu"].init(0)}
  states[dev] = _to_device(states["cpu"], dev)
  groups = {d: e.env.step(np.zeros((b,), np.int32))
            for d, e in engines.items()}
  gen = torch.Generator().manual_seed(3)
  for step in range(16):
    draws = engines["cpu"].draw(gen)
    actions = {}
    for d, e in engines.items():
      states[d], actions[d] = e.step(
          states[d], groups[d], draws if d == "cpu" else _to_device(draws, d))
    np.testing.assert_array_equal(actions[dev], actions["cpu"])
    c, g = states["cpu"], states[dev]
    for f in ("frames", "stack_count", "action", "reward", "discount",
              "is_terminal", "row_t"):
      assert torch.equal(getattr(g.replay, f).cpu(), getattr(c.replay, f)), \
          (f, step)
    assert g.env_frames == c.env_frames
    assert g.telemetry.learn_steps == c.telemetry.learn_steps
    if c.telemetry.learn_steps:
      np.testing.assert_allclose(float(g.telemetry.last_loss),
                                 float(c.telemetry.last_loss), rtol=1e-4)
    for tree, ref in ((g.online_params, c.online_params),
                      (g.target_params, c.target_params)):
      diff = torch.cat([(x.cpu() - w).detach().abs().flatten()
                        for x, w in zip(leaves(tree), leaves(ref))])
      assert float(diff.max()) <= 5e-5, (step, float(diff.max()))
      assert float((diff <= 2e-6).float().mean()) >= 0.999, step
    for f in ("episode_return", "completed_count", "completed_return_sum"):
      assert torch.equal(getattr(g.telemetry, f).cpu(),
                         getattr(c.telemetry, f)), (f, step)
    groups = {d: e.env.step(actions[d]) for d, e in engines.items()}
  assert states["cpu"].telemetry.learn_steps >= 8


@pytest.mark.parametrize("batch,residuals", [(1, False), (32, False),
                                             (32, True)])
def test_k3_at_the_host_agent_shapes(dev, batch, residuals):
  """The host agent's shapes: K3a at B = 1 (act) and 32 (target), K3b at
  B = 32 (online, with its gradients against the plain convolutions under
  the kernel's own ReLU masks)."""
  ws = _torso_params(dev, 12)
  x = torch.randint(0, 256, (batch, 84, 84, 4), generator=_gen(13),
                    device=dev, dtype=torch.uint8)
  if not residuals:
    before = torso_cuda.FWD.launches
    with torch.no_grad():
      got = torso_cuda.dqn_torso(*ws, x)
    assert torso_cuda.FWD.launches == before + 1
    torch.testing.assert_close(got, torso_cuda.torso_plain(*ws, x),
                               rtol=1e-4, atol=1e-5)
    return
  out, z1, z2 = torso_cuda.torso_forward(ws, x, residuals=True)
  for a, e in zip((out, z1, z2), torso_cuda.torso_plain_residuals(*ws, x)):
    torch.testing.assert_close(a, e, rtol=1e-4, atol=1e-5)
  dy = torch.randn((batch, 3136), generator=_gen(14), device=dev)
  a = [w.clone().requires_grad_(True) for w in ws]
  b = [w.clone().requires_grad_(True) for w in ws]
  ga = torch.autograd.grad((torso_cuda.dqn_torso(*a, x) * dy).sum(), a)
  masks = [(t > 0).float() for t in (z1, z2, out.reshape(-1, 7, 7, 64))]
  gb = torch.autograd.grad(
      (torso_cuda.torso_plain_masked(*b, x, masks) * dy).sum(), b)
  for u, v in zip(ga, gb):
    assert float(torch.linalg.vector_norm(u - v)
                 / torch.linalg.vector_norm(v)) <= 1e-4


def test_host_agent_learn_steps_on_the_card_match_the_cpu(dev):
  """dqn's HostAgent on the card (K3a at B = 1 and 32, K3b at 32) and on
  the CPU (the plain torso), from one state and the same draws, over the
  same catch timesteps: the action at every frame equal, the loss within
  rtol 1e-4 and the parameters within test_torch_slice's bounds after each
  learn step."""
  import dataclasses
  from dqn_zoo_torch import processors
  from dqn_zoo_torch.agents import get_agent
  from dqn_zoo_torch.engine.superstep import leaves
  from dqn_zoo_torch.envs.dm_adapter import GameEnvironment
  from dqn_zoo_torch.host_agent import HostAgent
  spec = dataclasses.replace(get_agent("dqn"),
                             min_replay_capacity_fraction=0.1,
                             target_network_update_period=48)
  agents = {d: HostAgent(spec, 3, np.zeros((84, 84, 4), np.uint8), seed=0,
                         preprocessor=processors.atari(),
                         replay_capacity=200, total_frames=2_000, device=d)
            for d in ("cpu", dev)}
  state = agents["cpu"].get_state()
  agents[dev].set_state({**state,
                         "generator": agents[dev].get_state()["generator"]})
  for d, agent in agents.items():
    # The same draws for both, from CPU generators of one seed.
    def draw(kind, gen=torch.Generator().manual_seed(7), d=d):
      if kind != "act":
        return ()  # dqn's loss draws nothing
      return (torch.rand((1,), generator=gen).to(d),
              torch.randint(0, 3, (1,), generator=gen).to(d))
    agent.draw = draw
  env = GameEnvironment("catch", seed=1, max_noops=3, device="cpu")
  timestep, loss, learned = env.reset(), None, 0
  for frame in range(200):
    actions = {d: a.step(timestep) for d, a in agents.items()}
    assert actions[dev] == actions["cpu"], frame
    c, g = agents["cpu"], agents[dev]
    if c._statistics.get("loss", loss) != loss:
      loss, learned = c._statistics["loss"], learned + 1
      np.testing.assert_allclose(g._statistics["loss"], loss, rtol=1e-4)
      for tree, ref in ((g.online_params, c.online_params),
                        (g.target_params, c.target_params)):
        diff = torch.cat([(x.cpu() - w).detach().abs().flatten()
                          for x, w in zip(leaves(tree), leaves(ref))])
        assert float(diff.max()) <= 5e-5, (frame, float(diff.max()))
        assert float((diff <= 2e-6).float().mean()) >= 0.999, frame
    if timestep.last():
      for a in agents.values():
        a.reset()
      timestep = env.reset()
    else:
      timestep = env.step(actions["cpu"])
  assert learned >= 5 and agents["cpu"]._replay.size >= 20


def test_one_rank_nccl_trainer_equals_the_engine(dev, tmp_path):
  """DistributedTrainer at world size 1 over NCCL against a plain Engine
  from one state and generator (the same draws), 30 supersteps of
  dqn/catch past the min fill under cuDNN's deterministic algorithms: the
  gradient all-reduce is a SUM over one rank divided by 1, so every entry
  of the two states is equal bit for bit."""
  import dataclasses
  import torch.distributed as dist
  from dqn_zoo_torch.engine import Engine
  from dqn_zoo_torch.run import checkpoint as ckpt
  from dqn_zoo_torch.run import train_dist
  dist.init_process_group("nccl", store=dist.FileStore(
      str(tmp_path / "store"), 1), rank=0, world_size=1)
  deterministic = torch.backends.cudnn.deterministic
  try:
    trainer = train_dist.build_trainer(
        "dqn", "catch", 1, 8, 2048, min_replay_capacity_fraction=0.02,
        device=dev)
    engine = Engine(dataclasses.replace(trainer.engine.config,
                                        pmap_axis=None), device=dev)
    a = trainer.init(0)
    b = ckpt.restore_state(engine.init(1), ckpt.flatten_state(a))
    torch.backends.cudnn.deterministic = True
    a = trainer.run(a, 30)
    b = engine.run(b, 30)
    assert a.telemetry.learn_steps >= 10
    got, want = ckpt.flatten_state(a), ckpt.flatten_state(b)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
      if isinstance(v, torch.Tensor):
        assert torch.equal(got[k].reshape(-1).contiguous().view(torch.uint8),
                           v.reshape(-1).contiguous().view(torch.uint8)), k
      else:
        assert got[k] == v, k
  finally:
    torch.backends.cudnn.deterministic = deterministic
    dist.destroy_process_group()
