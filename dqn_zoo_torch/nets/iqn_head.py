"""Kernels K4a, K4b, K4c: the fused IQN per-τ head on the card.

Port of dqn_zoo_tpu/nets/iqn_head.py (`iqn_head_fused` and its custom VJP).
The IQN network applies a shared value head to `tau_embedding *
state_embedding` for every τ sample. For rows = (stream, τ) pairs with τ
minor,

    te  = relu(cos_emb @ we + be)          # (rows, D)   τ embedding
    hi  = te * s_emb[row // S]             # (rows, D)   head input
    h   = relu(hi @ wh + bh)               # (rows, H)
    q   = h @ wo + bo                      # (rows, A)

K4a (csrc/iqn_head.cu) is the forward, in two variants:
  forward only (acting, eval and target nets, under no_grad): writes q;
  with residuals (the online net under grad): also writes h.
Its products run on the tensor cores in 3xTF32. Where the row tiles alone
leave the card idle (eval, B = 4), D is split over blocks as well
(`d_splits`) and a second kernel of the same launch adds the partials.
The backward (csrc/iqn_head_bwd.cu) follows the reference's `_iqn_head_bwd`:
the wo-layer gradients dwo, dbo and dh = (dq @ woᵀ)·(h > 0) are plain ops on
the saved h; then, from dh and the recomputed te and hi,
  K4b `iqn_head_bwd_w`: dwh = hiᵀ @ dh, dbh = Σ_rows dh;
  K4c `iqn_head_bwd_d`: dhi = dh @ whᵀ, ds_emb, dte, dwe, dbe and, when the
      cosine features want a gradient, dcos.
Both run their products (te_pre and dwh; te_pre, dhi and dwe) on the tensor
cores in 3xTF32, as K4a does.
In all three the (rows, D) intermediates never reach device memory. The
kernels index s_emb[row // S] directly, so they take any B, S, A >= 1; the
latent width (64), the hidden width (512) and D a multiple of 32 are fixed
by the sources.

`iqn_head_plain` is the forward's plain version, line for line the
reference's `iqn_head_xla`, and differentiable by autograd.
`iqn_head_bwd_w_plain` and `iqn_head_bwd_d_plain` write the two backward
kernels' arithmetic out step by step (no autograd). `iqn_head` takes the
plain version for CPU tensors only; on CUDA it launches K4a and, under grad,
goes through the autograd Function `_IqnHead`, whose backward launches K4b
and K4c.

`mm` is the reference's operand type of the heavy products (its `_dot`):
None (f32) or torch.bfloat16. Under bf16 the operands of cos @ we, hi @ wh
and h @ wo (K4a), of cos @ we and hiᵀ @ dh (K4b) and of cos @ we, dh @ whᵀ,
cosᵀ @ dte and dte @ weᵀ (K4c) are rounded to bf16 (to nearest even) and
the products accumulate in f32; the stream broadcast, h as stored, ds_emb,
dbe, dbh and the wo-layer gradients stay f32. The gradients are then the
reference's custom VJP, not autograd through the casts: `_IqnHead` is taken
on both devices, with the plain functions on the CPU and K4a, K4b and K4c
in their bf16 mode (registered apart, `*_bf16`) on the card. Each is a
kernel of its own on bf16 tensor cores (`wgmma`): K4a's in
csrc/iqn_head_bf16.cu, reading the weights as one staging pass
(`iqn_head_stage_fwd_bf16`) lays them out for its shared-memory stages,
rounded once a launch; K4b's and K4c's in csrc/iqn_head_bwd_bf16.cu,
reading bf16 copies of dh, cos, we and wh that one staging pass
(`iqn_head_stage_bf16`, which also sums dbh) writes for both.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dqn_zoo_torch import kernels

LATENT = 64  # cosine features per τ sample (kL in the source)
HIDDEN = 512  # hidden width (kH)
D_MULTIPLE = 32  # the source walks D in chunks of 32 (kKC)
ROWS_PER_BLOCK = 64  # rows of one forward block (kM)
SMS = 132  # streaming multiprocessors of an H100 SXM
# The bf16 backward kernels' tiles (csrc/iqn_head_bwd_bf16.cu): columns of
# D a block owns (kBD, kCD), columns of H a K4b block owns (kBH), rows of a
# chunk (kRC), and the most row groups the wrappers cut the rows into.
BF16_TILE_D = 128
BF16_TILE_H = 256
BF16_CHUNK = 64
BF16_MAX_GROUPS = 16
# K4a's bf16 kernel (csrc/iqn_head_bf16.cu): rows a block owns (kM; it owns
# BF16_TILE_H columns of H), rows of D a chunk (kKC), and the bytes of one
# chunk of the staged weights (kChunkB: wh's two column halves and we^T in
# bf16, be in f32).
BF16_FWD_ROWS = 128
BF16_FWD_CHUNK = 64
BF16_FWD_CHUNK_BYTES = (2 * BF16_FWD_CHUNK * BF16_TILE_H * 2
                        + BF16_FWD_CHUNK * LATENT * 2 + BF16_FWD_CHUNK * 4)

_ARGS = [kernels.P] * 11 + [kernels.I] * 7 + [kernels.P]
FWD = kernels.register(kernels.Kernel(
    "iqn_head_fwd", "iqn_head.cu", "dz_iqn_head", _ARGS))
FWD_RES = kernels.register(kernels.Kernel(
    "iqn_head_fwd_residuals", "iqn_head.cu", "dz_iqn_head", _ARGS))
BWD_W = kernels.register(kernels.Kernel(
    "iqn_head_bwd_w", "iqn_head_bwd.cu", "dz_iqn_head_bwd_w",
    [kernels.P] * 7 + [kernels.I] * 4 + [kernels.P]))
BWD_D = kernels.register(kernels.Kernel(
    "iqn_head_bwd_d", "iqn_head_bwd.cu", "dz_iqn_head_bwd_d",
    [kernels.P] * 12 + [kernels.I] * 4 + [kernels.P]))
# K4a with its product operands rounded to bf16 (mm=bf16): a kernel of its
# own (csrc/iqn_head_bf16.cu) on the weights its staging pass lays out.
_ARGS_BF16 = [kernels.P] * 10 + [kernels.I] * 7 + [kernels.P]
FWD_BF16 = kernels.register(kernels.Kernel(
    "iqn_head_fwd_bf16", "iqn_head_bf16.cu", "dz_iqn_head_fwd_bf16",
    _ARGS_BF16))
FWD_RES_BF16 = kernels.register(kernels.Kernel(
    "iqn_head_fwd_residuals_bf16", "iqn_head_bf16.cu", "dz_iqn_head_fwd_bf16",
    _ARGS_BF16))
STAGE_FWD_BF16 = kernels.register(kernels.Kernel(
    "iqn_head_stage_fwd_bf16", "iqn_head_bf16.cu",
    "dz_iqn_head_stage_fwd_bf16", [kernels.P] * 4 + [kernels.I, kernels.P]))
# K4b and K4c in bf16 mode are kernels of their own (csrc/iqn_head_bwd_bf16.cu),
# fed by a staging pass that rounds their operands to bf16 once.
STAGE_BF16 = kernels.register(kernels.Kernel(
    "iqn_head_stage_bf16", "iqn_head_bwd_bf16.cu", "dz_iqn_head_stage_bf16",
    [kernels.P] * 10 + [kernels.I] * 2 + [kernels.P]))
BWD_W_BF16 = kernels.register(kernels.Kernel(
    "iqn_head_bwd_w_bf16", "iqn_head_bwd_bf16.cu", "dz_iqn_head_bwd_w_bf16",
    BWD_W.argtypes))
BWD_D_BF16 = kernels.register(kernels.Kernel(
    "iqn_head_bwd_d_bf16", "iqn_head_bwd_bf16.cu", "dz_iqn_head_bwd_d_bf16",
    BWD_D.argtypes))


def matmul_dtype(mm):
  """None for f32 operands (None or torch.float32), torch.bfloat16 for
  bf16 ones; ValueError on anything else."""
  if mm is None or mm == torch.float32:
    return None
  if mm == torch.bfloat16:
    return mm
  raise ValueError(f"iqn_head: mm must be None, torch.float32 or "
                   f"torch.bfloat16; got {mm}.")


def _rounder(mm):
  """t -> t rounded to mm and back to f32 (identity for f32 operands)."""
  if mm is None:
    return lambda t: t
  return lambda t: t.to(mm).to(torch.float32)


def iqn_head_plain_residuals(we, be, wh, bh, wo, bo, cos_emb, s_emb,
                             mm=None):
  """(q (B, S, A), h (B·S, H)) through plain PyTorch ops; h unrounded."""
  r = _rounder(mm)
  b, s, l = cos_emb.shape
  d = s_emb.shape[1]
  te = torch.relu(r(cos_emb.reshape(b * s, l)) @ r(we) + be)
  hi = te.reshape(b, s, d) * s_emb[:, None, :]
  h = torch.relu(r(hi.reshape(b * s, d)) @ r(wh) + bh)
  q = r(h) @ r(wo) + bo
  return q.reshape(b, s, -1), h


def iqn_head_plain(we, be, wh, bh, wo, bo, cos_emb, s_emb,
                   mm=None) -> torch.Tensor:
  """q (B, S, A) from cos_emb (B, S, latent) and s_emb (B, D)."""
  return iqn_head_plain_residuals(we, be, wh, bh, wo, bo, cos_emb, s_emb,
                                  mm)[0]


def _dims(cos_emb, s_emb, a: int):
  """(B, S, D) of a call; raises ValueError on what the kernels do not take."""
  if cos_emb.dim() != 3 or s_emb.dim() != 2:
    raise ValueError(
        "iqn_head takes cos_emb (B, S, latent) and s_emb (B, D); got "
        f"{tuple(cos_emb.shape)} and {tuple(s_emb.shape)}.")
  b, s, l = cos_emb.shape
  d = s_emb.shape[1]
  if l != LATENT or d % D_MULTIPLE or min(b, s, d, a) < 1 or \
      max(b * s * HIDDEN, b * d) >= 2**31:
    raise ValueError(
        f"iqn_head kernel: latent must be {LATENT}, D a multiple of "
        f"{D_MULTIPLE}, B, S, A >= 1 and B·S·{HIDDEN} < 2^31; got latent {l}, "
        f"D {d}, B {b}, S {s}, A {a}.")
  return b, s, d


def _check_tensors(tensors, shapes) -> None:
  """Every tensor float32, of its shape, contiguous, 16-byte aligned and on
  one CUDA device; raises ValueError otherwise."""
  for name, t in tensors.items():
    if t.dtype != torch.float32 or tuple(t.shape) != shapes[name]:
      raise ValueError(f"iqn_head {name}: need float32 of shape "
                       f"{shapes[name]}; got {t.dtype} {tuple(t.shape)}.")
  for name, t in tensors.items():
    if not t.is_contiguous() or t.data_ptr() % 16:
      raise ValueError(f"iqn_head {name}: need a contiguous, 16-byte "
                       "aligned tensor.")
  first, dev = next((n, t.device) for n, t in tensors.items())
  for name, t in tensors.items():
    if t.device != dev or dev.type != "cuda":
      raise ValueError(f"iqn_head {name}: every tensor must lie on one CUDA "
                       f"device; got {t.device} beside {first} on {dev}.")


def _check(we, be, wh, bh, wo, bo, cos_emb, s_emb) -> None:
  """Raises ValueError on what the forward kernel does not take."""
  if wo.dim() != 2:
    raise ValueError(f"iqn_head takes wo (H, A); got {tuple(wo.shape)}.")
  a = wo.shape[1]
  b, s, d = _dims(cos_emb, s_emb, a)
  shapes = {"we": (LATENT, d), "be": (d,), "wh": (d, HIDDEN),
            "bh": (HIDDEN,), "wo": (HIDDEN, a), "bo": (a,),
            "cos_emb": (b, s, LATENT), "s_emb": (b, d)}
  _check_tensors(dict(zip(shapes, (we, be, wh, bh, wo, bo, cos_emb, s_emb))),
                 shapes)


def _check_bwd(we, be, wh, cos_emb, s_emb, dh):
  """(B, S, D); raises ValueError on what the backward kernels do not take.
  `wh` is None for K4b, which does not read it."""
  b, s, d = _dims(cos_emb, s_emb, 1)
  shapes = {"we": (LATENT, d), "be": (d,), "cos_emb": (b, s, LATENT),
            "s_emb": (b, d), "dh": (b * s, HIDDEN)}
  tensors = {"we": we, "be": be, "cos_emb": cos_emb, "s_emb": s_emb,
             "dh": dh}
  if wh is not None:
    shapes["wh"], tensors["wh"] = (d, HIDDEN), wh
  _check_tensors(tensors, shapes)
  return b, s, d


def d_splits(b: int, s: int, d: int = 3136) -> int:
  """Runs of whole 32-column chunks that K4a cuts D into, one block each,
  beside the row tiles of 64 rows. 1 where the tiles alone fill a card of
  132 SMs to one block each as well as a split would (more than 66 tiles:
  the act shape B = 128 and both learn shapes); else as many as keep tiles
  × splits within 132 (33 at B = 4, S = 64; 49 at B = 3, S = 24)."""
  tiles = -(-b * s // ROWS_PER_BLOCK)
  chunks = d // D_MULTIPLE
  per = -(-chunks // max(1, SMS // tiles))
  return -(-chunks // per)


def chunks_per_split(splits: int, d: int = 3136) -> int:
  """Chunks each split walks; the last may walk fewer, and none walks
  none."""
  return -(-(d // D_MULTIPLE) // splits)


def bf16_fwd_splits(b: int, s: int, d: int = 3136) -> int:
  """Runs of whole 64-row chunks of D that K4a's bf16 kernel cuts D into,
  beside its blocks of 128 rows x one half of H, as `d_splits` does for the
  f32 kernel: 1 where the blocks alone number more than 66 (128 at the act
  shape B = 128, 1,024 and 2,048 at the learn shapes); else as many as keep
  blocks x splits within 132 (25 at B = 4, S = 64; 49 at B = 3, S = 24)."""
  tiles = -(-b * s // BF16_FWD_ROWS) * (HIDDEN // BF16_TILE_H)
  chunks = -(-d // BF16_FWD_CHUNK)
  per = -(-chunks // max(1, SMS // tiles))
  return -(-chunks // per)


def bf16_fwd_chunks_per_split(splits: int, d: int = 3136) -> int:
  """64-row chunks each split walks; the last may walk fewer, none none."""
  return -(-(-(-d // BF16_FWD_CHUNK)) // splits)


def _swizzled(x):
  """x (..., rows, 8 pieces, 8 values) with piece p of row r moved to
  p ^ (r & 7): the 128-byte swizzle of the kernels' shared-memory tiles."""
  r = torch.arange(x.shape[-3], device=x.device)
  p = torch.arange(8, device=x.device)
  return x[..., r[:, None], p[None, :] ^ (r[:, None] & 7), :]


def iqn_head_stage_fwd_bf16_plain(we, be, wh) -> torch.Tensor:
  """The plain version of K4a's bf16 staging pass: (ceil(D / 64),
  BF16_FWD_CHUNK_BYTES) bytes, chunk c holding rows 64 c .. 64 c + 63 of D
  as the kernel's stage does: wh rounded to bf16 as [half][block of 64
  columns][row][128 bytes], we^T (D, latent) rounded to bf16 as [row][128
  bytes], both swizzled, then be in f32; rows past D zero."""
  d, bf, c = wh.shape[0], torch.bfloat16, -(-wh.shape[0] // BF16_FWD_CHUNK)
  whp = torch.zeros((c * BF16_FWD_CHUNK, HIDDEN), dtype=bf, device=wh.device)
  whp[:d] = wh.to(bf)
  # (chunk, row, half, block, piece, value) -> [chunk][half][block][row]...
  wh_img = _swizzled(whp.view(c, BF16_FWD_CHUNK, 2, 4, 8, 8)
                     .permute(0, 2, 3, 1, 4, 5))
  wet = torch.zeros((c * BF16_FWD_CHUNK, LATENT), dtype=bf, device=we.device)
  wet[:d] = we.t().to(bf)
  we_img = _swizzled(wet.view(c, BF16_FWD_CHUNK, 8, 8))
  bep = torch.zeros((c * BF16_FWD_CHUNK,), dtype=torch.float32,
                    device=be.device)
  bep[:d] = be
  return torch.cat([t.reshape(c, -1).view(torch.uint8)
                    for t in (wh_img, we_img, bep)], dim=1)


def iqn_head_stage_fwd_bf16(we, be, wh) -> torch.Tensor:
  """Launches K4a's bf16 staging pass (the layout of
  iqn_head_stage_fwd_bf16_plain). CPU tensors take the plain version."""
  if we.device.type == "cpu":
    return iqn_head_stage_fwd_bf16_plain(we, be, wh)
  d = wh.shape[0]
  if d % D_MULTIPLE or d < 1:
    raise ValueError(f"iqn_head: D must be a positive multiple of "
                     f"{D_MULTIPLE}; got {d}.")
  _check_tensors({"we": we, "be": be, "wh": wh},
                 {"we": (LATENT, d), "be": (d,), "wh": (d, HIDDEN)})
  img = torch.empty((-(-d // BF16_FWD_CHUNK), BF16_FWD_CHUNK_BYTES),
                    dtype=torch.uint8, device=we.device)
  STAGE_FWD_BF16.launch(we.data_ptr(), be.data_ptr(), wh.data_ptr(),
                        img.data_ptr(), d, kernels.stream_ptr(we.device))
  return img


def iqn_head_forward(we, be, wh, bh, wo, bo, cos_emb, s_emb,
                     residuals: bool, mm=None, staged=None):
  """Launches K4a (its bf16 kernel for mm=bf16): returns q (B, S, A), or
  (q, h (B·S, H)) with residuals.
  Takes no gradient: the tensors' autograd history is not followed. With
  `d_splits` > 1 the blocks' partials of hi @ wh go through a scratch
  buffer of (splits, B·S, H) floats. For mm=bf16 the kernel reads the
  weights as `staged` (iqn_head_stage_fwd_bf16's result for these we, be
  and wh; staged here when None) and, with one split, adds the halves of q
  of its two column halves through a (2, B·S, A) scratch."""
  _check(we, be, wh, bh, wo, bo, cos_emb, s_emb)
  b, s, _ = cos_emb.shape
  d, a = s_emb.shape[1], wo.shape[1]
  dev = cos_emb.device
  new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
  q = new(b, s, a)
  h = new(b * s, HIDDEN) if residuals else None
  if matmul_dtype(mm) is not None:
    img = iqn_head_stage_fwd_bf16(we, be, wh) if staged is None else staged
    if tuple(img.shape) != (-(-d // BF16_FWD_CHUNK), BF16_FWD_CHUNK_BYTES) \
        or img.dtype != torch.uint8 or img.device != dev or \
        not img.is_contiguous():
      raise ValueError("iqn_head: `staged` is not the staging of these "
                       "weights.")
    splits = bf16_fwd_splits(b, s, d)
    part = new(splits, b * s, HIDDEN) if splits > 1 else None
    qpart = new(2, b * s, a) if splits == 1 else None
    kernel = FWD_RES_BF16 if residuals else FWD_BF16
    kernel.launch(cos_emb.data_ptr(), s_emb.data_ptr(), img.data_ptr(),
                  bh.data_ptr(), wo.data_ptr(), bo.data_ptr(), q.data_ptr(),
                  _ptr(h), _ptr(part), _ptr(qpart), b, s, d, a,
                  int(residuals), splits,
                  bf16_fwd_chunks_per_split(splits, d),
                  kernels.stream_ptr(dev))
    return (q, h) if residuals else q
  splits = d_splits(b, s, d)
  part = new(splits, b * s, HIDDEN) if splits > 1 else None
  kernel = FWD_RES if residuals else FWD
  kernel.launch(cos_emb.data_ptr(), s_emb.data_ptr(), we.data_ptr(),
                be.data_ptr(), wh.data_ptr(), bh.data_ptr(), wo.data_ptr(),
                bo.data_ptr(), q.data_ptr(), _ptr(h), _ptr(part), b, s, d, a,
                int(residuals), splits, chunks_per_split(splits, d),
                kernels.stream_ptr(dev))
  return (q, h) if residuals else q


# --- backward: plain versions --------------------------------------------------


def iqn_head_bwd_w_plain(we, be, cos_emb, s_emb, dh, mm=None):
  """(dwh (D, H), dbh (H)) from dh (B·S, H), the cotangent of the hidden
  pre-activation: the arithmetic of the reference's `_bwd_w_kernel`."""
  r = _rounder(mm)
  b, s, l = cos_emb.shape
  te = torch.relu(r(cos_emb.reshape(b * s, l)) @ r(we) + be)
  hi = te * s_emb.repeat_interleave(s, dim=0)
  return r(hi).t() @ r(dh), dh.sum(dim=0)


def iqn_head_bwd_d_plain(we, be, wh, cos_emb, s_emb, dh,
                         need_dcos: bool = True, te_mask=None, mm=None):
  """(dwe (latent, D), dbe (D), ds_emb (B, D), dcos (B, S, latent) or None)
  from dh: the arithmetic of the reference's `_bwd_d_kernel`. `te_mask`
  (B·S, D), when given, stands in for te_pre > 0 (a check hands in the
  kernel's own branch bits, see csrc/iqn_head_bwd.cu)."""
  r = _rounder(mm)
  b, s, l = cos_emb.shape
  d = s_emb.shape[1]
  cos2 = r(cos_emb.reshape(b * s, l))
  te_pre = cos2 @ r(we) + be
  te = torch.relu(te_pre)
  dhi = r(dh) @ r(wh).t()
  ds_emb = (dhi * te).reshape(b, s, d).sum(dim=1)
  mask = te_pre > 0 if te_mask is None else te_mask.bool()
  dte = torch.where(mask, dhi * s_emb.repeat_interleave(s, dim=0),
                    torch.zeros_like(dhi))
  dcos = (r(dte) @ r(we).t()).reshape(b, s, l) if need_dcos else None
  return cos2.t() @ r(dte), dte.sum(dim=0), ds_emb, dcos


def iqn_head_plain_masked(we, be, wh, bh, wo, bo, cos_emb, s_emb, te_mask,
                          h_mask):
  """The plain head with given ReLU masks ((B·S, D) and (B·S, H)) in place
  of its own: autograd through it is a reference for the kernels' gradients
  that does not depend on which branch a pre-activation within f32 rounding
  of 0 took."""
  b, s, l = cos_emb.shape
  d = s_emb.shape[1]
  te = (cos_emb.reshape(b * s, l) @ we + be) * te_mask
  hi = te.reshape(b, s, d) * s_emb[:, None, :]
  h = (hi.reshape(b * s, d) @ wh + bh) * h_mask
  return (h @ wo + bo).reshape(b, s, -1)


# --- backward: the kernels -----------------------------------------------------


def row_groups(b: int, s: int) -> int:
  """Groups of streams the backward kernels' grids cut the rows into. One
  block per 32 columns of D is 98 blocks at D = 3136; with 4 groups the 392
  blocks fill a card of 132 SMs in three rounds. A group holds whole
  streams and at least 1024 rows, so small shapes stay whole."""
  return max(1, min(4, b, b * s // 1024))


def _sums_and_partials(n: int, groups: int, dev):
  """The kernels' walk-long sums as one run of n floats, and the scratch
  for the groups' partials (None when the rows are not cut)."""
  out = torch.empty((n,), dtype=torch.float32, device=dev)
  part = torch.empty((groups, n), dtype=torch.float32,
                     device=dev) if groups > 1 else None
  return out, part


def _ptr(t):
  return None if t is None else t.data_ptr()


def _fill_groups(units: int, tiles: int, chunks_of, part_chunks=0.0) -> int:
  """Groups of consecutive units (64-row chunks or streams) the bf16
  kernels' grids cut the rows into, beside `tiles` blocks each: of the
  counts up to BF16_MAX_GROUPS (and `units`) that give the card's 132 SMs a
  block each (where none does, of all), the one of least cost, in a
  block's chunk times: waves x the chunks a group walks (`chunks_of(n)` for
  a group of n units), plus `part_chunks` a group for writing its partial
  sums and reading them back."""
  counts = range(1, min(BF16_MAX_GROUPS, units) + 1)
  fill = [g for g in counts if tiles * g >= SMS] or list(counts)
  return min(fill, key=lambda g: (-(-tiles * g // SMS) * chunks_of(
      -(-units // g)) + part_chunks * g, g))


def bf16_tiles_d(d: int) -> int:
  """Tiles of D (128 columns, the last ragged) of the bf16 kernels."""
  return -(-d // BF16_TILE_D)


def bf16_groups_w(b: int, s: int, d: int = 3136) -> int:
  """Row groups of K4b in bf16 mode: whole 64-row chunks (5 at the learn
  shape: 250 blocks of 128 x 256, two waves). A group's partial dwh, 6.4 MB
  written and read back (~4 us at 3.35 TB/s), costs ~4 chunk times (a
  block's chunk is 5.2 MFLOP, ~1.2 us at 600 TFLOP/s over 132 SMs)."""
  return _fill_groups(-(-b * s // BF16_CHUNK),
                      bf16_tiles_d(d) * (HIDDEN // BF16_TILE_H), lambda n: n,
                      part_chunks=4.0 * d / 3136)


def bf16_groups_d(b: int, s: int, d: int = 3136) -> int:
  """Row groups of K4c in bf16 mode: whole streams, as ds_emb needs (10 at
  the learn shape: 250 blocks, two waves; its partials, 0.8 MB a group,
  cost next to nothing)."""
  return _fill_groups(b, bf16_tiles_d(d), lambda n: -(-n * s // BF16_CHUNK))


class Bf16Operands(NamedTuple):
  """What the staging pass hands K4b and K4c in bf16 mode: dh (B·S, H),
  cos (B·S, latent), we transposed (D, latent) and wh (D, H) or None,
  rounded to bf16, and dbh (H) = Σ_rows dh in f32."""
  dh: torch.Tensor
  cos: torch.Tensor
  we_t: torch.Tensor
  wh: Optional[torch.Tensor]
  dbh: torch.Tensor


def iqn_head_stage_bf16_plain(we, cos_emb, dh, wh=None) -> Bf16Operands:
  """The staging pass's plain version."""
  bf = torch.bfloat16
  return Bf16Operands(dh.to(bf), cos_emb.reshape(-1, LATENT).to(bf),
                      we.t().contiguous().to(bf),
                      None if wh is None else wh.to(bf), dh.sum(dim=0))


def iqn_head_stage_bf16(we, cos_emb, dh, wh=None) -> Bf16Operands:
  """Launches the staging pass of the bf16 backward kernels: the bf16
  copies of dh, cos, we (transposed) and wh (when given) and dbh, through
  a scratch buffer of (ceil(B·S / 128), H) floats. CPU tensors take the
  plain version."""
  if cos_emb.device.type == "cpu":
    return iqn_head_stage_bf16_plain(we, cos_emb, dh, wh)
  b, s, d = _dims(cos_emb, we, 1)  # we (latent, D) gives D as s_emb would
  shapes = {"we": (LATENT, d), "cos_emb": (b, s, LATENT),
            "dh": (b * s, HIDDEN)}
  tensors = {"we": we, "cos_emb": cos_emb, "dh": dh}
  if wh is not None:
    shapes["wh"], tensors["wh"] = (d, HIDDEN), wh
  _check_tensors(tensors, shapes)
  rows, dev, bf = b * s, cos_emb.device, torch.bfloat16
  new = lambda *shape: torch.empty(shape, dtype=bf, device=dev)
  out = Bf16Operands(new(rows, HIDDEN), new(rows, LATENT), new(d, LATENT),
                     None if wh is None else new(d, HIDDEN),
                     torch.empty((HIDDEN,), dtype=torch.float32, device=dev))
  part = torch.empty((-(-rows // 128), HIDDEN), dtype=torch.float32,
                     device=dev)
  STAGE_BF16.launch(dh.data_ptr(), cos_emb.data_ptr(), we.data_ptr(),
                    _ptr(wh), out.dh.data_ptr(), out.cos.data_ptr(),
                    out.we_t.data_ptr(), _ptr(out.wh), part.data_ptr(),
                    out.dbh.data_ptr(), rows, d, kernels.stream_ptr(dev))
  return out


def _staged(we, cos_emb, dh, wh, staged):
  """`staged` (a Bf16Operands of this call's tensors, as the backward hands
  both kernels one) or a fresh staging of them."""
  if staged is None:
    return iqn_head_stage_bf16(we, cos_emb, dh, wh)
  if wh is not None and staged.wh is None:
    raise ValueError("iqn_head: the staged operands lack wh.")
  return staged


def iqn_head_bwd_w(we, be, cos_emb, s_emb, dh, mm=None, staged=None):
  """Launches K4b: (dwh (D, H), dbh (H)) from dh (B·S, H). For mm=bf16 the
  bf16 kernel on `staged` (iqn_head_stage_bf16's result for these tensors;
  staged here when None), which also gives dbh."""
  b, s, d = _check_bwd(we, be, None, cos_emb, s_emb, dh)
  dev = cos_emb.device
  if matmul_dtype(mm) is not None:
    st = _staged(we, cos_emb, dh, None, staged)
    groups = bf16_groups_w(b, s, d)
    dwh, part = _sums_and_partials(d * HIDDEN, groups, dev)
    BWD_W_BF16.launch(st.cos.data_ptr(), s_emb.data_ptr(), st.dh.data_ptr(),
                      st.we_t.data_ptr(), be.data_ptr(), dwh.data_ptr(),
                      _ptr(part), b, s, d, groups, kernels.stream_ptr(dev))
    return dwh.view(d, HIDDEN), st.dbh
  groups = row_groups(b, s)
  out, part = _sums_and_partials(d * HIDDEN + HIDDEN, groups, dev)
  BWD_W.launch(cos_emb.data_ptr(), s_emb.data_ptr(), dh.data_ptr(),
               we.data_ptr(), be.data_ptr(), out.data_ptr(), _ptr(part),
               b, s, d, groups, kernels.stream_ptr(dev))
  return out[:d * HIDDEN].view(d, HIDDEN), out[d * HIDDEN:]


def iqn_head_bwd_d(we, be, wh, cos_emb, s_emb, dh, need_dcos: bool = True,
                   return_te_mask: bool = False, mm=None, staged=None):
  """Launches K4c: (dwe (latent, D), dbe (D), ds_emb (B, D), dcos (B, S,
  latent) or None) from dh (B·S, H). dcos costs a scratch buffer of (D / 32,
  B·S, latent) floats (bf16 mode: (ceil(D / 128), B·S, latent)), summed
  over D by a small second kernel of the same launch. With `return_te_mask`
  a fifth result is the kernel's own te_pre > 0 as (B·S, D) uint8. For
  mm=bf16 the bf16 kernel on `staged`, as K4b takes it."""
  b, s, d = _check_bwd(we, be, wh, cos_emb, s_emb, dh)
  dev = cos_emb.device
  new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
  bf16 = matmul_dtype(mm) is not None
  groups = bf16_groups_d(b, s, d) if bf16 else row_groups(b, s)
  tiles = bf16_tiles_d(d) if bf16 else d // D_MULTIPLE
  out, part = _sums_and_partials(LATENT * d + d, groups, dev)
  ds_emb = new(b, d)
  dcos = dcos_part = mask = None
  if need_dcos:
    dcos, dcos_part = new(b, s, LATENT), new(tiles, b * s, LATENT)
  if return_te_mask:
    mask = torch.empty((b * s, d), dtype=torch.uint8, device=dev)
  if bf16:
    st = _staged(we, cos_emb, dh, wh, staged)
    BWD_D_BF16.launch(st.cos.data_ptr(), s_emb.data_ptr(), st.dh.data_ptr(),
                      st.we_t.data_ptr(), be.data_ptr(), st.wh.data_ptr(),
                      out.data_ptr(), _ptr(part), ds_emb.data_ptr(),
                      _ptr(dcos), _ptr(dcos_part), _ptr(mask), b, s, d,
                      groups, kernels.stream_ptr(dev))
  else:
    BWD_D.launch(cos_emb.data_ptr(), s_emb.data_ptr(), dh.data_ptr(),
                 we.data_ptr(), be.data_ptr(), wh.data_ptr(), out.data_ptr(),
                 _ptr(part), ds_emb.data_ptr(), _ptr(dcos), _ptr(dcos_part),
                 _ptr(mask), b, s, d, groups, kernels.stream_ptr(dev))
  res = (out[:LATENT * d].view(LATENT, d), out[LATENT * d:], ds_emb, dcos)
  return res + (mask,) if return_te_mask else res


def iqn_head_backward(we, be, wh, wo, cos_emb, s_emb, h, dq, bwd_w, bwd_d,
                      need_dcos: bool = True, mm=None, stage=None):
  """The reference's `_iqn_head_bwd`: gradients of the eight arguments (in
  their order) from dq (B, S, A) and the saved h. The wo-layer gradients are
  plain f32 ops; `bwd_w` and `bwd_d` are the two kernels' wrappers or their
  plain versions, given `mm`. `stage`, when given (the bf16 kernels'
  `iqn_head_stage_bf16`), stages dh once for both, which then take it as
  `staged`."""
  b, s, _ = cos_emb.shape
  dq2 = dq.reshape(b * s, -1)
  dwo = h.t() @ dq2
  dbo = dq2.sum(dim=0)
  dh = (dq2 @ wo.t()) * (h > 0)
  kw = {} if stage is None else dict(staged=stage(we, cos_emb, dh, wh))
  dwh, dbh = bwd_w(we, be, cos_emb, s_emb, dh, mm=mm, **kw)
  dwe, dbe, ds_emb, dcos = bwd_d(we, be, wh, cos_emb, s_emb, dh,
                                 need_dcos=need_dcos, mm=mm, **kw)
  return dwe, dbe, dwh, dbh, dwo, dbo, dcos, ds_emb


class _IqnHead(torch.autograd.Function):
  """The reference's custom VJP. On the card: K4a with residuals forward;
  backward by the wo-layer's plain ops, then K4b and K4c (in bf16 mode
  after one staging pass). On the CPU (taken for mm=bf16 only): the plain
  versions of the same steps."""

  @staticmethod
  def forward(ctx, we, be, wh, bh, wo, bo, cos_emb, s_emb, mm):
    args = (we, be, wh, bh, wo, bo, cos_emb, s_emb)
    if cos_emb.device.type == "cpu":
      q, h = iqn_head_plain_residuals(*args, mm=mm)
    else:
      q, h = iqn_head_forward(*args, residuals=True, mm=mm)
    ctx.save_for_backward(we, be, wh, wo, cos_emb, s_emb, h)
    ctx.mm = mm
    return q

  @staticmethod
  def backward(ctx, dq):
    stage = None
    if dq.device.type == "cpu":
      bwd_w, bwd_d = iqn_head_bwd_w_plain, iqn_head_bwd_d_plain
    else:
      bwd_w, bwd_d = iqn_head_bwd_w, iqn_head_bwd_d
      if ctx.mm is not None:
        stage = iqn_head_stage_bf16
    grads = iqn_head_backward(*ctx.saved_tensors, dq.contiguous(), bwd_w,
                              bwd_d, need_dcos=ctx.needs_input_grad[6],
                              mm=ctx.mm, stage=stage)
    return grads + (None,)


def iqn_head(we, be, wh, bh, wo, bo, cos_emb, s_emb,
             mm=None) -> torch.Tensor:
  """q (B, S, A) from cosine τ features and the torso embedding; `mm` the
  products' operand type (None or torch.float32: f32; torch.bfloat16).

  CPU tensors take the plain version (for f32, differentiable by autograd;
  for bf16, inside the autograd Function when a gradient is wanted). On
  CUDA the kernels are launched: K4a with residuals inside the autograd
  Function (backward K4b and K4c) when a gradient is wanted, else K4a
  forward only."""
  mm = matmul_dtype(mm)
  args = (we, be, wh, bh, wo, bo, cos_emb, s_emb)
  cpu = cos_emb.device.type == "cpu"
  if cpu and mm is None:
    return iqn_head_plain(*args)
  if torch.is_grad_enabled() and any(t.requires_grad for t in args):
    return _IqnHead.apply(*args, mm)
  if cpu:
    return iqn_head_plain(*args, mm=mm)
  return iqn_head_forward(*args, residuals=False, mm=mm)


def bound_counts(b: int, s: int, a: int, residuals: bool, d: int = 3136):
  """(bytes, flops) K4a must move and do: every input read once, q (and h)
  written once; two flops per multiply-add of the three products."""
  rows = b * s
  floats = (rows * LATENT + b * d + LATENT * d + d + d * HIDDEN + HIDDEN
            + HIDDEN * a + a + rows * a)
  if residuals:
    floats += rows * HIDDEN
  return 4 * floats, 2 * rows * (LATENT * d + d * HIDDEN + HIDDEN * a)


def bound_counts_bwd_w(b: int, s: int, d: int = 3136):
  """(bytes, flops) K4b must move and do: cos, s_emb, dh, we, be read once,
  dwh and dbh written once; the te recompute and the dwh product."""
  rows = b * s
  floats = (rows * LATENT + b * d + rows * HIDDEN + LATENT * d + d
            + d * HIDDEN + HIDDEN)
  return 4 * floats, 2 * rows * (LATENT * d + d * HIDDEN)


def bound_counts_bwd_d(b: int, s: int, need_dcos: bool, d: int = 3136):
  """(bytes, flops) K4c must move and do: K4b's inputs and wh read once,
  dwe, dbe, ds_emb (and dcos) written once; the te recompute and the dhi and
  dwe products (and dcos's)."""
  rows = b * s
  floats = (rows * LATENT + b * d + rows * HIDDEN + LATENT * d + d
            + d * HIDDEN + LATENT * d + d + b * d)
  products = 2 * LATENT * d + d * HIDDEN
  if need_dcos:
    floats += rows * LATENT
    products += LATENT * d
  return 4 * floats, 2 * rows * products


def bound_counts_stage_fwd_bf16(d: int = 3136):
  """(bytes, flops) K4a's bf16 staging pass must move and do: we, be and wh
  read once in f32, their staged image written once (bf16 we and wh, f32
  be); no arithmetic but the rounding."""
  elems = LATENT * d + d * HIDDEN
  return 4 * (elems + d) + 2 * elems + 4 * d, 0


def bound_counts_stage_bf16(b: int, s: int, d: int = 3136):
  """(bytes, flops) the staging pass must move and do as the backward runs
  it: dh, cos, we and wh read once in f32 and written once in bf16, dbh
  written; one add an element of dh."""
  rows = b * s
  elems = rows * HIDDEN + rows * LATENT + LATENT * d + d * HIDDEN
  return 6 * elems + 4 * HIDDEN, rows * HIDDEN
