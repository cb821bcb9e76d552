"""Kernel K4a: the fused IQN per-τ head forward on the card.

Port of dqn_zoo_tpu/nets/iqn_head.py (`iqn_head_fused`, forward half). The
IQN network applies a shared value head to `tau_embedding * state_embedding`
for every τ sample. For rows = (stream, τ) pairs with τ minor,

    te  = relu(cos_emb @ we + be)          # (rows, D)   τ embedding
    hi  = te * s_emb[row // S]             # (rows, D)   head input
    h   = relu(hi @ wh + bh)               # (rows, H)
    q   = h @ wo + bo                      # (rows, A)

The CUDA source is csrc/iqn_head.cu, in two variants:
  forward only (acting, eval and target nets, under no_grad): writes q;
  with residuals (the online net under grad): also writes h, which the
      backward kernels will read.
In both, the two (rows, D) intermediates never reach device memory. The
kernel indexes s_emb[row // S] directly, so it takes any B, S, A >= 1; the
latent width (64), the hidden width (512) and D a multiple of 32 are fixed
by the source.

`iqn_head_plain` is the plain version, line for line the reference's
`iqn_head_xla`, and differentiable by autograd. The backward kernels (dwh,
dbh; dwe, dbe, ds_emb, dcos) are not ported yet: `iqn_head` on CUDA tensors
under grad raises.
"""

from __future__ import annotations

import torch

from dqn_zoo_torch import kernels

LATENT = 64  # cosine features per τ sample (kL in the source)
HIDDEN = 512  # hidden width (kH)
D_MULTIPLE = 32  # the source walks D in chunks of 32 (kKC)

_ARGS = [kernels.P] * 10 + [kernels.I] * 5 + [kernels.P]
FWD = kernels.register(kernels.Kernel(
    "iqn_head_fwd", "iqn_head.cu", "dz_iqn_head", _ARGS))
FWD_RES = kernels.register(kernels.Kernel(
    "iqn_head_fwd_residuals", "iqn_head.cu", "dz_iqn_head", _ARGS))


def iqn_head_plain_residuals(we, be, wh, bh, wo, bo, cos_emb, s_emb):
  """(q (B, S, A), h (B·S, H)) through plain PyTorch ops."""
  b, s, l = cos_emb.shape
  d = s_emb.shape[1]
  te = torch.relu(cos_emb.reshape(b * s, l) @ we + be)
  hi = te.reshape(b, s, d) * s_emb[:, None, :]
  h = torch.relu(hi.reshape(b * s, d) @ wh + bh)
  q = h @ wo + bo
  return q.reshape(b, s, -1), h


def iqn_head_plain(we, be, wh, bh, wo, bo, cos_emb, s_emb) -> torch.Tensor:
  """q (B, S, A) from cos_emb (B, S, latent) and s_emb (B, D)."""
  return iqn_head_plain_residuals(we, be, wh, bh, wo, bo, cos_emb, s_emb)[0]


def _check(we, be, wh, bh, wo, bo, cos_emb, s_emb) -> None:
  """Raises ValueError on what the kernel does not take."""
  if cos_emb.dim() != 3 or s_emb.dim() != 2 or wo.dim() != 2:
    raise ValueError(
        "iqn_head takes cos_emb (B, S, latent), s_emb (B, D) and wo (H, A); "
        f"got {tuple(cos_emb.shape)}, {tuple(s_emb.shape)}, "
        f"{tuple(wo.shape)}.")
  b, s, l = cos_emb.shape
  d, a = s_emb.shape[1], wo.shape[1]
  if l != LATENT or d % D_MULTIPLE or min(b, s, d, a) < 1 or \
      max(b * s * HIDDEN, b * d) >= 2**31:
    raise ValueError(
        f"iqn_head kernel: latent must be {LATENT}, D a multiple of "
        f"{D_MULTIPLE}, B, S, A >= 1 and B·S·{HIDDEN} < 2^31; got latent {l}, "
        f"D {d}, B {b}, S {s}, A {a}.")
  shapes = {"we": (l, d), "be": (d,), "wh": (d, HIDDEN), "bh": (HIDDEN,),
            "wo": (HIDDEN, a), "bo": (a,), "cos_emb": (b, s, l),
            "s_emb": (b, d)}
  tensors = dict(zip(shapes, (we, be, wh, bh, wo, bo, cos_emb, s_emb)))
  for name, t in tensors.items():
    if t.dtype != torch.float32 or tuple(t.shape) != shapes[name]:
      raise ValueError(f"iqn_head {name}: need float32 of shape "
                       f"{shapes[name]}; got {t.dtype} {tuple(t.shape)}.")
  for name, t in tensors.items():
    if not t.is_contiguous() or t.data_ptr() % 16:
      raise ValueError(f"iqn_head {name}: need a contiguous, 16-byte "
                       "aligned tensor.")
  dev = cos_emb.device
  for name, t in tensors.items():
    if t.device != dev or dev.type != "cuda":
      raise ValueError(f"iqn_head {name}: every tensor must lie on one CUDA "
                       f"device; got {t.device} beside cos_emb on {dev}.")


def iqn_head_forward(we, be, wh, bh, wo, bo, cos_emb, s_emb,
                     residuals: bool):
  """Launches K4a: returns q (B, S, A), or (q, h (B·S, H)) with residuals.
  Takes no gradient: the tensors' autograd history is not followed."""
  _check(we, be, wh, bh, wo, bo, cos_emb, s_emb)
  b, s, _ = cos_emb.shape
  d, a = s_emb.shape[1], wo.shape[1]
  dev = cos_emb.device
  q = torch.empty((b, s, a), dtype=torch.float32, device=dev)
  h = torch.empty((b * s, HIDDEN), dtype=torch.float32,
                  device=dev) if residuals else None
  kernel = FWD_RES if residuals else FWD
  kernel.launch(cos_emb.data_ptr(), s_emb.data_ptr(), we.data_ptr(),
                be.data_ptr(), wh.data_ptr(), bh.data_ptr(), wo.data_ptr(),
                bo.data_ptr(), q.data_ptr(),
                h.data_ptr() if residuals else None, b, s, d, a,
                int(residuals), kernels.stream_ptr(dev))
  return (q, h) if residuals else q


def iqn_head(we, be, wh, bh, wo, bo, cos_emb, s_emb) -> torch.Tensor:
  """q (B, S, A) from cosine τ features and the torso embedding.

  CPU tensors take the plain version (differentiable by autograd). On CUDA
  the kernel is launched, forward only; asking for a gradient raises until
  the backward kernels are ported."""
  args = (we, be, wh, bh, wo, bo, cos_emb, s_emb)
  if cos_emb.device.type == "cpu":
    return iqn_head_plain(*args)
  if torch.is_grad_enabled() and any(t.requires_grad for t in args):
    raise NotImplementedError(
        "iqn_head under grad on CUDA: the backward kernels K4b (dwh, dbh) "
        "and K4c (dwe, dbe, ds_emb, dcos) are not ported yet; call it under "
        "torch.no_grad().")
  return iqn_head_forward(*args, residuals=False)


def bound_counts(b: int, s: int, a: int, residuals: bool, d: int = 3136):
  """(bytes, flops) K4a must move and do: every input read once, q (and h)
  written once; two flops per multiply-add of the three products."""
  rows = b * s
  floats = (rows * LATENT + b * d + LATENT * d + d + d * HIDDEN + HIDDEN
            + HIDDEN * a + a + rows * a)
  if residuals:
    floats += rows * HIDDEN
  return 4 * floats, 2 * rows * (LATENT * d + d * HIDDEN + HIDDEN * a)
