"""Operations and bytes of the port's kernels and of a whole learning
superstep, from the shapes alone, and the H100's peaks.

A kernel's work is its op's: each input byte read once, each output byte
written once, two operations a multiply-add of its products, whatever the
kernel reads again or recomputes. A superstep's model work counts the
forward and backward products of every pass it makes, once.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# NVIDIA H100 SXM5 data sheet, dense (no sparsity), at the 700 W limit.
PEAK = {"tf32": 495e12, "bf16": 989e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
# Ops peak of a configuration's products by the dtype it states: no product
# accurate to f32 runs faster than one TF32 pass.
OPS_PEAK = {"float32": PEAK["tf32"], "bfloat16": PEAK["bf16"]}

FRAME_RGB = 210 * 160 * 3
FRAME_84 = 84 * 84
STACK = 4
EMBED = 3136
HIDDEN = 512
LATENT = 64
CONVS = ((20 * 20, 32, 8 * 8 * 4), (9 * 9, 64, 4 * 4 * 32),
         (7 * 7, 64, 3 * 3 * 64))  # (output positions, channels, taps)
TORSO_PARAMS = sum(c * k + c for _, c, k in CONVS)

Work = Tuple[float, float]  # (operations, bytes)


def torso_fwd(b: int, residuals: bool = False) -> Work:
  """K3: uint8 stacks in, the weights read once, (B, 3136) features out
  (and the two inner activations with residuals)."""
  ops = 2.0 * b * sum(p * c * k for p, c, k in CONVS)
  nbytes = b * FRAME_84 * STACK + 4 * TORSO_PARAMS + 4 * b * EMBED
  if residuals:
    nbytes += 4 * b * (CONVS[0][0] * CONVS[0][1] + CONVS[1][0] * CONVS[1][1])
  return ops, nbytes


def torso_bwd_ops(b: int) -> float:
  """Weight gradients of the three convolutions and input gradients of the
  last two (the first layer's input is the frames)."""
  per = [2.0 * b * p * c * k for p, c, k in CONVS]
  return sum(per) + per[1] + per[2]


def iqn_head_fwd(b: int, s: int, a: int, residuals: bool = False) -> Work:
  """K4a: τ embedding (B·S, 64) @ (64, 3136), times the features, @ (3136,
  512), @ (512, A)."""
  rows = b * s
  ops = 2.0 * rows * (LATENT * EMBED + EMBED * HIDDEN + HIDDEN * a)
  floats = (rows * LATENT + b * EMBED + LATENT * EMBED + EMBED
            + EMBED * HIDDEN + HIDDEN + HIDDEN * a + a + rows * a)
  if residuals:
    floats += rows * HIDDEN
  return ops, 4.0 * floats


def iqn_head_bwd(b: int, s: int) -> Work:
  """K4b and K4c as one op: from dh (B·S, 512), the gradients of the hidden
  layer's weights and bias, of the τ embedding's, and of the features."""
  rows = b * s
  ops = 2.0 * rows * (EMBED * HIDDEN + HIDDEN * EMBED + LATENT * EMBED)
  floats = (rows * LATENT + b * EMBED + rows * HIDDEN + LATENT * EMBED
            + EMBED + EMBED * HIDDEN  # inputs
            + EMBED * HIDDEN + HIDDEN + LATENT * EMBED + EMBED + b * EMBED)
  return ops, 4.0 * floats


def iqn_head_out_ops(b: int, s: int, a: int) -> float:
  """The output layer's backward (outside K4): its weight gradient and dh."""
  return 2.0 * 2.0 * b * s * HIDDEN * a


def c51_noisy_dueling_fwd_ops(b: int, a: int, atoms: int) -> float:
  """Four noisy layers, each a μ product and a σ product (dqn_zoo's
  factorised noisy layer), plus the noisy weights' forming."""
  layers = ((EMBED, HIDDEN), (HIDDEN, a * atoms), (EMBED, HIDDEN),
            (HIDDEN, atoms))
  return sum(2.0 * 2.0 * b * i * o + 2.0 * i * o for i, o in layers)


def c51_noisy_dueling_bwd_ops(b: int, a: int, atoms: int) -> float:
  """Weight and input gradients of both products of each noisy layer."""
  layers = ((EMBED, HIDDEN), (HIDDEN, a * atoms), (EMBED, HIDDEN),
            (HIDDEN, atoms))
  return sum(2.0 * 2.0 * 2.0 * b * i * o for i, o in layers)


def window_gather(b: int, w: int) -> Work:
  """K1: B windows of W frames out of the store, written contiguously."""
  return 0.0, 2.0 * b * w * FRAME_84 + 2 * 8.0 * b


def frame_prep(b: int) -> Work:
  """K2: two RGB frames a stream in, one 84 x 84 byte frame out."""
  return 0.0, b * (2.0 * FRAME_RGB + FRAME_84)


def least_seconds(work: List[Work], ops_peak: float) -> float:
  """The least time the launches could take: each bound by the larger of
  its operations at the peak and its bytes at HBM bandwidth."""
  return sum(max(o / ops_peak, nb / HBM_BYTES_PER_S) for o, nb in work)


def superstep_launches(family: str, streams: int, batch: int, flags: dict,
                       num_actions: int) -> Dict[str, List[Work]]:
  """Each hand-written kernel's launches in one learning superstep, by the
  name `dqn_zoo_torch.kernels` counts them under, with their work."""
  w = STACK + flags["n_steps"]
  out = {"gather_windows": [window_gather(batch, w)],
         "pooled_frame_to_84": [frame_prep(streams)],
         "dqn_torso_fwd_residuals": [torso_fwd(batch, residuals=True)]}
  if family == "iqn":
    sp = flags["tau_samples_policy"]
    s1, s2 = flags["tau_samples_s_tm1"], flags["tau_samples_s_t"]
    out["dqn_torso_fwd"] = [torso_fwd(streams), torso_fwd(batch)]
    out["iqn_head_fwd"] = [iqn_head_fwd(streams, sp, num_actions),
                           iqn_head_fwd(batch, sp + s2, num_actions)]
    out["iqn_head_fwd_residuals"] = [iqn_head_fwd(batch, s1, num_actions,
                                                  residuals=True)]
    bwd = iqn_head_bwd(batch, s1)
    # K4b and K4c split the one op between them: the time of both is read.
    out["iqn_head_bwd_w"] = [bwd]
    out["iqn_head_bwd_d"] = [(0.0, 0.0)]
  elif family == "rainbow":
    out["dqn_torso_fwd"] = [torso_fwd(streams), torso_fwd(batch),
                            torso_fwd(batch)]
  else:
    raise KeyError(f"no launch pattern for {family!r}")
  return out


def model_ops(family: str, streams: int, batch: int, flags: dict,
              num_actions: int) -> float:
  """Forward and backward products of one learning superstep: the act,
  the online pass with its backward, the target (and selector) passes."""
  fwd = lambda b: torso_fwd(b)[0]
  if family == "iqn":
    sp = flags["tau_samples_policy"]
    s1, s2 = flags["tau_samples_s_tm1"], flags["tau_samples_s_t"]
    head = lambda b, s: iqn_head_fwd(b, s, num_actions)[0]
    return (fwd(streams) + head(streams, sp)  # act
            + fwd(batch) + head(batch, s1) + torso_bwd_ops(batch)
            + iqn_head_bwd(batch, s1)[0]
            + iqn_head_out_ops(batch, s1, num_actions)  # online
            + fwd(batch) + head(batch, sp + s2))  # selector and target
  if family == "rainbow":
    atoms = flags["num_atoms"]
    head = lambda b: c51_noisy_dueling_fwd_ops(b, num_actions, atoms)
    return (fwd(streams) + head(streams)  # act
            + fwd(batch) + head(batch) + torso_bwd_ops(batch)
            + c51_noisy_dueling_bwd_ops(batch, num_actions, atoms)  # online
            + 2 * (fwd(batch) + head(batch)))  # selector, target
  raise KeyError(f"no model for {family!r}")
