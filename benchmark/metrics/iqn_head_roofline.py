"""The IQN head kernels' share of their roofline: K4a's forward products
(act, online, selector and target) and the backward's (K4b and K4c: the
hidden layer's weight and input gradients and the τ embedding's weight
gradient, no recomputation) at the ops peak of the configuration's dtype,
or their bytes at HBM bandwidth where larger, over the device time of
every kernel of the head's f32 sources."""

from benchmark import readers

LAYER = "nets (nets/torso_cuda.py, nets/iqn_head.py)"
UNIT = "%"
MOVES = "train_frames_per_s"
KERNELS = ("iqn_head_kernel", "iqn_head_finish_kernel",
           "iqn_head_bwd_w_kernel", "iqn_head_bwd_d_kernel",
           "sum_partials_kernel")


def read(ctx):
  return readers.roofline(ctx, ("iqn_head_fwd", "iqn_head_fwd_residuals",
                                "iqn_head_bwd_w", "iqn_head_bwd_d"), KERNELS)
