"""K3a's and K3b's share of their roofline: the torso's forward products
at the ops peak of the configuration's dtype (TF32's for f32), or its
bytes at HBM bandwidth where larger, launch by launch, over the kernels'
device time."""

from benchmark import readers

LAYER = "nets (nets/torso_cuda.py, nets/iqn_head.py)"
UNIT = "%"
MOVES = "train_frames_per_s"
KERNELS = ("dqn_torso_kernel",)


def read(ctx):
  return readers.roofline(ctx, ("dqn_torso_fwd", "dqn_torso_fwd_residuals"),
                          KERNELS)
