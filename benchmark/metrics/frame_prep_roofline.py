"""K2's share of its roofline: the bytes of two RGB frames in and one
84 x 84 frame out a stream, at HBM bandwidth, over K2's device time."""

from benchmark import readers

LAYER = "prep (prep/cuda_prep.py)"
UNIT = "%"
MOVES = "train_frames_per_s"
KERNELS = ("pooled_frame_to_84_kernel",)


def read(ctx):
  return readers.roofline(ctx, ("pooled_frame_to_84",), KERNELS)
