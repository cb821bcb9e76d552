"""K1's share of its roofline: the batch's windows of K + n frames read
from the store and written out, at HBM bandwidth, over K1's device time."""

from benchmark import readers

LAYER = "replay (replay/device_replay.py, replay/window_gather.py)"
UNIT = "%"
MOVES = "train_frames_per_s"
KERNELS = ("gather_windows_kernel",)


def read(ctx):
  return readers.roofline(ctx, ("gather_windows",), KERNELS)
