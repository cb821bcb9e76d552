"""Percent of the stretch's idle time on the card in which the innermost
span open on the host was the root `superstep` or none: how much of the
idle time the program's spans fail to explain."""

from benchmark import spans

LAYER = "device (H100)"
UNIT = "%"
MOVES = "train_frames_per_s"
KERNELS = ()


def read(ctx):
  got = spans.idle(ctx)
  if got is None or got[1] <= 0:
    return None
  by, total = got
  return 100.0 * by[None] / total
