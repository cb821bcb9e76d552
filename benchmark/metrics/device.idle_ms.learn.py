"""Ms a superstep in which the card was idle while the innermost span open
on the host was `learn` or one of its children."""

from benchmark import spans

LAYER = "device (H100)"
UNIT = "ms"
MOVES = "train_frames_per_s"
KERNELS = ()


def read(ctx):
  return spans.idle_ms(ctx, ("learn", "learn."))
