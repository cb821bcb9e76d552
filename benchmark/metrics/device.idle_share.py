"""Percent of the profiled stretch in which no kernel, copy or memset ran
on the card: 100 − the union of their intervals over the stretch's wall
time."""

from benchmark import trace

LAYER = "device (H100)"
UNIT = "%"
MOVES = "train_frames_per_s"
KERNELS = ()


def read(ctx):
  if not ctx.events:
    return None
  return 100.0 * (1.0 - trace.busy_seconds(ctx.events) / ctx.window_s)
