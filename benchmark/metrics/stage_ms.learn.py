"""Host ms a superstep of the learn stage (sample, loss, backward, Adam,
priority writes, target swap), fenced: `Engine.superstep(timings=)`."""

from benchmark import readers

LAYER = "engine (engine/superstep.py)"
UNIT = "ms"
MOVES = "train_frames_per_s"
KERNELS = ()


def read(ctx):
  return readers.stage(ctx, "learn")
