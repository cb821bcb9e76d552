"""Host ms a superstep of the env step, the frame prep and the stack
update with the learn gate's read-back, fenced: `Engine.superstep(timings=)`."""

from benchmark import readers

LAYER = "engine (engine/superstep.py)"
UNIT = "ms"
MOVES = "train_frames_per_s"
KERNELS = ()


def read(ctx):
  return readers.stage(ctx, "env_prep")
