"""Host ms a superstep of the replay insert, fenced:
`Engine.superstep(timings=)`."""

from benchmark import readers

LAYER = "replay (replay/device_replay.py, replay/window_gather.py)"
UNIT = "ms"
MOVES = "train_frames_per_s"
KERNELS = ()


def read(ctx):
  return readers.stage(ctx, "insert")
