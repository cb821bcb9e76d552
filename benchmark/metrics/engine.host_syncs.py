"""The program's `host_syncs` counter a superstep: its reads of the device
through `profiling.host_read`."""

from benchmark import spans

LAYER = "engine (engine/superstep.py)"
UNIT = "syncs"
MOVES = "train_frames_per_s"
KERNELS = ()


def read(ctx):
  st = spans.of(ctx)
  if st is None:
    return None
  return st.counters.get("host_syncs", 0) / st.supersteps
