"""Host ms a superstep inside the `sync.*` spans: the program's reads of
the device (`profiling.host_read`), each a wait for what the card still
runs."""

from benchmark import spans

LAYER = "engine (engine/superstep.py)"
UNIT = "ms"
MOVES = "train_frames_per_s"
KERNELS = ()


def read(ctx):
  st = spans.of(ctx)
  if st is None:
    return None
  return st.per_superstep_ms(sum(
      s.end_ns - s.start_ns for s in st.spans if s.name.startswith("sync."))
      / 1e9)
