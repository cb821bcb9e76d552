"""Host ms a superstep of the `learn` span (sample, loss, backward,
optimizer), unfenced: the launches' host time and any wait inside it."""

from benchmark import spans

LAYER = "engine (engine/superstep.py)"
UNIT = "ms"
MOVES = "train_frames_per_s"
KERNELS = ()


def read(ctx):
  st = spans.of(ctx)
  if st is None:
    return None
  return st.per_superstep_ms(
      sum(s.end_ns - s.start_ns for s in st.named("learn")) / 1e9)
