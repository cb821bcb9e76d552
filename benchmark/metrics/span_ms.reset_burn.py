"""Mean host ms of the `env.reset_burn` span (`_reset_all`: the 30-frame
noop burn for the whole batch) over the supersteps that ran it,
unfenced."""

import statistics

from benchmark import spans

LAYER = "envs (envs/vector.py, envs/games)"
UNIT = "ms"
MOVES = "superstep_ms.p95"
KERNELS = ()


def read(ctx):
  st = spans.of(ctx)
  burns = [] if st is None else st.named("env.reset_burn")
  if not burns:
    return None
  return statistics.fmean(s.end_ns - s.start_ns for s in burns) / 1e6
