"""Percent of the profiled stretch's reset branches that replayed the
branch's CUDA graph: the program's `env.reset_graph` counter over its
`env.reset_branch`. None where the stretch took no reset branch (or the
program records no counters); 0 where it counts no replay."""

from benchmark import spans

LAYER = "envs (envs/vector.py, envs/games)"
UNIT = "%"
MOVES = "superstep_ms.p95"
KERNELS = ()


def read(ctx):
  st = spans.of(ctx)
  branches = 0 if st is None else st.counters.get("env.reset_branch", 0)
  if not branches:
    return None
  return 100.0 * st.counters.get("env.reset_graph", 0) / branches
