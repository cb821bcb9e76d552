"""Host ms a superstep of the env step's self time: the `env.step` span
outside its children `env.reset_burn` and `sync.reset` (the launches of
the action-repeat group and of the reset branch's selects), unfenced."""

from benchmark import spans

LAYER = "envs (envs/vector.py, envs/games)"
UNIT = "ms"
MOVES = "train_frames_per_s"
KERNELS = ()


def read(ctx):
  st = spans.of(ctx)
  return None if st is None else st.per_superstep_ms(
      st.self_seconds("env.step"))
