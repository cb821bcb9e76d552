"""Percent of the window's supersteps that took the env's reset branch
(some stream's episode had ended). The flag is kept on the card before
each superstep and read after the window."""

from benchmark import readers

LAYER = "envs (envs/vector.py, envs/games)"
UNIT = "%"
MOVES = "superstep_ms.p95"
KERNELS = ()


def read(ctx):
  return readers.reset_superstep_share(ctx)
