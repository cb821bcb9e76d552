"""The network's model operations over the profiled stretch (the forward
and backward products of the act, online, selector and target passes, no
recomputation) over its wall time at the ops peak of the configuration's
dtype, in percent."""

from benchmark import work

LAYER = "device (H100)"
UNIT = "%"
MOVES = "train_frames_per_s"
KERNELS = ()


def read(ctx):
  if not ctx.events:
    return None
  ops = work.model_ops(ctx.family, ctx.streams, ctx.batch, ctx.flags,
                       ctx.num_actions) * ctx.supersteps
  return 100.0 * ops / (ctx.window_s * ctx.ops_peak)
