"""Finds and runs the per-layer metrics' readers.

Each per-layer metric of BENCHMARK.json has a file of its own,
benchmark/metrics/<name>.py, with LAYER, UNIT, MOVES and KERNELS (the kernel
symbol names it reads, empty where it reads none) and `read(ctx)`, which
returns the number or None where the run gave it nothing to read; a None
leaves the metric out of the result line.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import statistics
from typing import Dict, List, Optional, Sequence

from benchmark import trace, work
from benchmark.traffic import ROOT


@dataclasses.dataclass
class Context:
  """What a traced run hands every reader."""

  cell: object  # harness.Cell
  family: str  # the reference family: "iqn", "rainbow"
  streams: int
  batch: int
  num_actions: int
  flags: dict
  events: List[trace.Event]  # device events of the profiled stretch
  window_s: float  # its wall seconds
  launched: Dict[str, int]  # kernel launches in it
  supersteps: int  # its supersteps, every one learning
  stage_ms: Dict[str, float]  # fenced stretch: ms a superstep by stage
  window_times: List[float]  # the unfenced window's host s a superstep
  reset_flags: List[bool]  # whether each of those took the reset branch

  @property
  def ops_peak(self) -> float:
    return work.OPS_PEAK[self.cell.config["compute_dtype"]]


def load(name: str):
  path = ROOT / "metrics" / f"{name}.py"
  spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}",
                                                path)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def read_all(per_layer: List[dict], ctx: Context) -> Dict[str, dict]:
  out = {}
  for m in per_layer:
    v = load(m["name"]).read(ctx)
    if v is not None:
      out[m["name"]] = dict(value=v, unit=m["unit"])
  return out


def roofline(ctx: Context, counters: Sequence[str],
             kernels: Sequence[str]) -> Optional[float]:
  """Percent of the kernels' device time that their op's least time would
  take, over the profiled stretch; None unless every counter launched as
  often as the cell's launch pattern says (a path that no longer runs
  these kernels, or runs them at other shapes, is not read)."""
  pattern = work.superstep_launches(ctx.family, ctx.streams, ctx.batch,
                                    ctx.flags, ctx.num_actions)
  done = []
  for c in counters:
    if c not in pattern or ctx.launched.get(c, 0) != \
        len(pattern[c]) * ctx.supersteps:
      return None
    done += pattern[c] * ctx.supersteps
  t = trace.kernel_seconds(ctx.events, kernels)
  if t <= 0:
    return None
  return 100.0 * work.least_seconds(done, ctx.ops_peak) / t


def stage(ctx: Context, name: str) -> Optional[float]:
  return ctx.stage_ms.get(name)


def reset_superstep_ms(ctx: Context) -> Optional[float]:
  times = [t for t, f in zip(ctx.window_times, ctx.reset_flags) if f]
  return 1e3 * statistics.fmean(times) if times else None


def reset_superstep_share(ctx: Context) -> Optional[float]:
  if not ctx.reset_flags:
    return None
  return 100.0 * sum(ctx.reset_flags) / len(ctx.reset_flags)
