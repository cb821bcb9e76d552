"""The program's spans and counters over a traced run's profiled stretch,
and the card's idle time split over them.

The program (`dqn_zoo_torch.utils.profiling`) records its spans while
torch.profiler records, so the profiled stretch's supersteps leave theirs
in its recorder; the first reader of a run drains it, and every reader of
that run reads the one drain. A program without the recorder, or a
stretch without a `superstep` span, gives every reader None.

Idle time is the complement of the union of the device events
(`trace.union`), clipped to the stretch from the first `superstep` span's
start to the last one's end on the profiler's clock, and split instant by
instant over the innermost span open on the host: a span's self time.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

from benchmark import trace
from dqn_zoo_torch.utils import profiling

# The CUDA runtime's and driver's launch records of a CUDA-activity profile.
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaGraphLaunch")
ENV = ("env.step", "env.reset_burn", "sync.reset", "prep")


@dataclasses.dataclass
class Stretch:
  spans: list  # profiling.Span, in the order they opened
  counters: Dict[str, int]
  anchors: list  # profiling.Anchor
  supersteps: int  # its `superstep` spans

  def us(self, host_ns: int) -> float:
    """A span time in µs of the profiler's clock, as trace.Event."""
    return profiling.profiler_ns(host_ns, self.anchors) / 1e3

  def named(self, *names: str) -> list:
    return [s for s in self.spans if s.name in names]

  def per_superstep_ms(self, seconds: float) -> float:
    return 1e3 * seconds / self.supersteps

  def pieces(self) -> List[Tuple[float, float, str]]:
    """(start µs, end µs, name): the spans' self time, each piece named by
    the innermost span open over it, in time order."""
    kids: Dict[int, list] = {}
    for s in self.spans:
      kids.setdefault(s.parent, []).append(s)
    out = []
    for s in self.spans:
      t = s.start_ns
      for k in kids.get(s.id, ()):
        if k.start_ns > t:
          out.append((t, k.start_ns, s.name))
        t = max(t, k.end_ns)
      if s.end_ns > t:
        out.append((t, s.end_ns, s.name))
    return sorted((self.us(a), self.us(b), n) for a, b, n in out)

  def self_seconds(self, name: str) -> float:
    return sum(b - a for a, b, n in self.pieces() if n == name) / 1e6


_LAST: list = [None, None]  # the Context last read, and its Stretch


def hold(ctx, drained) -> Optional[Stretch]:
  """`drained` (a profiling.Drained) as `ctx`'s stretch."""
  n = sum(s.name == "superstep" for s in drained.spans)
  st = Stretch(drained.spans, drained.counters, drained.anchors,
               n) if n and drained.anchors else None
  _LAST[:] = [ctx, st]
  return st


def of(ctx) -> Optional[Stretch]:
  """The stretch of the run that `ctx` reads; None where the program
  records no spans."""
  if _LAST[0] is ctx:
    return _LAST[1]
  if not hasattr(profiling, "drain"):
    _LAST[:] = [ctx, None]
    return None
  return hold(ctx, profiling.drain())


def idle(ctx) -> Optional[Tuple[Dict[Optional[str], float], float]]:
  """({innermost span's name, or None where only the root `superstep` or
  no span is open: idle seconds}, the stretch's idle seconds); None
  without spans or device events."""
  st = of(ctx)
  if st is None or not ctx.events:
    return None
  roots = st.named("superstep")
  lo = st.us(roots[0].start_ns)
  hi = st.us(max(r.end_ns for r in roots))
  gaps, t = [], lo
  for a, b, _ in trace.union(ctx.events):
    if a > t:
      gaps.append((t, min(a, hi)))
    t = max(t, b)
    if t >= hi:
      break
  if t < hi:
    gaps.append((t, hi))
  gaps = [(a, b) for a, b in gaps if b > a]
  total = sum(b - a for a, b in gaps)
  by: Dict[Optional[str], float] = {}
  pieces, i = st.pieces(), 0
  for a, b in gaps:
    while i < len(pieces) and pieces[i][1] <= a:
      i += 1
    j = i
    while j < len(pieces) and pieces[j][0] < b:
      pa, pb, name = pieces[j]
      cut = min(b, pb) - max(a, pa)
      if cut > 0:
        key = None if name == "superstep" else name
        by[key] = by.get(key, 0.0) + cut / 1e6
      j += 1
  by[None] = by.get(None, 0.0) + total / 1e6 - sum(by.values())
  return by, total / 1e6


def idle_ms(ctx, names) -> Optional[float]:
  """Idle ms a superstep under the innermost spans `names` (a name ending
  in "." stands for every name it begins)."""
  got = idle(ctx)
  if got is None:
    return None
  by, _ = got
  hit = lambda n: n is not None and any(
      n == k or (k.endswith(".") and n.startswith(k)) for k in names)
  return of(ctx).per_superstep_ms(sum(v for n, v in by.items() if hit(n)))


def idle_by_span(ctx, top: int = 10) -> List[list]:
  """The `top` spans under whose self time the card was idle longest, in
  seconds ("unattributed" for the root or no span)."""
  got = idle(ctx)
  if got is None:
    return []
  by, _ = got
  ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
  return [[n or "unattributed", s] for n, s in ranked]


def launches(ctx, names=ENV) -> Optional[float]:
  """Launch records a superstep whose host time lies inside the spans
  `names` (with their children); None where `ctx.events` holds no launch
  record. The harness's device-only events hold none (they are CPU-typed),
  so no metric reads this; tools/torch_spans_probe.py hands it the
  records."""
  st = of(ctx)
  if st is None:
    return None
  starts = sorted(a for n, a, _ in ctx.events if n in LAUNCHES)
  if not starts:
    return None
  spans = st.named(*names)
  inside = {s.id for s in spans}
  n = 0
  for s in spans:
    if s.parent not in inside:  # a child's lie inside its parent's
      n += bisect.bisect_right(starts, st.us(s.end_ns)) - bisect.bisect_left(
          starts, st.us(s.start_ns))
  return n / st.supersteps
