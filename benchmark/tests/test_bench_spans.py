"""The readers of the program's spans (benchmark/spans.py and the metrics
that use it) on a hand-built stretch whose numbers are worked out below,
and on tiny CPU runs of the harness."""

import pytest
import torch

from benchmark import readers, spans
from benchmark.tests.test_bench_runs import tiny_cell
from dqn_zoo_torch.utils import profiling

S = profiling.Span
US = 1000  # ns a µs: the anchor maps the host clock onto the profiler's 1:1

# Two supersteps. The first, 0-100 µs:
#   superstep [0, 100]: env.step [10, 50] (sync.reset [12, 14],
#   env.reset_burn [20, 40]), prep [50, 60], learn [60, 90]
#   (learn.sample [62, 70]).
# The second, 105-200 µs: superstep [105, 200], sync.gate [150, 160].
SPANS = [
    S("superstep", 0, 100 * US, 0, -1, 0),
    S("env.step", 10 * US, 50 * US, 1, 0, 0),
    S("sync.reset", 12 * US, 14 * US, 2, 1, 0),
    S("env.reset_burn", 20 * US, 40 * US, 3, 1, 0),
    S("prep", 50 * US, 60 * US, 4, 0, 0),
    S("learn", 60 * US, 90 * US, 5, 0, 0),
    S("learn.sample", 62 * US, 70 * US, 6, 5, 0),
    S("superstep", 105 * US, 200 * US, 7, -1, 1),
    S("sync.gate", 150 * US, 160 * US, 8, 7, 1),
]
# The card busy over [0, 15], [30, 65], [75, 80], [95, 100], [105, 200]:
# idle over [15, 30] (env.step 5 µs, then its child env.reset_burn 10),
# [65, 75] (learn.sample 5, learn 5), [80, 95] (learn 10, the root 5) and
# [100, 105] (between supersteps, no span: 5). Idle 45 µs: env 15, learn
# 20, unattributed 10.
EVENTS = [("k", 0.0, 15.0), ("k", 30.0, 40.0), ("k", 35.0, 65.0),
          ("k", 75.0, 80.0), ("k", 95.0, 100.0), ("k", 105.0, 200.0)]
# Launch records: in env.step (11), sync.reset (13), env.reset_burn (25),
# prep (55), learn (65) and the second root (120).
LAUNCH_RECORDS = [("cudaLaunchKernel", t, t + 0.5)
                  for t in (11.0, 13.0, 25.0, 55.0, 65.0, 120.0)]
NEW = ("span_ms.env_step", "span_ms.reset_burn", "span_ms.learn",
       "span_ms.sync_wait", "engine.host_syncs", "device.idle_ms.env",
       "device.idle_ms.learn", "device.idle_unattributed_share")


def context(events):
  return readers.Context(
      cell=None, family="iqn", streams=4, batch=32, num_actions=6, flags={},
      events=events, window_s=200e-6, launched={}, supersteps=2,
      stage_ms={}, window_times=[], reset_flags=[])


def held(events):
  ctx = context(events)
  spans.hold(ctx, profiling.Drained(SPANS, {"host_syncs": 4}, 0,
                                    [profiling.Anchor(0, 0)]))
  return ctx


def read(name, ctx):
  return readers.load(name).read(ctx)


def test_span_readers_give_the_numbers_worked_out_by_hand():
  ctx = held(EVENTS)
  # env.step's self time: 2 + 6 + 10 µs over two supersteps.
  assert read("span_ms.env_step", ctx) == pytest.approx(9e-3)
  assert read("span_ms.reset_burn", ctx) == pytest.approx(20e-3)
  assert read("span_ms.learn", ctx) == pytest.approx(15e-3)
  assert read("span_ms.sync_wait", ctx) == pytest.approx(6e-3)  # 2 + 10 µs
  assert read("engine.host_syncs", ctx) == 2.0
  assert spans.launches(ctx) is None  # no launch record


def test_idle_readers_split_a_gap_over_nested_spans():
  ctx = held(EVENTS)
  by, total = spans.idle(ctx)
  assert total == pytest.approx(45e-6)
  assert by["env.step"] == pytest.approx(5e-6)
  assert by["env.reset_burn"] == pytest.approx(10e-6)
  assert by["learn.sample"] == pytest.approx(5e-6)
  assert by["learn"] == pytest.approx(15e-6)
  assert by[None] == pytest.approx(10e-6)
  assert sum(by.values()) == pytest.approx(total)
  assert read("device.idle_ms.env", ctx) == pytest.approx(7.5e-3)
  assert read("device.idle_ms.learn", ctx) == pytest.approx(10e-3)
  assert read("device.idle_unattributed_share", ctx) == pytest.approx(
      100 * 10 / 45)
  assert spans.idle_by_span(ctx, top=1) == [["learn", pytest.approx(15e-6)]]
  assert "unattributed" in {n for n, _ in spans.idle_by_span(ctx)}


def test_launches_count_the_records_inside_env_step_and_prep():
  ctx = held(LAUNCH_RECORDS)
  assert spans.launches(ctx) == 2.0  # 11, 13, 25 and 55 µs
  assert spans.launches(ctx, ("learn",)) == 0.5


def test_without_events_or_without_the_recorder_the_readers_give_none(
    monkeypatch):
  ctx = held([])
  for name in ("device.idle_ms.env", "device.idle_ms.learn",
               "device.idle_unattributed_share"):
    assert read(name, ctx) is None
  assert spans.launches(ctx) is None
  monkeypatch.delattr(profiling, "drain")  # a program without the recorder
  ctx = context(EVENTS)
  assert all(read(name, ctx) is None for name in NEW)
  assert spans.launches(ctx) is None


@pytest.fixture
def _two_threads():
  n = torch.get_num_threads()
  torch.set_num_threads(2)
  yield
  torch.set_num_threads(n)


def test_a_traced_run_reads_the_profiled_stretchs_spans(_two_threads):
  from benchmark import harness
  cell = tiny_cell("iqn")
  res = harness.run_cell(cell, 2**31 + 11, 0.3, True, 0.0, device="cpu")
  assert res["correct"] is True
  m = {k: v["value"] for k, v in res["metrics"].items()}
  assert m["engine.host_syncs"] == 2.0
  assert {"span_ms.env_step", "span_ms.learn", "span_ms.sync_wait"} <= set(m)
  # Only the profiled stretch's supersteps were recorded.
  assert spans._LAST[1].supersteps == cell.traffic["trace"][
      "profiled_supersteps"]
  assert not profiling.RECORDER.on


def test_an_untraced_run_records_nothing(_two_threads):
  from benchmark import harness
  profiling.drain()
  harness.run_cell(tiny_cell("iqn"), 2**31 + 12, 0.3, False, 0.0,
                   device="cpu")
  got = profiling.drain()
  assert got.spans == [] and got.counters == {} and got.anchors == []
