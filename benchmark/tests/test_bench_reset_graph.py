"""The reader of `env.reset_graph_share` (benchmark/metrics/) on hand-built
stretches of the program's counters, in the style of test_bench_spans.py."""

import pytest

from benchmark import spans
from benchmark.tests.test_bench_spans import SPANS, EVENTS, context, read
from dqn_zoo_torch.utils import profiling


@pytest.mark.parametrize("counters,want", [
    ({"env.reset_branch": 4, "env.reset_graph": 4}, 100.0),
    ({"env.reset_branch": 4, "env.reset_graph": 1}, 25.0),
    ({"env.reset_branch": 4}, 0.0),  # a program without the graph
    ({"host_syncs": 4}, None),  # a stretch without a reset branch
], ids=["every_branch", "a_quarter", "no_graph", "no_branch"])
def test_the_reset_graph_share_reads_the_counters(counters, want):
  ctx = context(EVENTS)
  spans.hold(ctx, profiling.Drained(SPANS, counters, 0,
                                    [profiling.Anchor(0, 0)]))
  assert read("env.reset_graph_share", ctx) == want


def test_the_reset_graph_share_without_the_recorder_is_none(monkeypatch):
  monkeypatch.delattr(profiling, "drain")
  assert read("env.reset_graph_share", context(EVENTS)) is None
