"""Whole runs of each configuration on the CPU at a tiny size: a sound run
is correct, the control (the reference in TF32 in the program's place) is
not, and neither is a run with the timed path broken underneath, one fault
at a time. The harness's look for a card is skipped (`device="cpu"`); the
widths are the published ones, the streams, replay and τ samples few."""

import pytest
import torch

from benchmark import calibrate, check, harness, traffic
from benchmark.reference.follow import FAULTS

# family: (cell, traffic). rainbow.pong.e256 is out of BENCHMARK.json while
# the program's prioritized query can return a leaf past the replay (PERF.md
# §7); its files stay, and its reference is tested here.
CELLS = {"iqn": ("iqn.pong.e128", "pong.e128"),
         "rainbow": ("rainbow.pong.e256", "pong.e256")}


@pytest.fixture(autouse=True)
def _one_thread():
  n = torch.get_num_threads()
  torch.set_num_threads(2)
  yield
  torch.set_num_threads(n)


def tiny_cell(family: str) -> harness.Cell:
  name, traffic_name = CELLS[family]
  bench = harness.load_benchmark()
  entry = {"name": name, "config": family, "traffic": traffic_name,
           "chips": 1}
  cfg = traffic.load("configs", family)
  if family == "iqn":
    cfg["flags"].update(tau_samples_policy=8, tau_samples_s_tm1=8,
                        tau_samples_s_t=8)
  t = traffic.load("traffic", traffic_name)
  t.update(num_envs=4, replay_capacity=4 * 40, steady_state_frames=4 * 4 * 60)
  t["replay_fill"]["episode_steps"] = 25
  t["spread"]["steps"] = 6
  t["warmup"] = {"min_supersteps": 2, "max_supersteps": 40}
  t["trace"] = {"profiled_supersteps": 2, "fenced_supersteps": 2}
  layers = [m for m in bench["per_layer"] if family == "iqn"
            or not m["name"].startswith("iqn_head")]
  return harness.Cell(name, entry, cfg, t, traffic.load("workloads", name),
                      layers)


def run(family: str, seed: int = 2**31 + 11, traced: bool = False):
  return harness.run_cell(tiny_cell(family), seed, 0.3, traced, 0.0,
                          device="cpu")


@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA card")
  return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(CELLS))
def test_a_traced_run_on_the_card_is_correct(card, family):
  res = harness.run_cell(tiny_cell(family), 2**31 + 13, 1.0, True, 0.0,
                         device=card)
  assert res["correct"] is True, res["checks"]
  assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
  assert "device.idle_share" in res["metrics"]


@pytest.mark.parametrize("family", sorted(CELLS))
def test_a_sound_run_is_correct(family):
  res = run(family)
  assert res["correct"] is True, res["checks"]
  assert list(res)[-1] == "checks"
  assert res["attempted"] > 0 and res["failed"] == 0


def test_a_traced_run_reads_the_stage_spans():
  res = run("iqn", traced=True)
  assert res["correct"] is True
  assert {"stage_ms.learn", "stage_ms.env_prep", "stage_ms.insert"} <= set(
      res["metrics"])


@pytest.mark.parametrize("family", sorted(CELLS))
def test_the_control_is_not_correct(family):
  cell = tiny_cell(family)
  got = {r["reading"]: r["numbers"] for r in calibrate.readings(
      cell.name, [2**31 + 5], True, [], device="cpu", cell=cell)}
  limits = cell.workload["limits"]
  assert check.verdict(got["program"], limits)
  assert not check.verdict(got["control"], limits)


@pytest.mark.parametrize("fault", [f for f in FAULTS if f])
def test_a_planted_fault_is_not_correct(fault):
  cell = tiny_cell("rainbow")
  got = {r["reading"]: r["numbers"] for r in calibrate.readings(
      cell.name, [2**31 + 7], False, [fault], device="cpu", cell=cell)}
  assert not check.verdict(got[fault], cell.workload["limits"])


# --- the timed path broken underneath -----------------------------------------

def _unchanged(monkeypatch):
  from dqn_zoo_torch.agents import base
  monkeypatch.setattr(base.Adam, "step", lambda self, p, g, s: None)


def _half_batch(monkeypatch):
  """The loss of the first half of the batch alone, its mean over it."""
  orig = harness.spec_overrides

  def overrides(config):
    from dqn_zoo_torch.agents import get_agent
    loss = get_agent(config["agent"]).loss

    def half(spec, net, online, target, batch, weights, *draws):
      k = weights.shape[0] // 2
      cut = lambda t: t[:k] if t.dim() and t.shape[0] == 2 * k else t
      out = loss(spec, net, online, target, type(batch)(*map(cut, batch)),
                 weights[:k], *[type(d)(*map(cut, d)) if isinstance(d, tuple)
                                else cut(d) for d in draws])
      return out._replace(priorities=out.priorities.repeat(2))

    return dict(orig(config), loss=half)

  monkeypatch.setattr(harness, "spec_overrides", overrides)


def _altered_action(monkeypatch):
  from dqn_zoo_torch import ops
  orig = ops.epsilon_greedy_sample

  def altered(q, *args):
    a = orig(q, *args)
    a[0] = (a[0] + 1) % q.shape[-1]
    return a

  monkeypatch.setattr(ops, "epsilon_greedy_sample", altered)


def _altered_leaf(monkeypatch):
  from dqn_zoo_torch.replay import fanout_tree
  orig = fanout_tree.fanout_query

  def altered(tree, targets):
    idx = orig(tree, targets)
    idx[0] = idx[0] - 1 if idx[0] > 0 else idx[0] + 1  # its neighbour
    return idx

  monkeypatch.setattr(fanout_tree, "fanout_query", altered)


def _altered_row(monkeypatch):
  from dqn_zoo_torch.replay import window_gather
  orig = window_gather.gather_windows

  def altered(*args, **kw):
    w = orig(*args, **kw)
    w[0, 3, 0, 0] ^= 1  # the newest frame of the first s_tm1
    return w

  monkeypatch.setattr(window_gather, "gather_windows", altered)


@pytest.mark.parametrize("family", sorted(CELLS))
@pytest.mark.parametrize("breaks", [_unchanged, _half_batch, _altered_action,
                                    _altered_leaf, _altered_row],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_program_is_not_correct(monkeypatch, family, breaks):
  breaks(monkeypatch)
  res = run(family)
  assert res["correct"] is False, res["checks"]
