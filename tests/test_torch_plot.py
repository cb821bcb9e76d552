"""dqn_zoo_torch.run.plot against dqn_zoo_tpu.run.plot on the same CSVs.

Both mains run on the same files; the lines each hands to matplotlib
(`Axes.plot`) are recorded and compared: the curves and the summary's
medians must be equal. Runs that stop the reference's summary mode (a CSV
with no rows, a run with no finite capped_normalized_return) are skipped
by the port with a warning.
"""

import csv

import matplotlib
import numpy as np
import pytest

matplotlib.use("Agg")
import matplotlib.axes  # noqa: E402

from dqn_zoo_torch.run import plot as tplot  # noqa: E402
from dqn_zoo_tpu.run import plot as jplot  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401,E402 (autouse)

FIELDS = ["iteration", "frame", "eval_episode_return",
          "train_episode_return", "normalized_return",
          "capped_normalized_return", "eval_frames"]


def _write(path, rows):
  with open(path, "w", newline="") as f:
    w = csv.DictWriter(f, fieldnames=FIELDS)
    w.writeheader()
    for r in rows:
      w.writerow(r)
  return str(path)


def _run(tmp_path, name, n, seed, nan_at=()):
  """n iterations of 1M frames; capped_normalized_return NaN at `nan_at`
  (an iteration whose eval ended no episode)."""
  rng = np.random.RandomState(seed)
  rows = []
  for i in range(n):
    ret = float(rng.uniform(-21, 21))
    norm = float(rng.uniform(-0.2, 1.5))
    rows.append(dict(
        iteration=i, frame=i * 1_000_000, eval_episode_return=ret,
        train_episode_return=float(rng.uniform(-21, 21)),
        normalized_return="nan" if i in nan_at else norm,
        capped_normalized_return="nan" if i in nan_at else min(norm, 1.0),
        eval_frames=500_000))
  return _write(tmp_path / f"{name}.csv", rows)


def _lines(main, argv, monkeypatch):
  """[(x, y, label)] that `main(argv)` plots, and its return code."""
  got = []
  real = matplotlib.axes.Axes.plot

  def record(self, *args, **kw):
    got.append((np.asarray(args[0], float), np.asarray(args[1], float),
                kw.get("label")))
    return real(self, *args, **kw)

  monkeypatch.setattr(matplotlib.axes.Axes, "plot", record)
  rc = main(argv)
  monkeypatch.setattr(matplotlib.axes.Axes, "plot", real)
  return got, rc


def _assert_same(ours, ref):
  assert len(ours) == len(ref)
  for (x, y, label), (rx, ry, rlabel) in zip(ours, ref):
    assert label == rlabel
    np.testing.assert_array_equal(x, rx)
    np.testing.assert_array_equal(y, ry)


@pytest.mark.parametrize("metric", tplot.METRICS)
def test_curves_equal_the_reference(tmp_path, monkeypatch, metric):
  paths = [_run(tmp_path, "a", 7, 0, nan_at=(0, 3)),
           _run(tmp_path, "b", 4, 1)]
  argv = ["--csv", paths[0], "--csv", paths[1], "--labels", "dqn,rainbow",
          "--metric", metric]
  ours, rc = _lines(tplot.main, argv + ["--out", str(tmp_path / "t.svg")],
                    monkeypatch)
  ref, rrc = _lines(jplot.main, argv + ["--out", str(tmp_path / "j.svg")],
                    monkeypatch)
  assert rc == rrc == 0
  _assert_same(ours, ref)
  assert (tmp_path / "t.svg").stat().st_size > 0


def test_summary_medians_equal_the_reference(tmp_path, monkeypatch):
  # Two agents; the first over three games of different lengths (the grid
  # stops at the shortest), with NaN iterations inside, the second one
  # game, so both the median and the single-game label are exercised.
  paths = [_run(tmp_path, "r_pong", 9, 2, nan_at=(0, 5)),
           _run(tmp_path, "r_breakout", 6, 3),
           _run(tmp_path, "r_seaquest", 8, 4, nan_at=(7,)),
           _run(tmp_path, "d_pong", 5, 5)]
  argv = ["--summary", "--labels", "rainbow,rainbow,rainbow,dqn"]
  for p in paths:
    argv += ["--csv", p]
  ours, rc = _lines(tplot.main, argv + ["--out", str(tmp_path / "t.svg")],
                    monkeypatch)
  ref, rrc = _lines(jplot.main, argv + ["--out", str(tmp_path / "j.svg")],
                    monkeypatch)
  assert rc == rrc == 0
  _assert_same(ours, ref)
  assert [line[2] for line in ours] == ["rainbow (3 games)", "dqn (1 game)"]
  grid, median, games = tplot.summary_curves(
      {"rainbow": [(p, tplot.read_results(p)) for p in paths[:3]]})["rainbow"]
  assert games == 3 and grid[-1] == 5_000_000.0 and len(grid) == 64
  np.testing.assert_array_equal(median, ours[0][1])


def test_summary_skips_empty_and_all_nan_runs(tmp_path, monkeypatch, capsys):
  good = _run(tmp_path, "good", 5, 6)
  empty = _write(tmp_path / "empty.csv", [])
  all_nan = _run(tmp_path, "nan", 4, 7, nan_at=range(4))
  out = str(tmp_path / "s.svg")
  argv = ["--summary", "--csv", good, "--csv", empty, "--csv", all_nan,
          "--csv", all_nan, "--labels", "dqn,dqn,dqn,iqn", "--out", out]
  with pytest.warns(UserWarning) as record:
    ours, rc = _lines(tplot.main, argv, monkeypatch)
  text = " ".join(str(w.message) for w in record)
  assert "empty.csv: no rows" in text and "nan.csv: no finite" in text
  assert "iqn: no run left" in text
  assert rc == 0 and capsys.readouterr().out.strip() == f"wrote {out}"
  # What is left is the good run alone, as the reference plots it.
  ref, _ = _lines(jplot.main, ["--summary", "--csv", good, "--labels", "dqn",
                               "--out", str(tmp_path / "j.svg")], monkeypatch)
  _assert_same(ours, ref)
  # The reference stops on both degenerate runs.
  for bad in (empty, all_nan):
    with pytest.raises((IndexError, ValueError)):
      jplot.main(["--summary", "--csv", bad, "--out",
                  str(tmp_path / "x.svg")])
  # No run left at all: nothing is plotted and the exit code is 1.
  with pytest.warns(UserWarning):
    assert tplot.main(["--summary", "--csv", empty, "--out",
                       str(tmp_path / "y.svg")]) == 1
  assert np.isfinite(ours[0][1]).all()
