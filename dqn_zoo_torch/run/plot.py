"""Learning-curve plots from results CSVs (port of dqn_zoo_tpu/run/plot.py).

Per-run curves of one metric, or a median human-normalized summary across
runs, from the CSVs that run/train.py writes (the reference's 13 fields
plus `eval_frames`).

Usage:
  python -m dqn_zoo_torch.run.plot --csv run1.csv --csv run2.csv \
      --labels dqn,rainbow --out curves.svg

Summary mode:
  python -m dqn_zoo_torch.run.plot --summary \
      --csv rainbow_pong.csv --csv rainbow_breakout.csv --csv dqn_pong.csv \
      --labels rainbow,rainbow,dqn --out summary.svg
groups the CSVs by agent label and plots each agent's MEDIAN
capped-human-normalized return across its games, interpolated onto a
common frame grid up to the shortest run's last frame.

Unlike the reference, summary mode skips a run with no rows, or with no
finite capped_normalized_return, with a warning (the reference stops with
an IndexError or a ValueError there), and an agent all of whose runs are
skipped. It exits 0 while at least one run is left, else 1.

matplotlib is imported in `main` only: nothing else of the port needs it.
"""

from __future__ import annotations

import argparse
import csv
import math
import sys
import warnings
from typing import Dict, List, Sequence, Tuple

import numpy as np

METRICS = ("eval_episode_return", "train_episode_return",
           "normalized_return", "capped_normalized_return")
SUMMARY_METRIC = "capped_normalized_return"
GRID_POINTS = 64


def read_results(path: str) -> List[dict]:
  with open(path) as f:
    return list(csv.DictReader(f))


def curve(rows: Sequence[dict], metric: str) -> Tuple[list, list]:
  """(frames, values) of one run, every row, as floats."""
  return ([float(r["frame"]) for r in rows],
          [float(r[metric]) for r in rows])


def usable(rows: Sequence[dict]) -> bool:
  """A run summary mode can use: at least one row with a finite
  capped_normalized_return."""
  return any(math.isfinite(float(r[SUMMARY_METRIC])) for r in rows)


def summary_curves(by_agent: Dict[str, List[Tuple[str, List[dict]]]],
                   points: int = GRID_POINTS) -> Dict[str, tuple]:
  """{agent: (grid, median, games)} from {agent: [(path, rows), ...]}.

  As the reference: the grid is `points` frames from 0 to the shortest of
  the agent's runs' last frame; each run is interpolated onto it through
  its finite values; the median is over the runs. Runs that `usable`
  rejects are left out with a warning, and so is an agent with none left."""
  out = {}
  for agent, runs in by_agent.items():
    kept = []
    for path, rows in runs:
      if not rows:
        warnings.warn(f"{path}: no rows; left out of {agent}'s summary.")
      elif not usable(rows):
        warnings.warn(f"{path}: no finite {SUMMARY_METRIC}; left out of "
                      f"{agent}'s summary.")
      else:
        kept.append(rows)
    if not kept:
      warnings.warn(f"{agent}: no run left; the agent is not plotted.")
      continue
    horizon = min(float(rows[-1]["frame"]) for rows in kept)
    grid = np.linspace(0, horizon, points)
    curves = []
    for rows in kept:
      f, v = (np.asarray(x) for x in curve(rows, SUMMARY_METRIC))
      keep = np.isfinite(v)
      curves.append(np.interp(grid, f[keep], v[keep]))
    out[agent] = (grid, np.median(np.stack(curves), axis=0), len(kept))
  return out


def _parser() -> argparse.ArgumentParser:
  p = argparse.ArgumentParser()
  p.add_argument("--csv", action="append", required=True)
  p.add_argument("--labels", default="")
  p.add_argument("--metric", default="eval_episode_return", choices=METRICS)
  p.add_argument("--out", default="curves.svg")
  p.add_argument("--summary", action="store_true",
                 help="median capped-normalized return per agent label "
                      "across its CSVs (games), vs frames")
  return p


def main(argv=None) -> int:
  args = _parser().parse_args(argv)

  import matplotlib
  matplotlib.use("Agg")
  import matplotlib.pyplot as plt

  labels = args.labels.split(",") if args.labels else [
      f"run{i}" for i in range(len(args.csv))]
  fig, ax = plt.subplots(figsize=(8, 5))
  if args.summary:
    by_agent = {}
    for path, label in zip(args.csv, labels):
      by_agent.setdefault(label, []).append((path, read_results(path)))
    curves = summary_curves(by_agent)
    if not curves:
      print("no run has a finite capped_normalized_return; nothing plotted.",
            file=sys.stderr)
      return 1
    for agent, (grid, median, games) in curves.items():
      ax.plot(grid, median,
              label=f"{agent} ({games} game{'s' if games > 1 else ''})")
    ax.set_ylabel("median capped human-normalized return")
  else:
    for path, label in zip(args.csv, labels):
      ax.plot(*curve(read_results(path), args.metric), label=label)
    ax.set_ylabel(args.metric)
  ax.set_xlabel("environment frames")
  ax.legend()
  ax.grid(alpha=0.3)
  fig.tight_layout()
  fig.savefig(args.out)
  print(f"wrote {args.out}")
  return 0


if __name__ == "__main__":
  sys.exit(main())
