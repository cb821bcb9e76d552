"""IQN_BF16_HEAD of two checkouts in turns on one card.

  python3 tools/torch_iqn_bf16_ab.py --parent=PATH

Runs chip_smoke.py's IQN_BF16_HEAD phase (`phase_iqn_path` with the head's
bf16-operand mode: the iqn/pong trainer at full width, 128 streams, replay
1e6, batch 1024) in a fresh process from the root of each checkout, in the
order parent, this, this, parent; each process builds its own tree's
kernels and runs its own tree's checks. Prints one `IQN_BF16_AB` JSON line
per run (ms a learning superstep, the fenced learn split, launches a
learning superstep) and one `IQN_BF16_AB_SUMMARY` line with both trees'
readings side by side: the end-to-end reading of a change to the bf16
head's kernels. Needs a CUDA card and nvcc; ~3-4 minutes.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODE = ("import sys, torch; sys.path.insert(0, '.'); import chip_smoke; "
        "from dqn_zoo_torch.device import resolve_device; "
        "chip_smoke.phase_iqn_path(resolve_device('cuda'), "
        "head_matmul_dtype=torch.bfloat16)")


def run(root: str) -> dict:
  done = subprocess.run([sys.executable, "-c", CODE], cwd=root,
                        capture_output=True, text=True)
  if done.returncode != 0:
    raise SystemExit(f"{root}: exit {done.returncode}\n"
                     f"{done.stdout[-2000:]}\n{done.stderr[-3000:]}")
  line = [x for x in done.stdout.splitlines()
          if x.startswith("IQN_BF16_HEAD ")][-1]
  got = json.loads(line.split(" ", 1)[1])
  return {k: got[k] for k in ("ms_per_learning_superstep",
                              "learning_split_ms_per_superstep",
                              "launches_per_learning_superstep", "card")}


def main() -> int:
  parent = [a.split("=", 1)[1] for a in sys.argv[1:]
            if a.startswith("--parent=")]
  if not parent or not os.path.isfile(os.path.join(parent[0],
                                                   "chip_smoke.py")):
    print("needs --parent=PATH, the root of another checkout",
          file=sys.stderr)
    return 1
  readings = {"parent": [], "this": []}
  for who in ("parent", "this", "this", "parent"):
    got = run(parent[0] if who == "parent" else ROOT)
    readings[who].append(got)
    print("IQN_BF16_AB " + json.dumps(dict(tree=who, **got)), flush=True)
  print("IQN_BF16_AB_SUMMARY " + json.dumps({
      who: dict(ms_per_learning_superstep=[
          r["ms_per_learning_superstep"] for r in runs],
                learn_ms_fenced=[
                    r["learning_split_ms_per_superstep"].get("learn")
                    for r in runs])
      for who, runs in readings.items()}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
