"""Readings that the comparison's limits are set from, at a cell's own size.

  python3 -m benchmark.calibrate --workload <name> --seeds 1,2,3 \
      [--control] [--faults all|<fault>,...]

For each seed: the set-up and the three checked supersteps of a run (no
window), then the reference, and the compared numbers of
  program   the program's outputs (the lower readings);
  control   the reference computed in TF32 put in the program's place;
  <fault>   the reference with one fault planted, put in the program's
            place: half_batch (the loss over half the batch), unchanged
            (the step leaves the parameters and Adam's state as they were),
            altered_action (one action of the first act changed),
            altered_leaf (one sampled leaf of the first step moved),
            altered_row (one byte of the first sampled stack changed).
One JSON line a seed and reading on standard output. The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def readings(name: str, seeds, control: bool, faults, device=None,
             cell=None):
  from benchmark import check, harness
  from benchmark.reference.follow import follow
  cell = cell or harness.Cell.find(name)
  prioritized = cell.config["flags"].get("priority_exponent", 0.0) > 0
  for seed in seeds:
    t0 = time.perf_counter()
    r = harness.Run(cell, seed, device)
    state, handover, prog = r.set_up()
    setup = dict(r.phases)
    del state, r
    if device is None:
      torch.cuda.empty_cache()
    ref = follow(handover)
    nums = lambda p, d=None: check.numbers(p, ref, handover["draws"],
                                            prioritized, d)
    detail = {"select_margin": ref["select_margin"]}
    yield dict(seed=seed, reading="program", numbers=nums(prog, detail),
               setup=setup, detail=detail)
    if control:
      ctrl = follow(handover, "tf32")
      yield dict(seed=seed, reading="control",
                 numbers=nums(check.control_outputs(ctrl)))
    for f in faults:
      out = follow(handover, "f32", f)
      yield dict(seed=seed, reading=f,
                 numbers=nums(check.control_outputs(out)))
    yield dict(seed=seed, reading="seconds", numbers={
        "total": time.perf_counter() - t0})


def main(argv=None) -> int:
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("--workload", required=True)
  p.add_argument("--seeds", required=True)
  p.add_argument("--control", action="store_true")
  p.add_argument("--faults", default="",
                  help="Comma-separated faults of FAULTS to plant, or all.")
  args = p.parse_args(argv)
  seeds = [int(s) for s in args.seeds.split(",")]
  if not torch.cuda.is_available():
    print("calibrate: no CUDA device", file=sys.stderr)
    return 2
  from benchmark.reference.follow import FAULTS
  faults = [f for f in FAULTS if f] if args.faults == "all" else [
      f for f in args.faults.split(",") if f]
  for line in readings(args.workload, seeds, args.control, faults):
    print(json.dumps(line), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
