"""The benchmark's command: one run of one cell.

  python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
      --trace <0|1>

Prints the result as the last line of standard output (one JSON object:
correct, attempted, failed, metrics, device, with --trace 1 breakdown, and
last the compared numbers with their limits) and the compared numbers
beside their limits as the last lines of standard error. Exits 2 without a
result where the machine lacks the cell's cards, the name is unknown or
JAX was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

CHECKOUT = pathlib.Path(__file__).resolve().parent.parent


def fixed_caches() -> None:
  """Every build and kernel cache at a fixed path inside the checkout, so
  that only a checkout's first run builds (the port's own kernels build
  into .torch_kernels/ there already); set before torch is imported."""
  for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CHECKOUT / ".bench_cache" / sub)
  os.environ["USE_FLAX"] = "0"
  os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
  fixed_caches()
  p = argparse.ArgumentParser(description="One run of one benchmark cell.")
  p.add_argument("--workload", required=True)
  p.add_argument("--seed", type=int, required=True)
  p.add_argument("--seconds", type=float, required=True)
  p.add_argument("--trace", type=int, choices=(0, 1), default=0)
  args = p.parse_args(argv)
  from benchmark import check, harness
  import torch
  # One host thread for the program's few CPU ops: the host's pace is what
  # the window measures, and idle pool threads only contend for its cores.
  torch.set_num_threads(1)
  try:
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), T_START)
  except harness.RunError as e:
    print(f"benchmark: {e}", file=sys.stderr)
    return 2
  checks = result["checks"]
  for line in check.lines({k: v["value"] for k, v in checks.items()},
                          {k: v["limit"] for k, v in checks.items()}):
    print(line, file=sys.stderr)
  print(json.dumps(result), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
