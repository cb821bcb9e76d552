"""What the vector env's reset branch costs on the card, eager and as its
CUDA graph (dqn_zoo_torch/envs/vector.py).

For each game and batch size: the eager branch's launches (CPU-activity
profile of one `_reset_all`); host ms (call to return) and wall ms
(to a synchronize) of the eager branch and of a graph replay, medians,
without a profiler and under a CUDA-activity one (what a traced benchmark
run pays); the graph's device ms a replay, back to back, by CUDA events;
and the capture's seconds. Prints one JSON line.

  python3 tools/torch_reset_probe.py [--games pong:128,ms_pacman:128,...]
"""

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from dqn_zoo_torch.device import resolve_device  # noqa: E402
from dqn_zoo_torch.envs import api  # noqa: E402
from dqn_zoo_torch.envs.vector import VectorAtariEnv  # noqa: E402

ACT = torch.profiler.ProfilerActivity
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaMemsetAsync",
            "cudaMemcpyAsync")


def _timed(fn, draws, n: int) -> dict:
  host, wall = [], []
  for _ in range(n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(draws)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    host.append(1e3 * (t1 - t0))
    wall.append(1e3 * (t2 - t0))
  return dict(host_ms=statistics.median(host), wall_ms=statistics.median(wall))


def probe(name: str, batch: int, dev: torch.device) -> dict:
  env = VectorAtariEnv(api.get_game(name), batch, device=dev)
  gen = torch.Generator(device=dev)
  gen.manual_seed(1)
  draws = env.draws(gen)
  t0 = time.perf_counter()
  env._reset(draws)  # the capture
  torch.cuda.synchronize()
  out = dict(capture_s=time.perf_counter() - t0)
  with torch.profiler.profile(activities=[ACT.CPU]) as prof:
    env._reset_all(draws)
    torch.cuda.synchronize()
  out["eager_launches"] = sum(e.count for e in prof.key_averages()
                              if e.key in LAUNCHES)
  out["eager"] = _timed(env._reset_all, draws, 10)
  out["graph"] = _timed(env._reset, draws, 30)
  prof = torch.profiler.profile(activities=[ACT.CUDA])
  prof.start()
  out["eager_profiled"] = _timed(env._reset_all, draws, 5)
  out["graph_profiled"] = _timed(env._reset, draws, 10)
  prof.stop()
  start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  torch.cuda.synchronize()
  start.record()
  for _ in range(20):
    env._reset(draws)
  stop.record()
  torch.cuda.synchronize()
  out["graph_device_ms"] = start.elapsed_time(stop) / 20
  return out


def main() -> None:
  p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  p.add_argument("--games", default="pong:128,ms_pacman:128,seaquest:128,"
                 "pong:4")
  args = p.parse_args()
  dev = resolve_device(None)  # the card; raises without one
  card = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True).stdout
  res = dict(card=card.strip(), torch=torch.__version__,
             cuda=torch.version.cuda)
  for item in args.games.split(","):
    name, b = item.split(":")
    res[f"{name}.B{b}"] = probe(name, int(b), dev)
  print(json.dumps(res))


if __name__ == "__main__":
  main()
