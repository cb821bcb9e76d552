"""How far two summation orders move the bf16 DQN network's outputs.

Card and CPU multiply the same bf16-rounded operands exactly and sum the
products in other orders. Each layer's f32 output may then differ in its
last bits, and rounding it to the next layer's bf16 operand can land on the
neighbouring bf16 value; such flips carry on to q. This tool measures both
effects.

  python tools/torch_bf16_order_noise.py [--batches=12] [--envs=64]
      On the CPU: pong frames from the port's engine and freshly initialised
      bf16 DQN networks; the network with f32 sums against the same network
      with f64 sums (a second order), layer by layer on the same input and
      end to end, each beside the f32 network's distance.

  python tools/torch_bf16_order_noise.py --card_runs=4
      On the card: `chip_smoke.phase_bf16_path` that many times (each a fresh
      dqn/pong bf16 trainer at the CLI defaults), printing its BF16_MAIN
      line, or its failure, for each run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dqn_zoo_torch.nets import core, dqn_atari_network  # noqa: E402


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
  return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def forward(params, obs, sums: torch.dtype):
  """The bf16 DQN network with every sum taken in `sums`, rounded to f32
  after each layer: (q, [(layer input, layer name)])."""
  r = lambda t: t.to(torch.bfloat16).to(sums)
  inputs = []
  h = obs.to(torch.float32) * (1.0 / 255.0)
  for name, stride in (("conv1", 4), ("conv2", 2), ("conv3", 1)):
    p = params["torso"][name]
    inputs.append((h, name))
    y = F.conv2d(r(h.permute(0, 3, 1, 2)), r(core.hwio_to_oihw(p["w"])),
                 stride=stride).float() + p["b"][:, None, None]
    h = torch.relu(y).permute(0, 2, 3, 1)
  h = core.flatten(h)
  for name in ("hidden", "out"):
    p = params["head"][name]
    inputs.append((h, name))
    h = (r(h) @ r(p["w"])).float() + p["b"]
    if name == "hidden":
      h = torch.relu(h)
  return h, inputs


def layer(params, name, h, sums):
  r = lambda t: t.to(torch.bfloat16).to(sums)
  if name.startswith("conv"):
    p = params["torso"][name]
    stride = {"conv1": 4, "conv2": 2, "conv3": 1}[name]
    return F.conv2d(r(h.permute(0, 3, 1, 2)), r(core.hwio_to_oihw(p["w"])),
                    stride=stride).float() + p["b"][:, None, None]
  p = params["head"][name]
  return (r(h) @ r(p["w"])).float() + p["b"]


def cpu_main(batches: int, envs: int) -> None:
  from dqn_zoo_torch.run.train import build_engine
  torch.set_num_threads(min(4, os.cpu_count() or 1))
  engine = build_engine("dqn", "pong", num_envs=envs, replay_capacity=4096,
                        min_replay_capacity_fraction=1.0,
                        spec_overrides=dict(compute_dtype="bfloat16"),
                        device="cpu")
  state = engine.init(seed=3)
  rows = []
  with torch.no_grad():
    for k in range(batches):
      state = engine.run(state, 15)
      obs = state.stack.frames
      for seed in range(3):
        params = dqn_atari_network(6, "bfloat16").init(
            torch.Generator().manual_seed(seed + 10 * k), "cpu")
        q32, inputs = forward(params, obs, torch.float32)
        q64, _ = forward(params, obs, torch.float64)
        f32 = dqn_atari_network(6).apply(params, obs).q_values
        layers = {name: _rel(layer(params, name, h, torch.float64),
                             layer(params, name, h, torch.float32))
                  for h, name in inputs}
        rows.append(dict(q=_rel(q64, q32), f32_q=_rel(f32, q32),
                         layers=layers))
        print(json.dumps(rows[-1]), flush=True)
  q = sorted(r["q"] / r["f32_q"] for r in rows)
  print("SUMMARY " + json.dumps(dict(
      nets=len(rows), envs=envs,
      q_min=min(r["q"] for r in rows), q_max=max(r["q"] for r in rows),
      q_share_of_f32_min=q[0], q_share_of_f32_max=q[-1],
      layer_max=max(max(r["layers"].values()) for r in rows),
      layer_min=min(min(r["layers"].values()) for r in rows))))


def card_main(runs: int) -> None:
  import chip_smoke
  dev = torch.device("cuda")
  for i in range(runs):
    try:
      chip_smoke.phase_bf16_path(dev)
    except SystemExit as e:
      print(f"RUN {i} FAILED {e}", flush=True)


if __name__ == "__main__":
  ap = argparse.ArgumentParser()
  ap.add_argument("--batches", type=int, default=12)
  ap.add_argument("--envs", type=int, default=64)
  ap.add_argument("--card_runs", type=int, default=0)
  a = ap.parse_args()
  if a.card_runs:
    card_main(a.card_runs)
  else:
    cpu_main(a.batches, a.envs)
