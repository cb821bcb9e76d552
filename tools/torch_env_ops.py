"""Counts the eager work of the port's vector env step on the CPU, for the
reckoning of a prediction of its time on the card.

For each game: the torch ops one `VectorAtariEnv.step` launches at B envs
(torch profiler, view-like ops left out), for a group that runs the reset
branch (one env resetting) and for one that does not; and, from a random
rollout at 8 envs, the agent steps an episode lasts. Prints one JSON line
per game. CPU only; imports nothing of JAX or of dqn_zoo_tpu.

  python3 tools/torch_env_ops.py [pong seaquest ...] [--envs=128]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# Ops that launch no kernel: views, shape changes, allocations, dispatch.
_NO_KERNEL = {
    "aten::empty", "aten::empty_like", "aten::empty_strided",
    "aten::as_strided", "aten::unsqueeze", "aten::squeeze", "aten::view",
    "aten::reshape", "aten::_reshape_alias", "aten::_unsafe_view",
    "aten::expand", "aten::select", "aten::slice", "aten::t",
    "aten::transpose", "aten::detach", "aten::detach_", "aten::alias",
    "aten::lift_fresh", "aten::to", "aten::_to_copy", "aten::resolve_conj",
    "aten::resolve_neg", "aten::result_type", "aten::index_put_"}


def count_ops(env, state, actions, draws) -> int:
  import torch
  with torch.profiler.profile() as prof:
    env.step(state, actions, draws)
  return sum(e.count for e in prof.key_averages()
             if e.key.startswith("aten::") and e.key not in _NO_KERNEL)


def main() -> int:
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("games", nargs="*", default=["pong", "seaquest"])
  p.add_argument("--envs", type=int, default=128)
  p.add_argument("--rollout_steps", type=int, default=400)
  args = p.parse_args()
  sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
      __file__))))
  import numpy as np
  import torch
  from dqn_zoo_torch.envs.api import get_game
  from dqn_zoo_torch.envs.vector import VectorAtariEnv

  for name in args.games:
    game = get_game(name)
    b = args.envs
    env = VectorAtariEnv(game, b, device="cpu")
    gen = torch.Generator().manual_seed(0)
    state = env.init(gen)
    state, _ = env.step(state, torch.zeros(b, dtype=torch.int64),
                        env.draws(gen))
    ops = {}
    for label, reset in (("reset_group", True), ("plain_group", False)):
      needs = torch.zeros(b, dtype=torch.bool)
      needs[0] = reset
      actions = torch.randint(0, game.num_actions, (b,), generator=gen)
      ops[label] = count_ops(env, state._replace(needs_reset=needs), actions,
                             env.draws(gen))

    small = VectorAtariEnv(game, 8, device="cpu")
    gen = torch.Generator().manual_seed(6)
    rng = np.random.RandomState(6)
    state = small.init(gen)
    episodes = 0
    for step in range(args.rollout_steps):
      actions = torch.from_numpy(rng.randint(0, game.num_actions, 8)).long()
      state, out = small.step(state, actions, small.draws(gen))
      if step:
        episodes += int(out.is_first.sum())
    env_steps = 8 * (args.rollout_steps - 1)
    print(json.dumps(dict(
        game=name, envs=b, ops_per_group=ops, rollout_envs=8,
        rollout_env_steps=env_steps, episodes_started=episodes,
        env_steps_per_episode=env_steps / max(episodes, 1),
        device="cpu")), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
