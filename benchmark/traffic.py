"""The benchmark's one traffic generator, driven by a traffic file.

A cell's traffic is the steady state of a long training run: a full replay,
the schedules at a late frame count and episodes at spread phases. Every
number here comes from `--seed` through a counter-based hash, so any replay
row can be made again on its own: the set-up fills the replay with these
rows and the reference rebuilds the rows a sample touched, from the same
seed and without reading the program's replay.

Fill rows (stream s, agent step t):
  phase      (t + off_s) mod episode_steps, off_s from the seed: a row with
             phase 0 starts an episode (stack count 1, reward and discount
             0), one with phase episode_steps - 1 ends it (terminal,
             discount 0);
  stack      min(phase + 1, 4);
  reward     -1 or +1 once in `reward_period` rows, else 0;
  action     uniform over the game's actions;
  frame      84 x 84 bytes, uniform.
"""

from __future__ import annotations

import json
import pathlib
from typing import NamedTuple

import torch

ROOT = pathlib.Path(__file__).resolve().parent
M32 = 0xFFFFFFFF
FRAME = 84
WORDS = FRAME * FRAME // 4  # one 32-bit hash gives four pixels


def load(kind: str, name: str) -> dict:
  """benchmark/<kind>/<name>.json."""
  path = ROOT / kind / f"{name}.json"
  if not path.is_file():
    raise KeyError(f"no {kind} file {path.name} under benchmark/{kind}/")
  return json.loads(path.read_text())


def _mul32(x, c: int):
  """(x * c) mod 2**32 for x in [0, 2**32), without an int64 overflow."""
  lo, hi = c & 0xFFFF, c >> 16
  return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def mix32(x):
  """A 32-bit integer hash (lowbias32) of a Python int or an int64 tensor
  whose values lie in [0, 2**32)."""
  x = x ^ (x >> 16)
  x = _mul32(x, 0x7FEB352D)
  x = x ^ (x >> 15)
  x = _mul32(x, 0x846CA68B)
  return x ^ (x >> 16)


def key(seed: int, salt: int) -> int:
  """A 32-bit key from any whole seed (more than 32 bits too) and a salt."""
  lo, hi = seed & M32, (seed >> 32) & M32
  return mix32(mix32(lo ^ mix32(hi ^ 0x5BD1E995)) ^ mix32(salt & M32))


class Rows(NamedTuple):
  """Replay rows, each of the fields (N,) but `frame` (N, 84, 84)."""

  frame: torch.Tensor  # uint8
  stack_count: torch.Tensor  # int32
  action: torch.Tensor  # int32
  reward: torch.Tensor  # float32
  discount: torch.Tensor  # float32
  is_terminal: torch.Tensor  # bool


class FillRows:
  """The fill rows of one seed and one traffic file."""

  def __init__(self, seed: int, traffic: dict, num_actions: int):
    fill = traffic["replay_fill"]
    self.episode_steps = int(fill["episode_steps"])
    self.reward_period = int(fill["reward_period"])
    self.num_actions = num_actions
    self.k_offset = key(seed, 1)
    self.k_meta = key(seed, 2)
    self.k_frame = key(seed, 3)

  def _row_hash(self, k: int, stream: torch.Tensor, step: torch.Tensor):
    return mix32(k ^ mix32((stream * 0x9E3779B1 + step) & M32))

  def phase(self, stream: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    off = mix32(self.k_offset ^ stream) % self.episode_steps
    return (step + off) % self.episode_steps

  def meta(self, stream: torch.Tensor, step: torch.Tensor):
    """(stack_count, action, reward, discount, is_terminal) of rows given
    by int64 tensors of streams and steps (any equal shapes)."""
    stream, step = stream.long(), step.long()
    phase = self.phase(stream, step)
    first = phase == 0
    terminal = phase == self.episode_steps - 1
    h = self._row_hash(self.k_meta, stream, step)
    r = torch.where(h % self.reward_period == 0, -1.0,
                    torch.where(h % self.reward_period == 1, 1.0, 0.0))
    zero = torch.zeros_like(r)
    reward = torch.where(first, zero, r).to(torch.float32)
    discount = torch.where(first | terminal, zero,
                           torch.full_like(r, 0.99)).to(torch.float32)
    return (torch.clamp(phase + 1, max=4).to(torch.int32),
            ((h >> 8) % self.num_actions).to(torch.int32), reward, discount,
            terminal)

  def frames(self, stream: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """uint8 (*shape, 84, 84) frames of rows given by int64 tensors."""
    rk = self._row_hash(self.k_frame, stream.long(), step.long())
    words = torch.arange(WORDS, dtype=torch.int64, device=rk.device)
    v = mix32(rk[..., None] ^ _mul32(words, 0x27D4EB2F))
    b = torch.stack([(v >> (8 * j)) & 0xFF for j in range(4)], dim=-1)
    return b.to(torch.uint8).reshape(*rk.shape, FRAME, FRAME)

  def rows(self, stream: torch.Tensor, step: torch.Tensor) -> Rows:
    return Rows(self.frames(stream, step), *self.meta(stream, step))


def fill_inserts(traffic: dict, num_envs: int) -> int:
  """Inserts per stream that bring the replay's insert counter to the
  steady-state frame count: one row a stream per agent step of 4 frames."""
  frames = int(traffic["steady_state_frames"])
  return -(-frames // (4 * num_envs))


def spread_values(seed: int, spread: dict, num_envs: int,
                  device) -> torch.Tensor:
  """The episode-phase field's values, one a stream: the same multiset for
  every seed (0 .. values - 1, repeated), in an order drawn from the seed."""
  n = int(spread["values"])
  base = torch.arange(num_envs, dtype=torch.int64) % n
  gen = torch.Generator()
  gen.manual_seed(key(seed, 4))
  return base[torch.randperm(num_envs, generator=gen)].to(device)


def device_generator(seed: int, salt: int, device) -> torch.Generator:
  gen = torch.Generator(device=device)
  gen.manual_seed(key(seed, salt))
  return gen
