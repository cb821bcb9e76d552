"""Differential tests of the port's exact Pillow resize (`resize_method="pil"`)
against the JAX package's and against Pillow itself (CPU): the resize at
tests/test_pil_resize.py's sizes, the coefficient rows, the golden digest,
the whole `pil` preprocessing on random and game frames, and dqn/pong
supersteps of both engines at `pil` with every frame exact."""

import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_slice import jax_draws

from dqn_zoo_tpu import prep as jprep
from dqn_zoo_tpu.agents import get_agent as jget_agent
from dqn_zoo_tpu.engine import Engine as JEngine
from dqn_zoo_tpu.engine import EngineConfig as JEngineConfig
from dqn_zoo_tpu.envs.vector import VectorEnvConfig as JEnvConfig
from dqn_zoo_tpu.prep.pil_resize import resize_pil_exact as jresize
from dqn_zoo_torch import convert
from dqn_zoo_torch.agents import get_agent
from dqn_zoo_torch.engine import Engine, EngineConfig
from dqn_zoo_torch.engine.superstep import leaves
from dqn_zoo_torch.envs.api import get_game
from dqn_zoo_torch.envs.vector import VectorAtariEnv, VectorEnvConfig
from dqn_zoo_torch.prep import atari as tprep
from dqn_zoo_torch.prep.pil_resize import pil_bilinear_coeffs
from dqn_zoo_torch.prep.pil_resize import resize_pil_exact
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# tests/test_pil_resize.py's digest of Pillow's resize of RandomState(42)'s
# (210, 160) image, which both Pillow and the JAX package reproduce.
GOLDEN_RESIZE_DIGEST = (
    "a28154a96c0bab2071ed282033e28a42c60bf414c8842183bedc25f0dc5798eb")


def _pillow(img):
  return np.asarray(Image.fromarray(img).resize(
      (84, 84), Image.Resampling.BILINEAR))


@pytest.mark.parametrize("hw", [(210, 160), (100, 84), (84, 84), (64, 128),
                                (37, 53), (250, 160)])
def test_resize_matches_jax_and_pillow(hw):
  h, w = hw
  rng = np.random.RandomState(h * 1000 + w)
  imgs = rng.randint(0, 256, (3, h, w), np.uint8)
  got = resize_pil_exact(torch.from_numpy(imgs)).numpy()
  assert got.dtype == np.uint8 and got.shape == (3, 84, 84)
  np.testing.assert_array_equal(got, np.asarray(jresize(jnp.asarray(imgs))))
  for i in range(3):
    np.testing.assert_array_equal(got[i], _pillow(imgs[i]))


def test_coefficients_match_jax_and_rows_sum_to_unity_fixed_point():
  """Pillow's normalized rows quantize to ~2^22; clip8 then maps a constant
  image to itself (no DC gain)."""
  from dqn_zoo_tpu.prep.pil_resize import pil_bilinear_coeffs as jcoeffs
  for in_size in (160, 210, 84, 64):
    k = pil_bilinear_coeffs(in_size, 84)
    np.testing.assert_array_equal(k, jcoeffs(in_size, 84))
    assert np.all(np.abs(k.sum(axis=1) - (1 << 22)) <= 4), in_size
  const = torch.full((210, 160), 137, dtype=torch.uint8)
  assert bool((resize_pil_exact(const) == 137).all())


def test_golden_digest():
  img = np.random.RandomState(42).randint(0, 256, (210, 160), np.uint8)
  got = resize_pil_exact(torch.from_numpy(img)).numpy()
  assert hashlib.sha256(got.tobytes()).hexdigest() == GOLDEN_RESIZE_DIGEST


def test_pil_preprocessing_matches_jax_on_random_and_game_frames():
  """max, luma and the resize, against JAX's prep.atari at `pil`: random
  frames (where the luma's rounding shows: the port's fused luma is XLA's)
  and pooled breakout frames with one of each pair zeroed, as at episode
  boundaries."""
  rng = np.random.RandomState(3)
  f1 = rng.randint(0, 256, (4, 210, 160, 3), np.uint8)
  f2 = rng.randint(0, 256, (4, 210, 160, 3), np.uint8)
  env = VectorAtariEnv(get_game("breakout"), 6, device="cpu")
  gen = torch.Generator().manual_seed(0)
  state = env.init(gen)
  for _ in range(3):
    state, out = env.step(state, torch.ones((6,), dtype=torch.int64),
                          env.draws(gen))
  g1, g2 = out.frame_penult.numpy(), out.frame_last.numpy()
  g1[0] = 0
  for a, b in ((f1, f2), (g1, g2)):
    want = np.asarray(jax.jit(lambda x, y: jprep.pooled_frame_to_84(
        x, y, resize_method="pil"))(jnp.asarray(a), jnp.asarray(b)))
    got = tprep.pooled_frame_to_84(torch.from_numpy(a), torch.from_numpy(b),
                                   "pil").numpy()
    np.testing.assert_array_equal(got, want)
  # The luma alone: XLA's fused form, exact on every random pixel.
  np.testing.assert_array_equal(
      tprep.rgb_to_y_fused(torch.from_numpy(f1)).numpy(),
      np.asarray(jax.jit(jprep.rgb_to_y)(jnp.asarray(f1))))


def _pil_engines(num_envs=4):
  overrides = dict(target_network_update_period=48)
  jspec = dataclasses.replace(jget_agent("dqn"), **overrides)
  tspec = dataclasses.replace(get_agent("dqn"), **overrides)
  common = dict(game="pong", num_envs=num_envs, slots_per_stream=16,
                batch_size=8, learn_every=1, updates_per_learn=1,
                total_train_frames=20_000, resize_method="pil")
  jeng = JEngine(JEngineConfig(agent=jspec, env_config=JEnvConfig(
      episode_frame_cap=36), **common))
  teng = Engine(EngineConfig(agent=tspec, env_config=VectorEnvConfig(
      episode_frame_cap=36), **common), device="cpu")
  return jeng, teng


def test_pil_supersteps_match_jax_with_every_frame_exact():
  """dqn/pong supersteps of both engines at `pil`: every replay row, the
  replay's frames and the frame stacks exact (no ±1 pixel, as `fast`
  allows); the loss rtol 1e-3 and the parameters at the slice test's
  bounds (all within 5e-5, 99.9 % within 2e-6): f32 sums in another order
  on the two sides."""
  jeng, teng = _pil_engines()
  jstate = jeng.init(jax.random.PRNGKey(0))
  tstate = convert.engine_state_from_jax(teng, jax.device_get(jstate))
  jstep = jax.jit(jeng.superstep)
  for step in range(10):
    draws = jax_draws(jeng, jax.device_get(jstate))
    jstate = jstep(jstate)
    tstate = teng.superstep(tstate, draws)
    ref = convert.engine_state_from_jax(teng, jax.device_get(jstate))
    for f in ("frames", "stack_count", "action", "reward", "discount",
              "is_terminal", "row_t"):
      assert torch.equal(getattr(tstate.replay, f), getattr(ref.replay, f)), \
          (f, step)
    assert torch.equal(tstate.stack.frames, ref.stack.frames), step
    assert tstate.env_frames == ref.env_frames
    assert tstate.telemetry.learn_steps == ref.telemetry.learn_steps
    if ref.telemetry.learn_steps:
      np.testing.assert_allclose(float(tstate.telemetry.last_loss),
                                 float(ref.telemetry.last_loss), rtol=1e-3)
    diff = torch.cat([(a - w).detach().abs().flatten() for a, w in
                      zip(leaves(tstate.online_params),
                          leaves(ref.online_params))])
    assert float(diff.max()) <= 5e-5, (step, float(diff.max()))
    assert float((diff <= 2e-6).float().mean()) >= 0.999, step
  assert ref.telemetry.learn_steps >= 3
  assert bool(ref.replay.is_terminal.any())  # truncations were inserted
