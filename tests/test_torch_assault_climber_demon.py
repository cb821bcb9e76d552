"""Differential tests of the port's assault, crazy_climber and demon_attack
against the JAX package's (CPU): the vector env step for step over
auto-resets, every output and every state field exact, frames included; one
raw frame on hand-made states at the edges of the games' tests; a JAX state
taken in mid-episode and converted; the games' rules on the port's games;
and double_q/demon_attack supersteps of both engines from one JAX state
carried across by convert.

Assault splits its key in three on every raw frame (a turn test and a bomb
test for each drone); crazy_climber and demon_attack split theirs in four (a
spawn test, a column and a bias test for each pot; a turn test, a respawn
column and a bomb test for each demon). JAX's draws come from its key chain
(tests/torch_games_jax.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice import _assert_u8_close
from torch_games_jax import converted_mid_episode, jax_env_draws
from torch_games_jax import life_losses_zero_discount, near, one_env
from torch_games_jax import one_frame, random_policy, run_against_jax
from torch_games_jax import step_sweep

from dqn_zoo_tpu.agents import get_agent as jget_agent
from dqn_zoo_tpu.engine import Engine as JEngine
from dqn_zoo_tpu.engine import EngineConfig as JEngineConfig
from dqn_zoo_tpu.envs.vector import VectorEnvConfig as JEnvConfig
from dqn_zoo_torch import convert
from dqn_zoo_torch.agents import get_agent
from dqn_zoo_torch.agents.base import RMSPropState
from dqn_zoo_torch.engine import Engine, EngineConfig, SuperstepDraws
from dqn_zoo_torch.engine.superstep import leaves
from dqn_zoo_torch.envs.games import assault as aa
from dqn_zoo_torch.envs.games import crazy_climber as cc
from dqn_zoo_torch.envs.games import demon_attack as da
from dqn_zoo_torch.envs.vector import VectorEnvConfig
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _assault_end(gs):
  # Half the envs on their last life with the turret near overheating, the
  # others with the mothership one hit from down and a shot under it.
  b = gs.lives.shape[0]
  h = b // 2
  return gs._replace(
      lives=gs.lives.at[:h].set(1), heat=gs.heat.at[:h].set(90),
      mother_hp=gs.mother_hp.at[h:].set(1),
      wave=gs.wave.at[h:].set(5),
      shot_x=gs.shot_x.at[h:].set(gs.mother_x[h:] + 10.0),
      shot_y=gs.shot_y.at[h:].set(60.0),
      shot_live=gs.shot_live.at[h:].set(True))


def _climber_end(gs):
  # Half the envs on their last life with a pot falling onto the climber,
  # the others a row from the top.
  b = gs.lives.shape[0]
  h = b // 2
  return gs._replace(
      lives=gs.lives.at[:h].set(1),
      pot_live=gs.pot_live.at[:h, 0].set(True),
      pot_col=gs.pot_col.at[:h, 0].set(gs.col[:h]),
      pot_y=gs.pot_y.at[:h, 0].set(140.0),
      row=gs.row.at[h:].set(cc.ROWS - 1))


def _demon_end(gs):
  # Half the envs on their last life with a bomb over the cannon, the
  # others a kill from the next wave with a shot under the lowest demon.
  b = gs.lives.shape[0]
  h = b // 2
  return gs._replace(
      lives=gs.lives.at[:h].set(1),
      bomb_live=gs.bomb_live.at[:h, 0].set(True),
      bomb_x=gs.bomb_x.at[:h, 0].set(gs.player_x[:h] + 2.0),
      bomb_y=gs.bomb_y.at[:h, 0].set(172.0),
      kills=gs.kills.at[h:].set(da.KILLS_PER_WAVE - 1),
      shot_x=gs.shot_x.at[h:].set(gs.demon_x[h:, 2] + 2.0),
      shot_y=gs.shot_y.at[h:].set(135.0),
      shot_live=gs.shot_live.at[h:].set(True))


_PREPARE = {"assault": _assault_end, "crazy_climber": _climber_end,
            "demon_attack": _demon_end}
GAMES = ["assault", "crazy_climber", "demon_attack"]


@pytest.mark.parametrize("name", GAMES)
def test_vector_env_matches_jax_step_for_step(name):
  b = 8
  seen = dict(rewards=0, life_losses=0, game_overs=0)

  def count(before, after, out):
    live = ~out.is_first
    seen["rewards"] += int(((out.raw_reward_sum != 0) & live).sum())
    seen["life_losses"] += int(((after.game_state.lives
                                 < before.game_state.lives)
                                & live & ~out.is_last).sum())
    seen["game_overs"] += int((out.is_last & ~out.is_truncated).sum())

  firsts = run_against_jax(name, b, 40, random_policy(name, b),
                           prepare=_PREPARE[name], on_step=count)
  assert firsts > b  # auto-resets after the first groups
  assert all(v > 0 for v in seen.values()), seen


@pytest.mark.parametrize("name", GAMES)
def test_converted_mid_episode_state_renders_and_steps_as_jax(name):
  jstate = converted_mid_episode(name)
  assert bool((np.asarray(jstate.episode_frames) > 100).all())


@pytest.mark.parametrize("name", GAMES)
def test_life_loss_zero_discount(name):
  assert life_losses_zero_discount(name, 8, 150, 3) > 0


# --- assault -----------------------------------------------------------------

_CALM = dict(flip_u=[1.0] * 3, bomb_u=[1.0] * 3)  # no turn, no bomb


def test_assault_shot_kills_the_last_drone_hit():
  state = one_env(aa, shot_x=65.0, shot_y=110.0, shot_live=True,
                  drone_x=[60.0, 60.0, 0.0], drone_y=[100.0, 100.0, 0.0],
                  drone_live=[True, True, False])
  state, reward, _, _ = one_frame(aa, state, 0, **_CALM)
  assert float(reward) == aa.DRONE_POINTS
  assert state.drone_live.tolist() == [[True, False, False]]
  assert int(state.drone_delay[0, 1]) == aa.SPAWN_DELAY
  assert not bool(state.shot_live)


def test_assault_downing_the_mothership_starts_a_wave():
  state = one_env(aa, mother_hp=1, mother_x=70.0, shot_x=80.0, shot_y=55.0,
                  shot_live=True)
  state, reward, _, _ = one_frame(aa, state, 0, **_CALM)
  assert float(reward) == aa.MOTHER_POINTS
  assert int(state.wave) == 1 and int(state.mother_hp) == aa.MOTHER_HITS


def test_assault_overheating_costs_a_life():
  state = one_env(aa, heat=aa.HEAT_MAX - 1)
  s2, _, done, life_lost = one_frame(aa, state, 2, **_CALM)  # FIRE
  assert bool(life_lost) and not bool(done)
  assert int(s2.heat) == 0 and int(s2.lives) == aa.LIVES - 1
  assert int(s2.hit_pause) == aa.HIT_PAUSE
  cool, _, _, life_lost = one_frame(aa, state, 0, **_CALM)
  assert not bool(life_lost) and int(cool.heat) == aa.HEAT_MAX - 2
  last = state._replace(lives=torch.tensor([1], dtype=torch.int32))
  _, _, done, life_lost = one_frame(aa, last, 2, **_CALM)
  assert bool(done) and not bool(life_lost)


# --- crazy_climber ------------------------------------------------------------

_NO_POTS = dict(spawn_u=[1.0] * 3)


@pytest.mark.parametrize("phase,climbs", [(0, True), (100, False)])
def test_crazy_climber_rows_pay_and_shutters_block(phase, climbs):
  # Column 3's window above row 0: (0 + phase + 37) mod 180 >= 120 shuts.
  state = one_env(cc, col=3, shut_phase=[0, 0, 0, phase, 0, 0, 0])
  s2, reward, _, _ = one_frame(cc, state, 1, **_NO_POTS)  # UP
  assert int(s2.row) == int(climbs)
  assert float(reward) == (cc.ROW_POINTS if climbs else 0.0)
  assert int(s2.move_cd) == (cc.MOVE_COOLDOWN if climbs else 0)


def test_crazy_climber_pot_knocks_down_and_topping_pays():
  state = one_env(cc, col=3, row=5, pot_col=[3, 0, 0],
                  pot_y=[146.0, 0.0, 0.0], pot_live=[True, False, False])
  s2, _, done, life_lost = one_frame(cc, state, 0, **_NO_POTS)
  assert bool(life_lost) and not bool(done)
  assert int(s2.row) == 3 and int(s2.lives) == cc.LIVES - 1
  assert not bool(s2.pot_live[0, 0])
  last = state._replace(lives=torch.tensor([1], dtype=torch.int32))
  _, _, done, life_lost = one_frame(cc, last, 0, **_NO_POTS)
  assert bool(done) and not bool(life_lost)
  # The last row (its window open: (12 + 24 * 37) mod 180 = 0): a bonus,
  # and the next building.
  top = one_env(cc, col=3, row=cc.ROWS - 1, shut_phase=[12] * cc.COLS)
  s3, reward, _, _ = one_frame(cc, top, 1, **_NO_POTS)
  assert float(reward) == cc.ROW_POINTS + cc.TOP_BONUS
  assert int(s3.row) == 0 and int(s3.building) == 1


# --- demon_attack -------------------------------------------------------------

_QUIET = dict(flip_u=[1.0] * 3, bomb_u=[1.0] * 3)  # no turn, no bomb


@pytest.mark.parametrize("wave", [0, 2])
def test_demon_attack_kill_pays_by_wave_and_advances_it(wave):
  state = one_env(da, wave=wave, kills=da.KILLS_PER_WAVE - 1,
                  demon_x=[20.0, 60.0, 100.0], demon_dir=[1.0, 1.0, 1.0],
                  shot_x=102.0, shot_y=135.0, shot_live=True)
  s2, reward, _, _ = one_frame(da, state, 0, **_QUIET)
  assert float(reward) == da.BASE_POINTS * (wave + 1)
  assert s2.demon_live.tolist() == [[True, True, False]]
  assert int(s2.demon_delay[0, 2]) == da.RESPAWN_FRAMES
  assert int(s2.wave) == wave + 1 and int(s2.kills) == 0


def test_demon_attack_dead_demon_respawns_at_its_draw():
  state = one_env(da, demon_live=[True, False, True], demon_delay=[0, 1, 0])
  s2, _, _, _ = one_frame(da, state, 0, spawn_x=[30.0, 77.5, 30.0],
                          **_QUIET)
  assert bool(s2.demon_live.all()) and float(s2.demon_x[0, 1]) == 77.5


def test_demon_attack_bomb_costs_a_life():
  state = one_env(da, player_x=50.0, bomb_x=[52.0, 0.0, 0.0],
                  bomb_y=[172.0, 0.0, 0.0], bomb_live=[True, False, False])
  s2, _, done, life_lost = one_frame(da, state, 0, **_QUIET)
  assert bool(life_lost) and not bool(done)
  assert int(s2.lives) == da.LIVES - 1 and int(s2.hit_pause) == da.HIT_PAUSE
  assert not bool(s2.bomb_live.any())
  paused = state._replace(hit_pause=torch.tensor([5], dtype=torch.int32))
  _, _, _, life_lost = one_frame(da, paused, 0, **_QUIET)
  assert not bool(life_lost)
  last = state._replace(lives=torch.tensor([1], dtype=torch.int32))
  _, _, done, life_lost = one_frame(da, last, 0, **_QUIET)
  assert bool(done) and not bool(life_lost)


# --- one raw frame on hand-made states, against JAX's step --------------------


def _f32(v):
  return jnp.asarray(np.asarray(v, np.float32))


def _assault_edges(s, rng):
  """Waves 0-40 (the speed ramps' multiply-adds), live drones and the
  mothership within 2 ulps of the walls after their move, a shot at the
  drones' and the mothership's edges, every heat (the heat bar's
  multiply-add in the render)."""
  n = s.wave.shape[0]
  wave = rng.randint(0, 41, n)
  w = wave.astype(np.float32)
  m_speed = np.float32(0.2) * w + np.float32(0.8)
  d_speed = np.float32(0.3) * w + np.float32(1.4)
  dirs = np.where(rng.rand(n, 3) < 0.5, -1.0, 1.0).astype(np.float32)
  walls = np.where(dirs > 0, aa.RIGHT - aa.DRONE_W, aa.LEFT).astype(
      np.float32)
  drone_x = near(rng, [0.0], n * 3).reshape(n, 3) + walls \
      - dirs * d_speed[:, None]
  mdir = np.where(rng.rand(n) < 0.5, -1.0, 1.0).astype(np.float32)
  mwall = np.where(mdir > 0, aa.RIGHT - aa.MOTHER_W, aa.LEFT)
  mother_x = near(rng, [0.0], n) + mwall - mdir * m_speed
  drone_y = rng.uniform(52.0, 170.0, (n, 3)).astype(np.float32)
  shot_x = drone_x[:, 0] + near(rng, [-2.0, 14.0, 5.0], n)
  shot_y = drone_y[:, 0] + aa.DRONE_H + aa.SHOT_SPEED + near(
      rng, [0.0, -13.0, -6.0], n)
  return s._replace(
      wave=jnp.asarray(wave, jnp.int32), drone_x=_f32(drone_x),
      drone_y=_f32(drone_y), drone_dir=_f32(dirs),
      drone_live=jnp.asarray(rng.rand(n, 3) < 0.8),
      mother_x=_f32(mother_x), mother_dir=_f32(mdir),
      shot_x=_f32(shot_x), shot_y=_f32(shot_y),
      shot_live=jnp.asarray(rng.rand(n) < 0.8),
      heat=jnp.asarray(np.arange(n) % aa.HEAT_MAX, jnp.int32))


def _climber_edges(s, rng):
  """Buildings 0-40 (the pots' speed multiply-add, which a pot at the top
  takes as its new height), pots in the climber's column within 2 ulps of
  the hit window's edges after their fall, frames up to 100,000 and rows
  across the building (the shutters)."""
  n = s.building.shape[0]
  building = rng.randint(0, 41, n)
  speed = np.float32(0.4) * building.astype(np.float32) \
      + np.float32(cc.POT_SPEED)
  edges = [cc.CLIMBER_Y - cc.POT_H, cc.CLIMBER_Y + cc.CLIMBER_H, 210.0]
  pot_y = near(rng, edges, n * 3).reshape(n, 3) - speed[:, None]
  pot_y[:, 0] = 0.0
  col = np.asarray(s.col)
  return s._replace(
      building=jnp.asarray(building, jnp.int32), pot_y=_f32(pot_y),
      pot_col=jnp.asarray(np.stack([col] * 3, 1), jnp.int32),
      pot_live=jnp.ones_like(s.pot_live),
      frame=jnp.asarray(rng.randint(0, 100_000, n), jnp.int32),
      row=jnp.asarray(rng.randint(0, cc.ROWS + 1, n), jnp.int32))


def _demon_edges(s, rng):
  """Waves 0-40 (the weave's multiply-add), demons within 2 ulps of the
  walls after their move, and a shot at the edges of a demon's box."""
  n = s.wave.shape[0]
  wave = rng.randint(0, 41, n)
  speed = np.float32(0.3) * wave.astype(np.float32) + np.float32(1.2)
  dirs = np.where(rng.rand(n, 3) < 0.5, -1.0, 1.0).astype(np.float32)
  walls = np.where(dirs > 0, da.RIGHT - da.DEMON_W, da.LEFT)
  demon_x = near(rng, [0.0, 0.0, 3.0], n * 3).reshape(n, 3) + walls \
      - dirs * speed[:, None]
  band = rng.randint(0, da.NUM_DEMONS, n)
  top = np.asarray(da.DEMON_YS, np.float32)[band]
  shot_y = top + da.SHOT_SPEED + near(rng, [8.0, -6.0, 2.0], n)
  shot_x = demon_x[np.arange(n), band] + dirs[np.arange(n), band] \
      * speed + near(rng, [-2.0, 8.0, 3.0], n)
  return s._replace(
      wave=jnp.asarray(wave, jnp.int32), demon_x=_f32(demon_x),
      demon_dir=_f32(dirs), shot_x=_f32(shot_x), shot_y=_f32(shot_y),
      shot_live=jnp.ones_like(s.shot_live))


@pytest.mark.parametrize("name,edit", [("assault", _assault_edges),
                                       ("crazy_climber", _climber_edges),
                                       ("demon_attack", _demon_edges)])
def test_step_on_hand_made_states_matches_jax(name, edit):
  _, reward, _ = step_sweep(name, edit, renders=128)
  assert bool((reward != 0).any())


# --- double_q/demon_attack supersteps ----------------------------------------


def _engines():
  overrides = dict(target_network_update_period=96)
  jspec = dataclasses.replace(jget_agent("double_q"), **overrides)
  tspec = dataclasses.replace(get_agent("double_q"), **overrides)
  common = dict(game="demon_attack", num_envs=4, slots_per_stream=16,
                batch_size=8, learn_every=1, updates_per_learn=1,
                total_train_frames=20_000)
  return (JEngine(JEngineConfig(agent=jspec, env_config=JEnvConfig(
      episode_frame_cap=36), **common)),
          Engine(EngineConfig(agent=tspec, env_config=VectorEnvConfig(
              episode_frame_cap=36), **common), device="cpu"))


def _jax_draws(jeng, jstate) -> SuperstepDraws:
  """The draws JAX's Engine.superstep makes from jstate.rng (uniform
  replay, one update a superstep)."""
  cfg = jeng.config
  t = lambda x: torch.from_numpy(np.array(x))
  _, act_key, learn_key = jax.random.split(jstate.rng, 3)
  _, policy_key = jax.random.split(act_key)
  explore_key, uniform_key = jax.random.split(policy_key)
  b = cfg.num_envs
  u_key = jax.random.split(jax.random.split(learn_key)[0], 3)[0]
  return SuperstepDraws(
      t(jax.random.uniform(explore_key, (b,))),
      t(jax.random.randint(uniform_key, (b,), 0, da.GAME.num_actions)),
      t(jax.random.uniform(u_key, (1, cfg.batch_size))),
      jax_env_draws("demon_attack", jstate.env))


def test_double_q_demon_attack_supersteps_match_jax():
  """Bounds as the c51/seaquest supersteps': rows, the tree, the game state
  and the frame count exact; frames within K2's ±1; loss rtol 1e-3; 99.9 %
  of the parameters within 2e-6, all within max(5e-5, lr/2)."""
  jeng, teng = _engines()
  bound = max(5e-5, teng.spec.learning_rate / 2)
  jstate = jax.device_put(jax.device_get(jax.jit(jeng.init)(
      jax.random.PRNGKey(6))))
  tstate = convert.engine_state_from_jax(teng, jax.device_get(jstate))
  jstep = jax.jit(jeng.superstep)
  learned = swaps = 0
  for step in range(12):
    draws = _jax_draws(jeng, jax.device_get(jstate))
    prev_target = [p.clone() for p in leaves(tstate.target_params)]
    jstate = jstep(jstate)
    tstate = teng.superstep(tstate, draws)
    ref = convert.engine_state_from_jax(teng, jax.device_get(jstate))

    for f in ("stack_count", "action", "reward", "discount", "is_terminal",
              "row_t"):
      assert torch.equal(getattr(tstate.replay, f), getattr(ref.replay, f)), \
          (f, step)
    _assert_u8_close(tstate.replay.frames, ref.replay.frames, step)
    assert torch.equal(tstate.replay.indicator_tree[0],
                       ref.replay.indicator_tree[0])
    for field, a, w in zip(ref.env.game_state._fields,
                           tstate.env.game_state, ref.env.game_state):
      assert torch.equal(a, w), (field, step)
    assert tstate.env_frames == ref.env_frames

    assert tstate.telemetry.learn_steps == ref.telemetry.learn_steps
    if ref.telemetry.learn_steps:
      np.testing.assert_allclose(float(tstate.telemetry.last_loss),
                                 float(ref.telemetry.last_loss), rtol=1e-3)
    for tree, ref_tree in ((tstate.online_params, ref.online_params),
                           (tstate.target_params, ref.target_params)):
      diff = torch.cat([(a - w).detach().abs().flatten() for a, w in
                        zip(leaves(tree), leaves(ref_tree))])
      assert float(diff.max()) <= bound, (step, float(diff.max()))
      assert float((diff <= 2e-6).float().mean()) >= 0.999, step
    learned = ref.telemetry.learn_steps
    swaps += any(not torch.equal(a, b) for a, b in
                 zip(prev_target, leaves(tstate.target_params)))
  assert learned >= 5 and swaps >= 1
  assert bool(ref.replay.is_terminal.any())  # truncations were inserted
  assert isinstance(tstate.opt_state, RMSPropState)
