"""Differential tests of the port's fishing_derby, ms_pacman and phoenix
against the JAX package's (CPU): the vector env step for step over
auto-resets, every output and every state field exact, frames included; one
raw frame on hand-made states at the edges of the games' tests; a JAX state
taken in mid-episode and converted; and the games' rules on the port's
games.

Fishing_derby splits its key twice in a row on every raw frame (the escape
test, then the respawn edge); ms_pacman splits in three and draws each
ghost's four direction scores once, for their noise and for a random pick
(and draws nothing at init); phoenix splits in four (a turn test, a dive
test and a respawn column for each bird). JAX's draws come from its key
chain (tests/torch_games_jax.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_games_jax import converted_mid_episode
from torch_games_jax import life_losses_zero_discount, near, one_env
from torch_games_jax import one_frame, random_policy, run_against_jax
from torch_games_jax import step_sweep

from dqn_zoo_torch.envs.games import fishing_derby as fd
from dqn_zoo_torch.envs.games import ms_pacman as mp
from dqn_zoo_torch.envs.games import phoenix as ph
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

f32 = np.float32
GAMES = ["fishing_derby", "ms_pacman", "phoenix"]


def _derby_end(gs):
  # Half the envs with the opponent 3 points from 99 just before his next
  # catch, the others with a deep fish hooked just under the surface.
  b = gs.frame.shape[0]
  h = b // 2
  return gs._replace(
      opp_score=gs.opp_score.at[:h].set(96.0),
      frame=gs.frame.at[:h].set(fd.OPP_CATCH_EVERY - 9),
      hooked_lane=gs.hooked_lane.at[h:].set(4),
      hook_y=gs.hook_y.at[h:].set(fd.WATER_TOP + 5.0))


def _pacman_end(gs):
  # Every env with a ghost (not frightened) next to the player, half of
  # them on their last life.
  b = gs.lives.shape[0]
  h = b // 2
  return gs._replace(
      lives=gs.lives.at[:h].set(1),
      gr=gs.gr.at[:, 0].set(gs.pr), gc=gs.gc.at[:, 0].set(gs.pc + 1),
      fright=gs.fright.at[:].set(0))


def _phoenix_end(gs):
  # Every env with a diving bird right over the ship and the shield down,
  # half of them on their last life; a shot under the lowest bird of the
  # other half.
  b = gs.lives.shape[0]
  h = b // 2
  return gs._replace(
      lives=gs.lives.at[:h].set(1),
      bird_diving=gs.bird_diving.at[:, 7].set(True),
      bird_x=gs.bird_x.at[:, 7].set(gs.player_x), bird_y=gs.bird_y.at[
          :, 7].set(170.0), shield=gs.shield.at[:].set(0),
      shield_cd=gs.shield_cd.at[:].set(30),
      shot_x=gs.shot_x.at[h:].set(gs.bird_x[h:, 4] + 3.0),
      shot_y=gs.shot_y.at[h:].set(ph.RANK_YS[1] + 10.0),
      shot_live=gs.shot_live.at[h:].set(True))


_PREPARE = {"fishing_derby": _derby_end, "ms_pacman": _pacman_end,
            "phoenix": _phoenix_end}


@pytest.mark.parametrize("name", GAMES)
def test_vector_env_matches_jax_step_for_step(name):
  b = 8
  seen = dict(rewards=0, game_overs=0)
  if name != "fishing_derby":
    seen["life_losses"] = 0

  def count(before, after, out):
    live = ~out.is_first
    seen["rewards"] += int(((out.raw_reward_sum != 0) & live).sum())
    seen["game_overs"] += int((out.is_last & ~out.is_truncated).sum())
    if "life_losses" in seen:
      seen["life_losses"] += int(((after.game_state.lives
                                   < before.game_state.lives)
                                  & live & ~out.is_last).sum())

  firsts = run_against_jax(name, b, 32, random_policy(name, b),
                           prepare=_PREPARE[name], on_step=count)
  assert firsts > b  # auto-resets after the first groups
  assert all(v > 0 for v in seen.values()), seen


@pytest.mark.parametrize("name", GAMES)
def test_converted_mid_episode_state_renders_and_steps_as_jax(name):
  # B=8 shares the step JAX compiled for the test above. Random play loses
  # ms_pacman's three lives within 160 frames in some envs, which have
  # started again: most envs are in mid-episode.
  jstate = converted_mid_episode(name, b=8)
  assert float(np.median(np.asarray(jstate.episode_frames))) > 40


@pytest.mark.parametrize("name", ["ms_pacman", "phoenix"])
def test_life_loss_zero_discount(name):
  assert life_losses_zero_discount(name, 8, 150, 3) > 0


# --- fishing_derby ------------------------------------------------------------

_HOLD = dict(escape=False, left_edge=True)


def test_fishing_derby_bites_lands_and_pays_by_depth():
  # A free hook over lane 4's fish bites it (the first lane it overlaps).
  y4 = fd.lane_y(4)
  state = one_env(fd, hook_x=40.0, hook_y=y4, fish_x=[40.0] * fd.NUM_LANES,
                  fish_dir=[1.0] * fd.NUM_LANES)
  s2, _, _, _ = one_frame(fd, state, 0, **_HOLD)
  assert int(s2.hooked_lane) == 4 and float(s2.fish_x[0, 4]) == 40.0
  # Reeled up to the surface, it lands: lane 4 pays 6, and a new fish
  # enters at the drawn edge.
  top = s2._replace(hook_y=torch.tensor([fd.WATER_TOP + 5.0]))
  s3, reward, _, _ = one_frame(fd, top, 2, **_HOLD)  # UP
  assert float(reward) == fd.LANE_VALUES[4] and float(s3.my_score) == 6.0
  assert int(s3.hooked_lane) == -1 and float(s3.fish_x[0, 4]) == 10.0


def test_fishing_derby_lands_above_the_shark_and_the_opponent_wins():
  # The shark's band (hook_y <= 78) lies above the landing line (88): a
  # fish reeled up under the shark's mouth lands and pays lane 2's 4.
  state = one_env(fd, hooked_lane=2, hook_x=50.0, hook_y=80.0,
                  shark_x=40.0, shark_dir=1.0)
  s2, reward, _, _ = one_frame(fd, state, 2, **_HOLD)  # UP
  assert float(s2.shark_x) == f32(41.6)
  assert float(reward) == fd.LANE_VALUES[2] and int(s2.hooked_lane) == -1
  assert float(s2.hook_y) == fd.WATER_TOP + 10.0
  # Deeper, without UP, the line sinks back and the fish may shake off.
  deep = state._replace(hook_y=torch.tensor([100.0]))
  s3, reward, _, _ = one_frame(fd, deep, 0, escape=True, left_edge=True)
  assert float(reward) == 0.0 and int(s3.hooked_lane) == -1
  assert float(s3.hook_y) == f32(101.2)
  # The opponent's catch every 110 frames; at 99 the episode ends.
  state = one_env(fd, opp_score=96.0, frame=fd.OPP_CATCH_EVERY - 1)
  s2, reward, done, life_lost = one_frame(fd, state, 0, **_HOLD)
  assert float(reward) == -fd.OPP_VALUE and float(s2.opp_score) == 100.0
  assert bool(done) and not bool(life_lost)


def _derby_edges(s, rng):
  """Free hooks within ulps of the bite bands of a lane's fish (after the
  hook's and the fish's moves), fish near the left bank, hooked lines near
  the surface and the shark's band with the shark's mouth near the hook,
  the opponent's catch near 99."""
  n = s.hook_x.shape[0]
  lane = rng.randint(0, fd.NUM_LANES, n)
  ys = np.asarray([fd.lane_y(i) for i in range(fd.NUM_LANES)], f32)
  hook_y = ys[lane] + near(rng, [-6.0, 6.0, -4.0, 4.0, 0.0, -8.0, 8.0], n)
  hook_x = near(rng, [22.0, 40.0, 46.0, 70.0], n)
  fish_x = rng.uniform(10, 150, (n, fd.NUM_LANES)).astype(f32)
  # Near the left bank an ulp is small enough to show the lanes' speeds'
  # last bit (lane 5's fused 0.8 + 0.1 * 5 is 1.3000001, not 1.3).
  fish_x[:, 5] = rng.uniform(6, 8, n).astype(f32)
  fish_x[np.arange(n), lane] = hook_x + near(rng, [-8.0, 8.0, -10.0, 10.0,
                                                   -6.0, 6.0], n)
  hooked = rng.rand(n) < 0.4
  hook_y = np.where(hooked, near(rng, [88.0, 89.2, 90.0, 78.0, 80.5, 76.0],
                                 n), hook_y)
  shark_x = hook_x - 9.0 + near(rng, [-11.0, 11.0, 0.0, -13.0, 13.0], n)
  return s._replace(
      hook_x=jnp.asarray(hook_x), hook_y=jnp.asarray(hook_y.astype(f32)),
      hooked_lane=jnp.asarray(np.where(hooked, lane, -1), jnp.int32),
      fish_x=jnp.asarray(np.clip(fish_x, 6.0, 154.0).astype(f32)),
      shark_x=jnp.asarray(np.clip(shark_x, 10.0, 140.0).astype(f32)),
      shark_dir=jnp.asarray(rng.choice(np.asarray([-1.0, 1.0], f32), n)),
      my_score=jnp.asarray(rng.choice(np.asarray([0.0, 93.0, 97.0], f32), n)),
      opp_score=jnp.asarray(rng.choice(np.asarray([0.0, 95.0], f32), n)),
      frame=jnp.asarray(rng.choice([0, 109, 219, fd.EPISODE_FRAMES - 1], n),
                        jnp.int32))


# --- ms_pacman ----------------------------------------------------------------

_CALM = dict(score_u=[[[0.5] * 4] * mp.NUM_GHOSTS],
             pick_u=[[1.0] * mp.NUM_GHOSTS])  # no random pick


def test_ms_pacman_power_pellet_then_two_ghosts_pay_200_then_400():
  # The player steps left onto the power pellet at (15, 1), where ghost 0
  # waits: +50, and the ghost, frightened now, is eaten for 200. On the
  # next frame ghost 1 comes down from (14, 1), its only way on, into the
  # player: 400.
  gr = [15, 14] + [mp.GHOST_START[2][0], mp.GHOST_START[3][0]]
  gc = [1, 1] + [mp.GHOST_START[2][1], mp.GHOST_START[3][1]]
  state = one_env(mp, pr=15, pc=2, pdir=3, want=3, gr=gr, gc=gc,
                 gdir=[0, 2, 0, 0], frame=0)
  s2, reward, _, _ = one_frame(mp, state, 0, **_CALM)
  assert float(reward) == mp.POWER_POINTS + mp.GHOST_POINTS
  assert (int(s2.pr), int(s2.pc)) == (15, 1) and int(s2.fright) == 360
  assert int(s2.combo) == 1 and not bool(s2.power[0, 15, 1])
  assert (int(s2.gr[0, 0]), int(s2.gc[0, 0])) == mp.GHOST_START[0]
  s3, reward, done, life_lost = one_frame(mp, s2, 0, **_CALM)
  assert float(reward) == 2 * mp.GHOST_POINTS and int(s3.combo) == 2
  assert (int(s3.gr[0, 1]), int(s3.gc[0, 1])) == mp.GHOST_START[0]
  assert not bool(done) and not bool(life_lost)


def test_ms_pacman_tunnel_wraps_and_a_ghost_costs_a_life():
  state = one_env(mp, pr=9, pc=0, pdir=3, want=3, frame=0)
  s2, _, _, _ = one_frame(mp, state, 0, **_CALM)
  assert (int(s2.pr), int(s2.pc)) == (9, mp.COLS - 1)
  s3, _, _, _ = one_frame(mp, one_env(mp, pr=9, pc=mp.COLS - 1, pdir=1, want=1,
                                     frame=0), 0, **_CALM)
  assert (int(s3.pr), int(s3.pc)) == (9, 0)
  # A ghost that is not frightened on the player's cell: a life, and all
  # back to the start.
  gr = [15, 9, 9, 9]
  gc = [5] + [c for _, c in mp.GHOST_START[1:]]
  s4, _, done, life_lost = one_frame(mp, one_env(mp, pr=15, pc=5, gr=gr,
                                                 gc=gc, frame=2), 0, **_CALM)
  assert bool(life_lost) and not bool(done) and int(s4.lives) == 2
  assert (int(s4.pr), int(s4.pc)) == mp.PLAYER_START


def _pacman_edges(s, rng):
  """The player anywhere open, on the tunnel row near both ends half the
  time, the ghosts on open cells next to her (same cell, swaps, passes)
  or in the tunnel, fright 0, 1 or long with combos 0-5, frames at each
  move phase, and mazes down to their last pellets."""
  n = s.pr.shape[0]
  open_cells = np.argwhere(~np.asarray(
      [[ch == "W" for ch in row] for row in mp.MAZE]))
  cell = open_cells[rng.randint(0, len(open_cells), n)]
  tunnel = rng.rand(n) < 0.5
  cell[tunnel] = np.stack([np.full(int(tunnel.sum()), mp.TUNNEL_ROW),
                           rng.choice([0, 1, 17, 18], int(tunnel.sum()))], 1)
  pr, pc = cell[:, 0], cell[:, 1]
  near_cell = []
  for _ in range(mp.NUM_GHOSTS):
    dr = rng.randint(-1, 2, n)
    dc = np.where(dr == 0, rng.randint(-1, 2, n), 0)
    r, c = pr + dr, (pc + dc) % mp.COLS
    ok = ~np.asarray([[ch == "W" for ch in row] for row in mp.MAZE])[r, c]
    near_cell.append((np.where(ok, r, pr), np.where(ok, c, pc)))
  gr = np.stack([r for r, _ in near_cell], 1)
  gc = np.stack([c for _, c in near_cell], 1)
  pellet = np.asarray(s.pellet).copy()
  sparse = rng.rand(n) < 0.3
  pellet[sparse] = False
  pellet[sparse, pr[sparse], pc[sparse]] = True
  return s._replace(
      pr=jnp.asarray(pr, jnp.int32), pc=jnp.asarray(pc, jnp.int32),
      pdir=jnp.asarray(rng.randint(0, 5, n), jnp.int32),
      want=jnp.asarray(rng.randint(0, 5, n), jnp.int32),
      gr=jnp.asarray(gr, jnp.int32), gc=jnp.asarray(gc, jnp.int32),
      gdir=jnp.asarray(rng.randint(0, 4, (n, mp.NUM_GHOSTS)), jnp.int32),
      pellet=jnp.asarray(pellet),
      power=jnp.asarray(np.where(sparse[:, None, None], False,
                                 np.asarray(s.power))),
      fright=jnp.asarray(rng.choice([0, 0, 1, 2, 300], n), jnp.int32),
      combo=jnp.asarray(rng.randint(0, 6, n), jnp.int32),
      lives=jnp.asarray(rng.randint(1, 4, n), jnp.int32),
      frame=jnp.asarray(rng.randint(0, 12, n), jnp.int32))


# --- phoenix ------------------------------------------------------------------

_STILL = dict(flip_u=[1.0] * ph.NUM_BIRDS, dive_u=[1.0] * ph.NUM_BIRDS)


def test_phoenix_shot_kills_the_last_bird_hit():
  # Birds 4 and 5 (the lower rank) share a column under the shot: both
  # boxes are hit, bird 5 alone dies and pays its rank's 12.
  x = [20.0] * ph.NUM_BIRDS
  x[4] = x[5] = 60.0
  state = one_env(ph, bird_x=x, bird_dir=[1.0] * ph.NUM_BIRDS,
                  shot_x=62.0, shot_y=85.0, shot_live=True)
  s2, reward, _, _ = one_frame(ph, state, 0, **_STILL)
  assert float(reward) == ph.POINTS[1] and not bool(s2.shot_live)
  assert s2.bird_live[0].tolist() == [True] * 5 + [False, True, True]
  assert int(s2.bird_delay[0, 5]) == ph.RESPAWN_FRAMES
  # Alone in the upper rank, bird 1 pays 25.
  x[1], x[4], x[5] = 60.0, 20.0, 20.0
  state = state._replace(bird_x=torch.tensor([x]),
                         shot_y=torch.tensor([65.0]))
  _, reward, _, _ = one_frame(ph, state, 0, **_STILL)
  assert float(reward) == ph.POINTS[0]


def test_phoenix_shield_kills_a_diver_else_it_costs_a_life():
  diver = dict(bird_diving=[False] * 7 + [True], bird_x=[20.0] * 7 + [50.0],
               bird_y=[56.0] * 7 + [172.0], player_x=50.0)
  # DOWN raises the shield: the diver dies for a bonus, no life lost.
  state = one_env(ph, **diver)
  s2, reward, _, life_lost = one_frame(ph, state, 4, **_STILL)
  assert float(reward) == ph.DIVER_BONUS and not bool(life_lost)
  assert not bool(s2.bird_live[0, 7]) and int(s2.shield) == ph.SHIELD_FRAMES
  # Cooling down, the shield stays down: a crash.
  s3, reward, done, life_lost = one_frame(
      ph, state._replace(shield_cd=torch.tensor([5], dtype=torch.int32)), 4,
      **_STILL)
  assert bool(life_lost) and not bool(done) and float(reward) == 0.0
  assert int(s3.lives) == ph.LIVES - 1 and int(s3.hit_pause) == ph.HIT_PAUSE


def _phoenix_edges(s, rng):
  """Waves 0-40 (the weave's multiply-add), birds within 2 ulps of the
  walls after their weave, a shot within ulps of the boxes of several
  birds at once (the last one hit dies), divers within ulps of the ship's
  box, shields up, down and cooling."""
  n = s.wave.shape[0]
  wave = rng.randint(0, 41, n)
  speed = f32(0.25) * wave.astype(f32) + f32(1.0)
  dirs = np.where(rng.rand(n, ph.NUM_BIRDS) < 0.5, -1.0, 1.0).astype(f32)
  walls = np.where(dirs > 0, ph.RIGHT - ph.BIRD_W, ph.LEFT)
  bird_x = near(rng, [0.0, 2.0, 40.0, 70.0], n * ph.NUM_BIRDS).reshape(
      n, -1) + walls - dirs * speed[:, None]
  shared = rng.randint(0, 4, n)
  bird_x[np.arange(n), shared + 4] = bird_x[np.arange(n), shared]
  diving = rng.rand(n, ph.NUM_BIRDS) < 0.3
  rank_y = np.asarray(ph.RANK_Y, f32)
  player_x = near(rng, [30.0, 80.0, 140.0], n)
  bird_y = np.where(diving, near(rng, [164.0, 170.0, 184.0, 186.0, 197.0],
                                 n * ph.NUM_BIRDS).reshape(n, -1), rank_y)
  bird_x = np.where(diving, player_x[:, None] + near(
      rng, [-8.0, 10.0, 0.0, -10.0, 12.0], n * ph.NUM_BIRDS).reshape(n, -1),
      bird_x)
  shot_x = bird_x[np.arange(n), shared] + near(rng, [-2.0, 8.0, 3.0], n)
  shot_y = near(rng, [69.0, 75.0, 70.0, 82.0, 89.0], n)
  return s._replace(
      wave=jnp.asarray(wave, jnp.int32),
      bird_x=jnp.asarray(np.clip(bird_x, 0.0, 160.0).astype(f32)),
      bird_y=jnp.asarray(bird_y.astype(f32)), bird_dir=jnp.asarray(dirs),
      bird_diving=jnp.asarray(diving), player_x=jnp.asarray(player_x),
      bird_live=jnp.asarray(rng.rand(n, ph.NUM_BIRDS) < 0.9),
      shot_x=jnp.asarray(shot_x.astype(f32)), shot_y=jnp.asarray(shot_y),
      shot_live=jnp.asarray(rng.rand(n) < 0.8),
      shield=jnp.asarray(rng.choice([0, 1, 10], n), jnp.int32),
      shield_cd=jnp.asarray(rng.choice([0, 0, 5], n), jnp.int32),
      hit_pause=jnp.asarray(rng.choice([0, 0, 3], n), jnp.int32),
      lives=jnp.asarray(rng.randint(1, 6, n), jnp.int32))


@pytest.mark.parametrize("name,edit", [("fishing_derby", _derby_edges),
                                       ("ms_pacman", _pacman_edges),
                                       ("phoenix", _phoenix_edges)])
def test_step_on_hand_made_states_matches_jax(name, edit):
  _, reward, _ = step_sweep(name, edit, renders=128)
  assert bool((reward != 0).any())
