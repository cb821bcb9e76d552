"""The JAX package's draws for the port's games, and a step-for-step check of
the port's vector env against JAX's (CPU), for the test files of the games.

JAX splits a game's key at init and, for some games, on every raw frame;
`jax_env_draws` repeats those splits on the JAX state before a step and
hands the port exactly the values JAX is about to draw: the reset's noop
count, init and burn draws from the env key, the group's draws from the
game state's key. A game with `per_frame_draws` gets a leading frame axis
(30 for the burn, 4 for the group), the others one set that serves every
frame.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dqn_zoo_tpu.envs.api import get_game as jget_game
from dqn_zoo_tpu.envs.vector import VectorAtariEnv as JVectorEnv
from dqn_zoo_tpu.envs.vector import VectorEnvConfig as JEnvConfig
from dqn_zoo_torch import convert
from dqn_zoo_torch.envs.api import get_game
from dqn_zoo_torch.envs.games import asterix, atlantis, breakout, freeway
from dqn_zoo_torch.envs.games import seaquest, skiing, space_invaders
from dqn_zoo_torch.envs.games import assault, beam_rider, bowling, boxing
from dqn_zoo_torch.envs.games import crazy_climber, demon_attack
from dqn_zoo_torch.envs.games import enduro, fishing_derby, gopher
from dqn_zoo_torch.envs.games import ice_hockey, ms_pacman, phoenix
from dqn_zoo_torch.envs.games import qbert, star_gunner, tennis, zaxxon
from dqn_zoo_torch.envs.vector import EnvDraws, VectorAtariEnv
from dqn_zoo_torch.envs.vector import VectorEnvConfig

split = jax.random.split
uniform = jax.random.uniform


def _chain(key, frames, draw):
  """`draw(key) -> (key, draws)` of `frames` raw frames stepped from game
  key `key`, stacked on a leading frame axis (a scan: XLA compiles one
  frame's splits, not 34 frames' of them)."""
  return jax.lax.scan(lambda k, _: draw(k), key, None, length=frames)[1]


def _frames(key, frames, draw, parts=3):
  """`draw` of `frames` raw frames stepped from game key `key`, each frame
  splitting the key in `parts` and drawing from every part but the first,
  which the next frame splits."""
  def frame(k):
    k, *keys = split(k, parts)
    return k, draw(*keys)
  return _chain(key, frames, frame)


# Per game: init(k_init) -> (init draws, key after init) and
# step(key, frames) -> step draws of `frames` raw frames (None: one set).
def _breakout_init(k):
  key, k1 = split(k)
  return (uniform(k1, (), minval=8.0, maxval=152.0 - breakout.PADDLE_W),), key


def _breakout_step(key, frames):
  del frames  # one set a group: a serve advances the key, at most once
  _, k1, k2 = split(key, 3)
  return (jax.random.bernoulli(k1),
          uniform(k2, (), minval=12.0, maxval=148.0 - breakout.BALL))


def _invaders_init(k):
  key, k1 = split(k)
  return (uniform(k1, (), minval=space_invaders.LEFT_WALL,
                  maxval=space_invaders.RIGHT_WALL
                  - space_invaders.PLAYER_W),), key


def _invaders_step(key, frames):
  n = space_invaders.NUM_BOMBS
  return _frames(key, frames, lambda k1, k2: (
      jax.random.randint(k1, (n,), 0, space_invaders.COLS),
      uniform(k2, (n,))))


def _freeway_init(k):
  key, k1 = split(k)
  return (uniform(k1, (freeway.NUM_LANES,), minval=0.0, maxval=160.0),), key


def _asterix_init(k):
  key, kx, kl = split(k, 3)
  n = asterix.NUM_LANES
  return (uniform(kx, (n,), minval=asterix.LEFT_WALL,
                  maxval=asterix.RIGHT_WALL - asterix.OBJ_W),
          uniform(kl, (n,))), key


def _asterix_step(key, frames):
  n = asterix.NUM_LANES
  return _frames(key, frames, lambda k1, k2: (uniform(k1, (n,)),
                                              uniform(k2, (n,))))


def _atlantis_init(k):
  key, kd = split(k)
  return (jax.random.bernoulli(kd, 0.5, (atlantis.NUM_BANDS,)),), key


def _atlantis_step(key, frames):
  n = atlantis.NUM_BANDS
  return _frames(key, frames, lambda k1, k2: (
      uniform(k1, (n,)), jax.random.bernoulli(k2, 0.5, (n,))))


def _skiing_init(k):
  key, kg = split(k)
  return (uniform(kg, (skiing.NUM_GATES,), minval=skiing.SKIER_X_MIN + 20.0,
                  maxval=skiing.SKIER_X_MAX - 20.0),), key


def _seaquest_init(k):
  key, k_e, k_d = split(k, 3)
  n = seaquest.NUM_LANES
  return (uniform(k_e, (n,), minval=8.0, maxval=140.0),
          uniform(k_d, (n,))), key


def _seaquest_step(key, frames):
  return _frames(key, frames,
                 lambda k1, k2: (uniform(k1, (seaquest.NUM_LANES,)),))


def _no_init(k):
  # The game's init draws nothing (its init draws carry only the batch)
  # and keeps the key it is given.
  return (jnp.zeros((), jnp.int32),), k


def _boxing_init(k):
  key, k1, k2 = split(k, 3)
  return (uniform(k1, (2,), minval=-16.0, maxval=16.0),
          jax.random.randint(k2, (), 0, boxing.COOLDOWN)), key


def _boxing_step(key, frames):
  return _frames(key, frames, lambda k1: (
      jax.random.bernoulli(k1, boxing.FEINT_PROB),), parts=2)


def _beam_rider_init(k):
  key, k1 = split(k)
  return (jax.random.randint(k1, (), 0, beam_rider.BEAMS),), key


def _beam_rider_step(key, frames):
  n = beam_rider.NUM_SAUCERS
  return _frames(key, frames, lambda k1, k2: (
      uniform(k1, (n,)), jax.random.randint(k2, (n,), 0, beam_rider.BEAMS)))


def _assault_init(k):
  key, k1, k2 = split(k, 3)
  return (uniform(k1, (), minval=assault.LEFT,
                  maxval=assault.RIGHT - assault.PLAYER_W),
          jax.random.bernoulli(k2)), key


def _assault_step(key, frames):
  n = assault.NUM_DRONES
  return _frames(key, frames, lambda k1, k2: (uniform(k1, (n,)),
                                              uniform(k2, (n,))))


def _climber_init(k):
  key, k1, k2 = split(k, 3)
  cc = crazy_climber
  return (jax.random.randint(k1, (), 0, cc.COLS),
          jax.random.randint(k2, (cc.COLS,), 0, cc.SHUT_PERIOD)), key


def _climber_step(key, frames):
  cc = crazy_climber
  n = cc.NUM_POTS
  return _frames(key, frames, lambda k1, k2, k3: (
      uniform(k1, (n,)), jax.random.randint(k2, (n,), 0, cc.COLS),
      uniform(k3, (n,))), parts=4)


def _demon_init(k):
  key, k1, k2, k3 = split(k, 4)
  da = demon_attack
  n = da.NUM_DEMONS
  return (uniform(k1, (), minval=da.LEFT, maxval=da.RIGHT - da.PLAYER_W),
          uniform(k2, (n,), minval=da.LEFT, maxval=da.RIGHT - da.DEMON_W),
          jax.random.bernoulli(k3, shape=(n,))), key


def _demon_step(key, frames):
  da = demon_attack
  n = da.NUM_DEMONS
  return _frames(key, frames, lambda k1, k2, k3: (
      uniform(k1, (n,)),
      uniform(k2, (n,), minval=da.LEFT, maxval=da.RIGHT - da.DEMON_W),
      uniform(k3, (n,))), parts=4)


def _phoenix_init(k):
  key, k1, k2, k3 = split(k, 4)
  ph = phoenix
  n = ph.NUM_BIRDS
  return (uniform(k1, (), minval=ph.LEFT, maxval=ph.RIGHT - ph.PLAYER_W),
          uniform(k2, (n,), minval=ph.LEFT, maxval=ph.RIGHT - ph.BIRD_W),
          jax.random.bernoulli(k3, shape=(n,))), key


def _phoenix_step(key, frames):
  ph = phoenix
  n = ph.NUM_BIRDS
  return _frames(key, frames, lambda k1, k2, k3: (
      uniform(k1, (n,)), uniform(k2, (n,)),
      uniform(k3, (n,), minval=ph.LEFT, maxval=ph.RIGHT - ph.BIRD_W)),
                 parts=4)


def _gopher_step(key, frames):
  # The step splits three ways and reads one coin, for both restarts.
  return _frames(key, frames, lambda k_move, k_pop: (
      jax.random.bernoulli(k_move),))


def _enduro_init(k):
  key, k1 = split(k)
  kz, kl = split(k1)
  n = enduro.NUM_CARS
  return (uniform(kz, (n,), minval=enduro.SPAWN_AHEAD * 0.5,
                  maxval=enduro.SPAWN_AHEAD),
          jax.random.randint(kl, (n,), 0, enduro.NUM_LANES)), key


def _enduro_step(key, frames):
  n = enduro.NUM_CARS
  return _frames(key, frames, lambda k1, k2: (
      uniform(k1, (n,), minval=enduro.SPAWN_AHEAD * 0.6,
              maxval=enduro.SPAWN_AHEAD),
      jax.random.randint(k2, (n,), 0, enduro.NUM_LANES)))


def _hockey_init(k):
  key, k1 = split(k)
  return (uniform(k1, (), minval=100.0, maxval=120.0),), key


def _hockey_step(key, frames):
  ih = ice_hockey
  return _frames(key, frames, lambda k_aim, k_shoot: (
      uniform(k_aim, (), minval=ih.AIM_LOW, maxval=ih.AIM_HIGH),
      uniform(k_shoot, ())))


def _derby_init(k):
  key, kf, kd = split(k, 3)
  n = fishing_derby.NUM_LANES
  return (uniform(kf, (n,), minval=10.0, maxval=150.0),
          jax.random.bernoulli(kd, shape=(n,))), key


def _derby_frame(key):
  # Two splits in a row: the escape test, then the respawn edge.
  key, k_esc = split(key)
  key, kr = split(key)
  return key, (jax.random.bernoulli(k_esc, fishing_derby.ESCAPE_PROB),
               jax.random.bernoulli(kr))


def _derby_step(key, frames):
  # Two splits in a row a frame.
  return _chain(key, frames, _derby_frame)


def _pacman_step(key, frames):
  # One (4, 4) draw serves as the noise (u * 0.5) and as the random scores
  # (u * 10).
  g = ms_pacman.NUM_GHOSTS
  return _frames(key, frames, lambda k1, k2: (
      uniform(k1, (g, 4)), uniform(k2, (g, 1))[:, 0]))


def _tennis_step(key, frames):
  # A serve's x speed is drawn every frame, used on a serve only.
  return _frames(key, frames, lambda k_serve, k_miss: (
      uniform(k_serve, (), minval=-2.0, maxval=2.0),
      jax.random.bernoulli(k_miss, tennis.FUMBLE_PROB)))


def _star_gunner_init(k):
  key, k1, k2 = split(k, 3)
  sg = star_gunner
  return (uniform(k1, (), minval=sg.TOP + 20, maxval=sg.BOTTOM - 30),
          uniform(k2, (sg.NUM_RAIDERS,), minval=sg.TOP,
                  maxval=sg.BOTTOM - sg.RAIDER_H)), key


def _star_gunner_step(key, frames):
  sg = star_gunner
  n = sg.NUM_RAIDERS
  return _frames(key, frames, lambda k_jink, k_spawn_y, k_bolt: (
      uniform(k_jink, (n,), minval=-0.8, maxval=0.8),
      uniform(k_spawn_y, (n,), minval=sg.TOP,
              maxval=sg.BOTTOM - sg.RAIDER_H),
      uniform(k_bolt, (n,))), parts=4)


def _qbert_step(key, frames):
  # The ball's second coin comes from fold_in(k_ball, 1), not a split.
  def draw(k_ball, k_coily):
    return (jax.random.bernoulli(k_ball),
            jax.random.bernoulli(jax.random.fold_in(k_ball, 1)),
            uniform(k_coily, (4,), maxval=0.3))
  return _frames(key, frames, draw)


def _zaxxon_enemy(k):
  # _spawn_enemy's split: the x offset, the y (drawn for a turret too,
  # which does not use it) and the turret coin.
  kx, ky, kt = split(k, 3)
  za = zaxxon
  return (uniform(kx, (), maxval=140.0),
          uniform(ky, (), minval=za.Y_MIN, maxval=za.Y_MAX - 30),
          jax.random.bernoulli(kt, 0.4))


def _zaxxon_gap(k):
  za = zaxxon
  return uniform(k, (), minval=za.Y_MIN + za.GAP_H / 2,
                 maxval=za.Y_MAX - za.GAP_H / 2)


def _zaxxon_init(k):
  key, kw, *keys = split(k, 2 + zaxxon.NUM_ENEMIES)
  dx, y, turret = jax.vmap(_zaxxon_enemy)(jnp.stack(keys))
  return (dx, y, turret, _zaxxon_gap(kw)), key


def _zaxxon_step(key, frames):
  # One key per enemy from k_re, each split again inside _spawn_enemy.
  def draw(k_re, k_gap):
    dx, y, turret = jax.vmap(_zaxxon_enemy)(split(k_re, zaxxon.NUM_ENEMIES))
    return dx, y, turret, _zaxxon_gap(k_gap)
  return _frames(key, frames, draw)


# name: (init, step or None, init draws class, step draws class or None)
GAMES = {
    "seaquest": (_seaquest_init, _seaquest_step, seaquest.SeaquestInitDraws,
                 seaquest.SeaquestStepDraws),
    "breakout": (_breakout_init, _breakout_step, breakout.BreakoutInitDraws,
                 breakout.BreakoutStepDraws),
    "space_invaders": (_invaders_init, _invaders_step,
                       space_invaders.SpaceInvadersInitDraws,
                       space_invaders.SpaceInvadersStepDraws),
    "freeway": (_freeway_init, None, freeway.FreewayInitDraws, None),
    "asterix": (_asterix_init, _asterix_step, asterix.AsterixInitDraws,
                asterix.AsterixStepDraws),
    "atlantis": (_atlantis_init, _atlantis_step, atlantis.AtlantisInitDraws,
                 atlantis.AtlantisStepDraws),
    "skiing": (_skiing_init, None, skiing.SkiingInitDraws, None),
    "bowling": (_no_init, None, bowling.BowlingInitDraws, None),
    "boxing": (_boxing_init, _boxing_step, boxing.BoxingInitDraws,
               boxing.BoxingStepDraws),
    "beam_rider": (_beam_rider_init, _beam_rider_step,
                   beam_rider.BeamRiderInitDraws,
                   beam_rider.BeamRiderStepDraws),
    "assault": (_assault_init, _assault_step, assault.AssaultInitDraws,
                assault.AssaultStepDraws),
    "crazy_climber": (_climber_init, _climber_step,
                      crazy_climber.CrazyClimberInitDraws,
                      crazy_climber.CrazyClimberStepDraws),
    "demon_attack": (_demon_init, _demon_step,
                     demon_attack.DemonAttackInitDraws,
                     demon_attack.DemonAttackStepDraws),
    "phoenix": (_phoenix_init, _phoenix_step, phoenix.PhoenixInitDraws,
                phoenix.PhoenixStepDraws),
    "gopher": (_no_init, _gopher_step, gopher.GopherInitDraws,
               gopher.GopherStepDraws),
    "enduro": (_enduro_init, _enduro_step, enduro.EnduroInitDraws,
               enduro.EnduroStepDraws),
    "ice_hockey": (_hockey_init, _hockey_step,
                   ice_hockey.IceHockeyInitDraws,
                   ice_hockey.IceHockeyStepDraws),
    "fishing_derby": (_derby_init, _derby_step,
                      fishing_derby.FishingDerbyInitDraws,
                      fishing_derby.FishingDerbyStepDraws),
    "ms_pacman": (_no_init, _pacman_step, ms_pacman.MsPacmanInitDraws,
                  ms_pacman.MsPacmanStepDraws),
    "tennis": (_no_init, _tennis_step, tennis.TennisInitDraws,
               tennis.TennisStepDraws),
    "star_gunner": (_star_gunner_init, _star_gunner_step,
                    star_gunner.StarGunnerInitDraws,
                    star_gunner.StarGunnerStepDraws),
    "qbert": (_no_init, _qbert_step, qbert.QbertInitDraws,
              qbert.QbertStepDraws),
    "zaxxon": (_zaxxon_init, _zaxxon_step, zaxxon.ZaxxonInitDraws,
               zaxxon.ZaxxonStepDraws),
}


def _one_env(name, env_key, game_key, max_noops, repeat):
  init, step, _, _ = GAMES[name]
  _, k_init, k_noops = split(env_key, 3)
  noops = jax.random.randint(k_noops, (), 1, max_noops + 1)
  init_draws, key = init(k_init)
  if step is None:
    return noops, init_draws, (), ()
  return noops, init_draws, step(key, max_noops), step(game_key, repeat)


@functools.partial(jax.jit, static_argnums=(0, 3, 4))
def _draws_jit(name, env_keys, game_keys, max_noops, repeat):
  return jax.vmap(lambda a, b: _one_env(name, a, b, max_noops, repeat))(
      env_keys, game_keys)


def jax_env_draws(name, env_state, max_noops=30, repeat=4) -> EnvDraws:
  """The draws JAX's vector env makes in its next step, as the port's
  VectorAtariEnv.draws lays them out."""
  _, _, init_cls, step_cls = GAMES[name]
  t = lambda x: torch.from_numpy(np.array(x))
  noops, init, burn, step = _draws_jit(name, env_state.rng,
                                       env_state.game_state.key, max_noops,
                                       repeat)
  if step_cls is None:
    burn = step = None
  elif get_game(name).per_frame_draws:  # (B, frames, ...) -> (frames, B, ...)
    burn = step_cls(*(t(x).transpose(0, 1) for x in burn))
    step = step_cls(*(t(x).transpose(0, 1) for x in step))
  else:
    burn, step = step_cls(*map(t, burn)), step_cls(*map(t, step))
  return EnvDraws(noops=t(noops), init=init_cls(*map(t, init)), burn=burn,
                  step=step)


@functools.lru_cache(maxsize=None)
def _jax_env(name, b, cap):
  """JAX's vector env of `name` at B=b (and its episode frame cap, None
  for the default) and its jitted step, compiled once for the tests of a
  process that share them."""
  cfg = {} if cap is None else dict(episode_frame_cap=cap)
  jenv = JVectorEnv(jget_game(name), b, JEnvConfig(**cfg))
  return jenv, jax.jit(jenv.step)


def run_against_jax(name, b, groups, policy, cap=None, seed=3, prepare=None,
                    on_step=None):
  """Steps JAX's vector env and the port's side by side for `groups`
  groups from one JAX state carried across by convert, with the port given
  JAX's draws and `policy(step, port state) -> (B,) int actions`; requires
  every output and every state field exact, frames included (tolerance:
  none). `prepare(JAX game state) -> game state` edits the states the first
  group's resets made (to bring an episode's end within reach), and both
  sides go on from the edited one. `on_step(port state before, port state
  after, output)` sees each group. Returns the FIRST groups emitted."""
  cfg = {} if cap is None else dict(episode_frame_cap=cap)
  jenv, jstep = _jax_env(name, b, cap)
  jstate = jenv.init(jax.random.PRNGKey(seed))
  game = get_game(name)
  tenv = VectorAtariEnv(game, b, VectorEnvConfig(**cfg), "cpu")
  eng = type("E", (), {"game": game})
  tstate = convert.env_state_from_jax(eng, jax.device_get(jstate), "cpu")
  firsts = 0
  for step in range(groups):
    actions = np.asarray(policy(step, tstate), np.int32)
    draws = jax_env_draws(name, jax.device_get(jstate))
    jstate, jout = jstep(jstate, jnp.asarray(actions))
    before = tstate
    tstate, tout = tenv.step(tstate, torch.from_numpy(actions).long(), draws)
    for field, a, w in zip(jout._fields, tout, jout):
      np.testing.assert_array_equal(a.numpy(), np.asarray(w),
                                    err_msg=f"{name}: {field} at {step}")
    ref = convert.env_state_from_jax(eng, jax.device_get(jstate), "cpu")
    for field, a, w in zip(ref.game_state._fields, tstate.game_state,
                           ref.game_state):
      assert a.dtype == w.dtype and torch.equal(a, w), (name, field, step)
    assert torch.equal(tstate.episode_frames, ref.episode_frames)
    assert torch.equal(tstate.needs_reset, ref.needs_reset)
    firsts += int(tout.is_first.sum())
    if on_step is not None:
      on_step(before, tstate, tout)
    if step == 0 and prepare is not None:
      jstate = jstate._replace(game_state=prepare(jstate.game_state))
      tstate = convert.env_state_from_jax(eng, jax.device_get(jstate), "cpu")
  return firsts


def random_policy(name, b, seed=0):
  """Uniform actions from a seeded numpy stream."""
  rng = np.random.RandomState(seed)
  n = get_game(name).num_actions
  return lambda step, state: rng.randint(0, n, b)


def life_losses_zero_discount(name, b, steps, seed, policy=None):
  """Rolls the port's vector env for `steps` groups (random actions unless
  `policy` is given) and checks tests/test_envs.py's rule: a life lost
  mid-episode zeroes the group's discount. Returns the life losses seen."""
  env = VectorAtariEnv(get_game(name), b, device="cpu")
  gen = torch.Generator().manual_seed(seed)
  state = env.init(gen)
  policy = policy or random_policy(name, b, seed)
  lives, disc, firsts = [], [], []
  for step in range(steps):
    a = torch.from_numpy(np.asarray(policy(step, state))).long()
    state, out = env.step(state, a, env.draws(gen))
    lives.append(out.lives.numpy())
    disc.append(out.discount_prod.numpy())
    firsts.append(out.is_first.numpy())
  lives, disc, firsts = map(np.stack, (lives, disc, firsts))
  found = 0
  for e in range(b):
    for t in range(1, steps):
      if firsts[t, e] or firsts[t - 1, e]:
        continue
      if lives[t, e] < lives[t - 1, e] and lives[t, e] > 0:
        assert disc[t, e] == 0.0, (name, t, e)
        found += 1
  return found


def near(rng, edges, n, ulps=2):
  """n f32 values within `ulps` ulps of values drawn from `edges`."""
  x = np.asarray(edges, np.float32)[rng.randint(0, len(edges), n)]
  for _ in range(ulps):
    step = rng.randint(-1, 2, n)
    x = np.where(step > 0, np.nextafter(x, np.float32(np.inf)),
                 np.where(step < 0, np.nextafter(x, np.float32(-np.inf)), x))
  return x.astype(np.float32)


def _one_frame_draws(name, keys):
  """The port's draws of one raw frame of `name` for JAX game states with
  these keys (None for a game whose step draws nothing)."""
  _, step, _, step_cls = GAMES[name]
  if step_cls is None:
    return None
  d = jax.jit(jax.vmap(lambda k: step(k, 1)))(keys)
  t = lambda x: torch.from_numpy(np.array(x))
  per_frame = get_game(name).per_frame_draws
  return step_cls(*((t(x)[:, 0] if per_frame else t(x)) for x in d))


def _step_both(name, cls, jstates, tstates, actions, renders):
  """One raw frame of JAX's step (vmapped and jitted, as the vector env
  compiles it) and of the port's from the same states, JAX's draws handed
  to the port: the reward, done, life-loss and every state field exact;
  then the first `renders` frames of the new states, exact."""
  jgame, game = jget_game(name), get_game(name)
  jnew, jr, jd, jl = jax.jit(jax.vmap(jgame.step))(jstates,
                                                   jnp.asarray(actions))
  tnew, tr, td, tl = game.step(tstates, torch.from_numpy(actions).long(),
                               _one_frame_draws(name, jstates.key))
  for what, a, w in (("reward", tr, jr), ("done", td, jd),
                     ("life_lost", tl, jl)):
    np.testing.assert_array_equal(a.numpy(), np.asarray(w),
                                  err_msg=f"{name}: {what}")
  ref = convert.namedtuple_from_jax(cls, jax.device_get(jnew), "cpu")
  for field, a, w in zip(cls._fields, tnew, ref):
    assert a.dtype == w.dtype and torch.equal(a, w), (name, field)
  head = jax.tree.map(lambda x: x[:renders], jnew)
  np.testing.assert_array_equal(
      game.render(type(tnew)(*(x[:renders] for x in tnew))).numpy(),
      np.asarray(jax.jit(jax.vmap(jgame.render))(head)),
      err_msg=f"{name}: render")
  return tnew, tr, td


def step_sweep(name, edit, n=1024, renders=32, seed=0):
  """One raw frame of the game's step function on n states that `edit(JAX
  states, numpy rng)` sets near the edges of its tests, JAX's against the
  port's (`_step_both`)."""
  jgame, game = jget_game(name), get_game(name)
  rng = np.random.RandomState(seed)
  jstates = jax.vmap(jgame.init)(jax.random.split(jax.random.PRNGKey(seed),
                                                   n))
  jstates = edit(jstates, rng)
  actions = rng.randint(0, game.num_actions, n).astype(np.int32)
  cls = type(game.init(game.init_draws(torch.Generator(), 1, "cpu")))
  tstates = convert.namedtuple_from_jax(cls, jax.device_get(jstates), "cpu")
  return _step_both(name, cls, jstates, tstates, actions, renders)


def render_sweep(name, edit, n=256, seed=0):
  """The render of n states that `edit(JAX states, numpy rng)` sets (the
  port's from them by convert), JAX's (vmapped and jitted) against the
  port's, exact."""
  jgame, game = jget_game(name), get_game(name)
  rng = np.random.RandomState(seed)
  jstates = edit(jax.vmap(jgame.init)(jax.random.split(
      jax.random.PRNGKey(seed), n)), rng)
  cls = type(game.init(game.init_draws(torch.Generator(), 1, "cpu")))
  tstates = convert.namedtuple_from_jax(cls, jax.device_get(jstates), "cpu")
  np.testing.assert_array_equal(
      game.render(tstates).numpy(),
      np.asarray(jax.jit(jax.vmap(jgame.render))(jstates)),
      err_msg=f"{name}: render")


def converted_mid_episode(name, b=16, groups=40, seed=7):
  """JAX's vector env after `groups` groups of random play, converted by
  convert.env_state_from_jax (the JAX key dropped): the converted game
  states render as JAX's do, and one raw frame of the step from them, JAX's
  draws given, is JAX's (`_step_both`), frames, rewards and every state
  field exact. Returns the JAX vector env state."""
  jgame, game = jget_game(name), get_game(name)
  jenv, jstep = _jax_env(name, b, None)
  jstate = jenv.init(jax.random.PRNGKey(seed))
  rng = np.random.RandomState(seed)
  for _ in range(groups):
    jstate, _ = jstep(jstate, jnp.asarray(
        rng.randint(0, game.num_actions, b), jnp.int32))
  jstate = jax.device_get(jstate)
  eng = type("E", (), {"game": game})
  tstate = convert.env_state_from_jax(eng, jstate, "cpu")
  np.testing.assert_array_equal(
      game.render(tstate.game_state).numpy(),
      np.asarray(jax.jit(jax.vmap(jgame.render))(jstate.game_state)),
      err_msg=f"{name}: render of the converted state")
  actions = rng.randint(0, game.num_actions, b).astype(np.int32)
  _step_both(name, type(tstate.game_state), jstate.game_state,
             tstate.game_state, actions, b)
  return jstate


def one_env(module, seed=0, **fields):
  """A fresh state of the game in `module` at B=1 from a seeded generator,
  with the given fields set (numbers or lists, one env's values)."""
  game = module.GAME
  state = game.init(game.init_draws(torch.Generator().manual_seed(seed), 1,
                                    "cpu"))
  return state._replace(**{
      k: torch.tensor(v, dtype=getattr(state, k).dtype).reshape(
          getattr(state, k).shape) for k, v in fields.items()})


def one_frame(module, state, action, seed=1, **draws):
  """One raw frame of the game in `module` at B=1: its step draws from a
  seeded generator (one frame's), the given fields replaced."""
  game = module.GAME
  gen = torch.Generator().manual_seed(seed)
  if game.per_frame_draws:
    d = game.step_draws(gen, 1, "cpu", 1)
    d = type(d)(*(x[0] for x in d))
  else:
    d = game.step_draws(gen, 1, "cpu")
  if draws:
    d = d._replace(**{
        k: torch.tensor(v, dtype=getattr(d, k).dtype).reshape(
            getattr(d, k).shape) for k, v in draws.items()})
  return game.step(state, torch.tensor([action]), d)
