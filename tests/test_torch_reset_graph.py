"""The vector env's reset branch as one CUDA graph (dqn_zoo_torch/envs/
vector.py): on the card, bit for bit the eager branch for every game, one
capture a process for each shape, and no read of the device but the counted
`sync.reset`; on the CPU, the eager branch, and the constant cache of
envs/api.py that keeps copies from the host out of the graph.

The card tests are marked `cuda` and skip without a card. On a machine with
one (and without JAX, which tests/conftest.py imports), run them with
  python -m pytest --noconftest -m cuda tests/test_torch_reset_graph.py -q
"""

import pytest
import torch

from dqn_zoo_torch.envs import api, vector
from dqn_zoo_torch.envs.vector import VectorAtariEnv
from dqn_zoo_torch.run.train import build_engine
from dqn_zoo_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GAMES = ("assault", "asterix", "atlantis", "beam_rider", "bowling", "boxing",
         "breakout", "catch", "crazy_climber", "demon_attack", "enduro",
         "fishing_derby", "freeway", "gopher", "ice_hockey", "ms_pacman",
         "phoenix", "pong", "qbert", "seaquest", "skiing", "space_invaders",
         "star_gunner", "tennis", "zaxxon")


@pytest.fixture(autouse=True)
def _graphs_and_recorder_empty(monkeypatch):
  """Each test starts with no graph captured and the recorder drained."""
  monkeypatch.setattr(vector, "_RESET_GRAPHS", {})
  profiling.drain()
  yield
  assert not profiling.RECORDER.on
  profiling.drain()


def _gen(device, seed):
  g = torch.Generator(device=device)
  g.manual_seed(seed)
  return g


def _flat(outputs):
  """The reset branch's outputs (game state, frame, lives) as a list."""
  gs, frame, lives = outputs
  return [*gs, frame, lives]


def _equal(got, want):
  assert len(got) == len(want)
  for i, (g, w) in enumerate(zip(got, want)):
    assert g.dtype == w.dtype and g.shape == w.shape, i
    assert torch.equal(g, w), i


# --- on the CPU ---------------------------------------------------------------


@pytest.mark.parametrize("values,dtype", [
    ((5, 35, 65), torch.int32),
    (((1.5, -2.0), (3.0, 0.1)), torch.float32),
    (((0, 0, 0), (255, 128, 7)), torch.uint8),
    (((True, False, True),), torch.bool),
], ids=["int32", "float32", "uint8", "bool"])
def test_a_constant_is_the_tensor_of_its_values_made_once(values, dtype):
  got = api.constant(values, dtype, "cpu")
  want = torch.tensor(values, dtype=dtype, device="cpu")
  assert got.dtype == want.dtype and torch.equal(got, want)
  assert api.constant(values, dtype, "cpu") is got
  assert api.constant(values, torch.float64, "cpu") is not got


def test_the_cpu_keeps_the_eager_reset_branch():
  """A reset superstep on the CPU counts the branch and no graph, and its
  new episodes' frame and lives are those of the eager burn's states."""
  env = VectorAtariEnv(api.get_game("pong"), 4, device="cpu")
  gen = _gen("cpu", 0)
  state = env.init(gen)  # every env needs a reset
  draws = env.draws(gen)
  with profiling.recording():
    new, out = env.step(state, torch.zeros(4, dtype=torch.int64), draws)
  counters = profiling.drain().counters
  assert counters["env.reset_branch"] == 1
  assert "env.reset_graph" not in counters
  assert "env.reset_graph_capture" not in counters
  assert vector._RESET_GRAPHS == {}
  gs, frame, lives = env._reset_all(draws)
  _equal(list(new.game_state), list(gs))
  assert torch.equal(out.frame_last, frame)
  assert torch.equal(out.frame_last, env.game.render(gs))
  assert torch.equal(out.lives, lives)
  assert bool(out.is_first.all()) and not bool(out.frame_penult.any())


# --- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  from dqn_zoo_torch.device import set_numerics
  set_numerics()
  return torch.device("cuda")


def _replays_match(env, gen, replays=3, draws_of=None):
  """`replays` reset branches by the graph against the eager branch, each
  on fresh draws; returns the counters."""
  draws_of = draws_of or env.draws
  with profiling.recording():
    for _ in range(replays):
      draws = draws_of(gen)
      got = _flat(env._reset(draws))
      _equal(got, _flat(env._reset_all(draws)))
  return profiling.drain().counters


@pytest.mark.cuda
@pytest.mark.parametrize("name", GAMES)
def test_the_graphed_reset_branch_is_the_eager_one_bit_for_bit(card, name):
  env = VectorAtariEnv(api.get_game(name), 4, device=card)
  counters = _replays_match(env, _gen(card, 11))
  assert counters["env.reset_graph_capture"] == 1
  assert counters["env.reset_graph"] == 3


@pytest.mark.cuda
def test_seaquest_replays_read_every_frame_of_the_burn_draws(card):
  """seaquest draws for each raw frame: the burn's draws have a frame axis
  of max_noops, and with every env burning all 30 frames each replay reads
  every slice of them."""
  env = VectorAtariEnv(api.get_game("seaquest"), 32, device=card)
  gen = _gen(card, 12)
  assert all(x.shape[0] == env.config.max_noops
             for x in env.draws(gen).burn)

  half = torch.arange(32, device=card) % 2 == 0

  def all_frames(g):
    d = env.draws(g)
    return d._replace(noops=torch.where(half, env.config.max_noops, d.noops))

  counters = _replays_match(env, gen, draws_of=all_frames)
  assert counters["env.reset_graph"] == 3


@pytest.mark.cuda
def test_pong_steps_at_128_streams_equal_the_eager_steps(card, monkeypatch):
  """Whole steps at B = 128 with a part of the envs resetting: outputs and
  new states of the graphed env equal those of the eager one."""
  env = VectorAtariEnv(api.get_game("pong"), 128, device=card)
  eager = VectorAtariEnv(api.get_game("pong"), 128, device=card)
  monkeypatch.setattr(eager, "_reset", eager._reset_all)
  gen = _gen(card, 13)
  state = env.init(gen)
  for k in range(4):
    draws = env.draws(gen)
    actions = torch.randint(0, env.num_actions, (128,), generator=gen,
                            device=card)
    if k:  # the first step resets every env; later ones every third
      needs = torch.arange(128, device=card) % 3 == k % 3
      state = state._replace(needs_reset=needs)
    new, out = env.step(state, actions, draws)
    new_e, out_e = eager.step(state, actions, draws)
    _equal(list(out), list(out_e))
    _equal(list(new.game_state) + [new.episode_frames, new.needs_reset],
           list(new_e.game_state) + [new_e.episode_frames,
                                     new_e.needs_reset])
    state = new
  assert len(vector._RESET_GRAPHS) == 1


@pytest.mark.cuda
def test_eval_supersteps_capture_once_across_their_new_envs(card):
  """`Engine.eval_superstep` builds a new env each call; the reset branch's
  graph is captured once and replayed by every later call."""
  eng = build_engine("iqn", "pong", 4, 160, 0, "throughput",
                     num_iterations=1, num_train_frames=10_000,
                     spec_overrides=dict(tau_samples_policy=8,
                                         tau_samples_s_tm1=8,
                                         tau_samples_s_t=8), device=card)
  params = eng.init(0).online_params
  estate = eng.eval_init(1, num_envs=4)
  with profiling.recording():
    for _ in range(5):
      estate = eng.eval_superstep(params, estate._replace(
          env=estate.env._replace(
              needs_reset=torch.ones_like(estate.env.needs_reset))))
  counters = profiling.drain().counters
  assert counters["env.reset_branch"] == 5
  assert counters["env.reset_graph"] == 5
  assert counters["env.reset_graph_capture"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", GAMES)
def test_a_reset_step_reads_the_device_only_through_its_counted_read(
    card, name, monkeypatch):
  """Under CUDA's sync debug mode set to raise, a reset step (after the
  step that captured its graph) of every game waits for the device only in
  `profiling.host_read`, which lifts the mode around its read."""
  env = VectorAtariEnv(api.get_game(name), 4, device=card)
  gen = _gen(card, 14)
  actions = torch.zeros(4, dtype=torch.int64, device=card)
  state, _ = env.step(env.init(gen), actions, env.draws(gen))  # captures
  state = state._replace(needs_reset=torch.ones_like(state.needs_reset))
  read = profiling.host_read

  def lifted(tensor, name):
    torch.cuda.set_sync_debug_mode(0)
    try:
      return read(tensor, name)
    finally:
      torch.cuda.set_sync_debug_mode("error")

  monkeypatch.setattr(profiling, "host_read", lifted)
  torch.cuda.synchronize()
  torch.cuda.set_sync_debug_mode("error")
  try:
    with profiling.recording():
      env.step(state, actions, env.draws(gen))
  finally:
    torch.cuda.set_sync_debug_mode(0)
  counters = profiling.drain().counters
  assert counters["host_syncs"] == 1
  assert counters["env.reset_graph"] == 1
  assert "env.reset_graph_capture" not in counters
