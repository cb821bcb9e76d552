"""The port's CLI flags against the JAX CLI's (CPU): a reference command line
parses in `dqn_zoo_torch.run.train` and maps to the same AgentSpec
overrides as `dqn_zoo_tpu.run.train._spec_overrides_from_flags`."""

import pytest
from absl import flags
from absl.testing import flagsaver

from dqn_zoo_tpu.run import train as jtrain
from dqn_zoo_torch.run import train as ttrain
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

_CASES = [
    # A reference iqn command line: the five iqn flags.
    dict(huber_param=2.0, tau_latent_dim=32, tau_samples_policy=16,
         tau_samples_s_tm1=8, tau_samples_s_t=8),
    # The dqn-family flags beside them, and the accepted dtype/stack values.
    dict(learning_rate=5e-5, grad_error_bound=0.05, n_steps=3,
         target_network_update_period=1000, exploration_epsilon_end_value=0.01,
         compute_dtype="float32", num_action_repeats=4, num_stacked_frames=4),
    # Nothing set: no overrides at all.
    dict(),
    # A reference prioritized command line.
    dict(priority_exponent=0.5, importance_sampling_exponent_begin_value=0.5,
         importance_sampling_exponent_end_value=0.9,
         uniform_sample_probability=0.01, normalize_weights=False),
    # A reference rainbow command line: the three rainbow flags.
    dict(vmax=5.0, num_atoms=21, noisy_weight_init=0.5, n_steps=3,
         max_global_grad_norm=5.0),
    # A reference qrdqn command line.
    dict(num_quantiles=51, huber_param=0.5, learning_rate=1e-4),
]


def _argv(values: dict) -> list:
  return [f"--{k}={v}" for k, v in values.items()]


def _jax_overrides(values: dict) -> dict:
  flags.FLAGS.mark_as_parsed()
  with flagsaver.flagsaver(**values):
    return jtrain._spec_overrides_from_flags()


@pytest.mark.parametrize("values", _CASES,
                         ids=["iqn", "dqn_family", "unset", "prioritized",
                              "rainbow", "qrdqn"])
def test_spec_overrides_match_the_jax_cli(values):
  argv = ["--agent=iqn"] + _argv(values)
  ours = ttrain._spec_overrides(ttrain._parser().parse_args(argv))
  assert ours == _jax_overrides(values)
  for name in ("huber_param", "tau_latent_dim", "tau_samples_policy",
               "tau_samples_s_tm1", "tau_samples_s_t", "compute_dtype",
               "vmax", "num_atoms", "noisy_weight_init", "num_quantiles"):
    assert (name in ours) == (name in values), name


@pytest.mark.parametrize("argv,want", [
    (["--normalize_weights"], True), (["--nonormalize_weights"], False),
    (["--normalize_weights=false"], False), ([], None)])
def test_normalize_weights_spellings(argv, want):
  ours = ttrain._spec_overrides(ttrain._parser().parse_args(argv))
  assert ours.get("normalize_weights") == want


def test_iqn_flags_reach_the_engine_spec():
  argv = ["--agent=iqn", "--huber_param=2", "--tau_latent_dim=32",
          "--tau_samples_policy=16", "--tau_samples_s_tm1=8",
          "--tau_samples_s_t=8"]
  args = ttrain._parser().parse_args(argv)
  spec = ttrain.build_engine(
      "iqn", "pong", num_envs=2, replay_capacity=64,
      spec_overrides=ttrain._spec_overrides(args), device="cpu").config.agent
  assert (spec.huber_param, spec.tau_latent_dim, spec.tau_samples_policy,
          spec.tau_samples_s_tm1, spec.tau_samples_s_t) == (2.0, 32, 16, 8, 8)


@pytest.mark.parametrize("flag,values,error", [
    ("--num_action_repeats=3", dict(num_action_repeats=3), ValueError),
    ("--num_stacked_frames=2", dict(num_stacked_frames=2), ValueError),
    # bf16 compute is ported; a name the JAX CLI's help does not give
    # raises.
    ("--compute_dtype=float16", None, ValueError),
])
def test_unsupported_values_raise(flag, values, error):
  args = ttrain._parser().parse_args(["--agent=iqn", flag])
  with pytest.raises(error, match=flag[2:].split("=")[0]):
    ttrain._spec_overrides(args)
  if flag.startswith("--compute_dtype"):
    args = ttrain._parser().parse_args(["--compute_dtype=bfloat16"])
    assert ttrain._spec_overrides(args) == {"compute_dtype": "bfloat16"}
  if values is not None:  # the JAX CLI raises the same error
    with pytest.raises(ValueError, match=flag[2:].split("=")[0]):
      _jax_overrides(values)


def test_rainbow_flags_reach_the_engine_spec():
  argv = ["--agent=rainbow", "--vmax=5", "--num_atoms=21",
          "--noisy_weight_init=0.5"]
  engine = ttrain.build_engine(
      "rainbow", "catch", num_envs=2, replay_capacity=64,
      spec_overrides=ttrain._spec_overrides(ttrain._parser().parse_args(
          argv)), device="cpu")
  spec = engine.config.agent
  assert (spec.vmax, spec.num_atoms, spec.noisy_weight_init) == \
      (5.0, 21, 0.5)
  assert engine.network.num_atoms == 21
  assert float(engine.network.support("cpu")[-1]) == 5.0
  sigma = engine.init(0).online_params["value"]["hidden"]["sigma"]["w"]
  assert float(sigma[0, 0].detach()) == pytest.approx(0.5 / 3136 ** 0.5)


def test_num_quantiles_reaches_the_engine_spec():
  argv = ["--agent=qrdqn", "--num_quantiles=51", "--huber_param=0.5"]
  engine = ttrain.build_engine(
      "qrdqn", "seaquest", num_envs=2, replay_capacity=64,
      spec_overrides=ttrain._spec_overrides(ttrain._parser().parse_args(
          argv)), device="cpu")
  spec = engine.config.agent
  assert (spec.num_quantiles, spec.huber_param) == (51, 0.5)
  assert engine.network.num_quantiles == 51
  assert float(engine.network.quantiles("cpu")[0]) == \
      pytest.approx(0.5 / 51, rel=1e-7)
  assert tuple(engine.init(0).online_params["head"]["out"]["w"].shape) == \
      (512, 51 * 18)
