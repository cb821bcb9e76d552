"""bf16 compute of the port against the JAX package's (CPU).

- The seven agents' networks at compute_dtype=bfloat16, full width, batch
  2, from JAX's parameters converted: outputs and every parameter gradient
  against JAX's bf16 network as XLA compiles it on the CPU (dense products
  of bf16-rounded operands with f32 outputs and bf16-rounded input
  gradients; convolutions of bf16-rounded operands with f32 outputs and
  bf16-rounded cotangents: nets/core.py). Each output must also lie nearer
  to JAX's bf16 output than JAX's f32 output does, so that a port that
  quietly computed in f32 fails.
- The IQN head's bf16-operand mode (`mm=bf16`): the plain forward and the
  reference's custom VJP against `iqn_head_fused(interpret=True,
  mm=bfloat16)` at its own test's shape (8, 16, 6).
- dqn/pong bf16 supersteps of both engines from one converted state and
  JAX's draws, through learn steps.
- `--compute_dtype=bfloat16` reaches the spec as the JAX CLI's does.

A bf16 rounding of an f32 value that differs in its last bit between the
two frameworks can land on a neighbouring bf16 value (2^-8 apart,
relative), so the comparisons are relative Frobenius errors over each
tensor, not elementwise; each bound is stated where it is used.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from absl import flags
from absl.testing import flagsaver

from dqn_zoo_tpu.agents import get_agent as jget_agent
from dqn_zoo_tpu.nets import IqnInputs as JIqnInputs
from dqn_zoo_tpu.nets import iqn_head as jhead
from dqn_zoo_tpu.run import train as jtrain
from dqn_zoo_torch import convert, nets
from dqn_zoo_torch.agents import get_agent
from dqn_zoo_torch.engine.superstep import leaves
from dqn_zoo_torch.nets import iqn_head as thead
from dqn_zoo_torch.run import train as ttrain
from test_torch_rainbow import jax_noise
from test_torch_slice import _assert_u8_close, _engines, jax_draws
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

AGENTS = ("dqn", "double_q", "prioritized", "c51", "qrdqn", "rainbow", "iqn")
NUM_ACTIONS = 6
N_TAUS = 8

_t = lambda x: torch.from_numpy(np.array(x))


def rel_fro(got, want) -> float:
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _main_output(name, out):
  """The output the loss of each agent differentiates."""
  if name in ("c51", "rainbow"):
    return out.q_logits
  if name in ("qrdqn", "iqn"):
    return out.q_dist
  return out.q_values


@functools.lru_cache(maxsize=None)
def _jax_net(name, dtype):
  spec = dataclasses.replace(jget_agent(name), compute_dtype=dtype)
  return spec.make_network(spec, NUM_ACTIONS)


def _jax_inputs(name, obs, taus):
  return JIqnInputs(obs, taus) if name == "iqn" else obs


@functools.lru_cache(maxsize=None)
def _jax_side(name):
  """JAX's params, inputs, cotangent, and its bf16 and f32 networks'
  outputs and parameter gradients for one agent's network at batch 2 (one
  jit a dtype)."""
  rng = np.random.RandomState(AGENTS.index(name))
  obs = rng.randint(0, 256, (2, 84, 84, 4)).astype(np.uint8)
  taus = rng.uniform(size=(2, N_TAUS)).astype(np.float32)
  key = jax.random.PRNGKey(7)
  net = _jax_net(name, "bfloat16")
  params = jax.device_get(jax.jit(net.init)(
      jax.random.PRNGKey(AGENTS.index(name)), _jax_inputs(name, obs, taus)))
  nets_by_dtype = {d: _jax_net(name, d) for d in ("bfloat16", "float32")}

  def apply(dtype, p):
    return _main_output(name, nets_by_dtype[dtype].apply(
        p, key, _jax_inputs(name, obs, taus)))

  shape = jax.eval_shape(functools.partial(apply, "float32"), params).shape
  w = rng.standard_normal(shape).astype(np.float32)
  out = dict(params=params, obs=obs, taus=taus, key=key, w=w)
  for dtype in ("bfloat16", "float32"):

    def loss(p, dtype=dtype):
      o = apply(dtype, p)
      return jnp.sum(o * w), o

    (_, o), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    out[dtype] = (np.asarray(o), jax.device_get(grads))
  return out


def _flat_pairs(ours, ref, path=""):
  """(path, ours, ref) for every leaf of the port's tree (JAX's empty ReLU
  entries have no counterpart)."""
  if isinstance(ours, dict):
    for k, v in ours.items():
      yield from _flat_pairs(v, ref[k], f"{path}/{k}")
  else:
    yield path, ours, ref


@pytest.mark.parametrize("name", AGENTS)
def test_bf16_networks_match_jax(name):
  j = _jax_side(name)
  spec = dataclasses.replace(get_agent(name), compute_dtype="bfloat16")
  net = spec.make_network(spec, NUM_ACTIONS)
  assert getattr(net, "_body", net).compute_dtype == torch.bfloat16
  params = convert.params_from_jax(j["params"], "cpu", requires_grad=True)
  obs = _t(j["obs"])
  if name == "iqn":
    inputs = (nets.IqnInputs(obs, _t(j["taus"])),)
  elif name == "rainbow":
    inputs = (obs, jax_noise(j["key"], NUM_ACTIONS, spec.num_atoms))
  else:
    inputs = (obs,)
  got = _main_output(name, net.apply(params, *inputs))
  bf16, bf16_grads = j["bfloat16"]
  f32, f32_grads = j["float32"]
  pairs = list(_flat_pairs(params, bf16_grads))
  grads = torch.autograd.grad((got * _t(j["w"])).sum(),
                              [p for _, p, _ in pairs])
  # With no ReLU branch flip the port agrees to ~1e-7, the sums' order
  # alone. A pre-activation within rounding of 0 that takes the other
  # branch in one framework (qrdqn's data here: one hidden unit at -1.3e-6
  # against +6.9e-6, after a bf16 neighbour flip in the torso) moves the
  # outputs by ~3e-4 and the gradients by ~1e-2 (relative Frobenius), hence
  # the bounds 1e-3 and 2e-2. The bf16 arithmetic itself is held by the
  # second check: JAX's f32 network lies 1e-4 to 4e-3 off the bf16 outputs
  # and 0.5 to 19 % off the gradients, and the port must lie within a
  # quarter of that.
  err, f32_err = rel_fro(got.detach().numpy(), bf16), rel_fro(f32, bf16)
  assert err <= 1e-3 and err < 0.25 * f32_err, (name, err, f32_err)
  for (path, _, want), g, want32 in zip(
      pairs, grads, (w for _, _, w in _flat_pairs(params, f32_grads))):
    err = rel_fro(g.numpy(), want)
    assert err <= 2e-2, (name, path, err)
    if not np.array_equal(want32, want):
      assert err < 0.25 * rel_fro(want32, want), (name, path, err)


# --- the IQN head's bf16-operand mode -----------------------------------------

D, H, L = 3136, 512, 64
HEAD_ORDER = ("we", "be", "wh", "bh", "wo", "bo", "cos_emb", "s_emb")


@functools.lru_cache(maxsize=None)
def _jax_head(b, s, a):
  """Inputs at the scale of the reference's own test (test_iqn_head._make),
  a cotangent, and the fused head's q and gradients in interpret mode at
  mm = bf16 and f32."""
  rng = np.random.RandomState(11)
  sc = 0.05
  args = [rng.randn(L, D) * sc, rng.randn(D) * sc, rng.randn(D, H) * sc * 0.3,
          rng.randn(H) * sc, rng.randn(H, a) * sc, rng.randn(a) * sc,
          rng.randn(b, s, L), np.maximum(rng.randn(b, D), 0.0)]
  args = [x.astype(np.float32) for x in args]
  w = rng.randn(b, s, a).astype(np.float32)
  out = {}
  for name, mm in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
    fused = functools.partial(jhead.iqn_head_fused, interpret=True, mm=mm)
    q, vjp = jax.jit(lambda *p: jax.vjp(fused, *p))(*args)
    out[name] = (np.asarray(q), [np.asarray(g) for g in jax.jit(vjp)(w)])
  return args, w, out


def test_bf16_iqn_head_matches_the_fused_reference():
  args, w, ref = _jax_head(8, 16, 6)
  pa = [_t(x).requires_grad_(True) for x in args]
  q = thead.iqn_head(*pa, mm=torch.bfloat16)
  grads = torch.autograd.grad((q * _t(w)).sum(), pa)
  # The same custom VJP, not autograd through the casts: one call of the
  # Function's plain backward gives the same gradients.
  with torch.no_grad():
    pq, h = thead.iqn_head_plain_residuals(*map(_t, args), mm=torch.bfloat16)
  assert torch.equal(q.detach(), pq)
  direct = thead.iqn_head_backward(
      _t(args[0]), _t(args[1]), _t(args[2]), _t(args[4]), _t(args[6]),
      _t(args[7]), h, _t(w), thead.iqn_head_bwd_w_plain,
      thead.iqn_head_bwd_d_plain, mm=torch.bfloat16)
  for g, dg in zip(grads, direct):
    assert torch.equal(g, dg)
  # q: within 2e-4 (a bf16 flip of one hi or h entry moves q by ~1e-5);
  # the f32 head lies ~4e-3 off.
  bf16_q, bf16_g = ref["bf16"]
  f32_q, f32_g = ref["f32"]
  err = rel_fro(q.detach().numpy(), bf16_q)
  assert err <= 2e-4 and err < 0.1 * rel_fro(f32_q, bf16_q), err
  # Each gradient within 1e-4; where bf16 moves it at all (dbo is dq's sum
  # in both modes), at most a tenth of the f32 head's distance.
  for name, g, want, f32 in zip(HEAD_ORDER, grads, bf16_g, f32_g):
    err = rel_fro(g.numpy(), want)
    assert err <= 1e-4, (name, err)
    if not np.array_equal(f32, want):
      assert err < 0.1 * rel_fro(f32, want), (name, err)


def test_matmul_dtype_names():
  assert thead.matmul_dtype(None) is None
  assert thead.matmul_dtype(torch.float32) is None
  assert thead.matmul_dtype(torch.bfloat16) is torch.bfloat16
  with pytest.raises(ValueError, match="mm must be"):
    thead.matmul_dtype(torch.float16)
  net = nets.iqn_atari_network(6, 64, compute_dtype="bfloat16")
  assert net.head_matmul_dtype is None  # the head stays f32, as JAX's
  net = nets.iqn_atari_network(6, 64, head_matmul_dtype=torch.bfloat16)
  assert net.head_matmul_dtype is torch.bfloat16
  assert net.compute_dtype == torch.float32


# --- the engine ---------------------------------------------------------------


def test_bf16_dqn_supersteps_match_jax():
  jeng, teng = _engines(compute_dtype="bfloat16")
  assert teng.network.compute_dtype == torch.bfloat16
  jstate = jeng.init(jax.random.PRNGKey(0))
  tstate = convert.engine_state_from_jax(teng, jax.device_get(jstate))
  jstep = jax.jit(jeng.superstep)
  for step in range(6):
    draws = jax_draws(jeng, jax.device_get(jstate))
    jstate = jstep(jstate)
    tstate = teng.superstep(tstate, draws)
    ref = convert.engine_state_from_jax(teng, jax.device_get(jstate))
    assert torch.equal(tstate.replay.action, ref.replay.action), step
    _assert_u8_close(tstate.replay.frames, ref.replay.frames, step)
    assert tstate.telemetry.learn_steps == ref.telemetry.learn_steps
    if ref.telemetry.learn_steps:
      # The loss within 1e-3 relative, as the f32 slice's.
      np.testing.assert_allclose(float(tstate.telemetry.last_loss),
                                 float(ref.telemetry.last_loss), rtol=1e-3)
    # Parameters: centred RMSProp's first steps move a weight by up to
    # lr·4.6 ≈ 1.2e-3 whatever the gradient's size, so a bf16 flip in a
    # gradient entry moves it by a small share of that; nearly every weight
    # agrees to 2e-6, as in the f32 slice.
    diff = torch.cat([(a - w).detach().abs().flatten() for a, w in
                      zip(leaves(tstate.online_params),
                          leaves(ref.online_params))])
    assert float(diff.max()) <= 5e-5, (step, float(diff.max()))
    assert float((diff <= 2e-6).float().mean()) >= 0.999, step
  assert ref.telemetry.learn_steps >= 3


# --- the CLI ------------------------------------------------------------------


def test_cli_bf16_reaches_the_spec_as_the_jax_cli():
  argv = ["--agent=dqn", "--compute_dtype=bfloat16"]
  ours = ttrain._spec_overrides(ttrain._parser().parse_args(argv))
  flags.FLAGS.mark_as_parsed()
  with flagsaver.flagsaver(compute_dtype="bfloat16"):
    assert ours == jtrain._spec_overrides_from_flags() == \
        {"compute_dtype": "bfloat16"}
  engine = ttrain.build_engine("iqn", "pong", num_envs=2, replay_capacity=64,
                               spec_overrides=ours, device="cpu")
  assert engine.network.compute_dtype == torch.bfloat16
