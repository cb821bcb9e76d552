"""The benchmark's operation and byte counts against counts by hand."""

import pytest

from benchmark import work

IQN = dict(n_steps=1, tau_samples_policy=64, tau_samples_s_tm1=64,
           tau_samples_s_t=64)
RAINBOW = dict(n_steps=3, num_atoms=51)


def test_torso_forward_is_15_5_mflop_a_sample():
  # conv1 400 positions x 32 x 256 taps, conv2 81 x 64 x 512, conv3
  # 49 x 64 x 576 multiply-adds.
  macs = 400 * 32 * 256 + 81 * 64 * 512 + 49 * 64 * 576
  assert macs == 7_737_344
  assert work.torso_fwd(1)[0] == 2 * macs == 15_474_688
  assert work.torso_fwd(1024)[0] == 1024 * 15_474_688


def test_torso_bytes():
  params = (8 * 8 * 4 * 32 + 32) + (4 * 4 * 32 * 64 + 64) \
      + (3 * 3 * 64 * 64 + 64)
  assert work.torso_fwd(2)[1] == 2 * 84 * 84 * 4 + 4 * params + 4 * 2 * 3136
  assert work.torso_fwd(2, residuals=True)[1] == work.torso_fwd(2)[1] \
      + 4 * 2 * (400 * 32 + 81 * 64)


def test_torso_backward_skips_the_frames_gradient():
  c1, c2, c3 = 2 * 400 * 32 * 256, 2 * 81 * 64 * 512, 2 * 49 * 64 * 576
  assert work.torso_bwd_ops(1) == (c1 + c2 + c3) + (c2 + c3)


@pytest.mark.parametrize("b,s,a", [(2, 3, 6), (1024, 128, 6)])
def test_iqn_head_forward(b, s, a):
  rows = b * s
  ops = 2 * rows * (64 * 3136 + 3136 * 512 + 512 * a)
  assert work.iqn_head_fwd(b, s, a)[0] == ops


def test_iqn_target_pass_is_474_gflop():
  ops = work.iqn_head_fwd(1024, 128, 6)[0]
  assert ops == 2 * 131072 * 1_809_408
  assert abs(ops / 1e9 - 474.3) < 0.1


def test_iqn_head_bytes_at_a_small_shape():
  b, s, a = 2, 3, 6
  floats = (6 * 64 + 2 * 3136 + 64 * 3136 + 3136 + 3136 * 512 + 512
            + 512 * 6 + 6 + 6 * 6)
  assert work.iqn_head_fwd(b, s, a)[1] == 4 * floats
  assert work.iqn_head_fwd(b, s, a, residuals=True)[1] == 4 * (
      floats + 6 * 512)


def test_iqn_head_backward():
  b, s = 2, 3
  assert work.iqn_head_bwd(b, s)[0] == 2 * 6 * (2 * 3136 * 512 + 64 * 3136)
  ins = 6 * 64 + 2 * 3136 + 6 * 512 + 64 * 3136 + 3136 + 3136 * 512
  outs = 3136 * 512 + 512 + 64 * 3136 + 3136 + 2 * 3136
  assert work.iqn_head_bwd(b, s)[1] == 4 * (ins + outs)


def test_c51_noisy_dueling_head():
  a, atoms = 6, 51
  layers = [(3136, 512), (512, 306), (3136, 512), (512, 51)]
  fwd = sum(4 * i * o + 2 * i * o for i, o in layers)  # B = 1
  assert work.c51_noisy_dueling_fwd_ops(1, a, atoms) == fwd
  assert work.c51_noisy_dueling_bwd_ops(1, a, atoms) == sum(
      8 * i * o for i, o in layers)


def test_window_gather_and_frame_prep_bytes():
  assert work.window_gather(1024, 5)[1] == 2 * 1024 * 5 * 7056 + 16 * 1024
  assert work.frame_prep(128)[1] == 128 * (2 * 210 * 160 * 3 + 84 * 84)
  # K2 at B = 128 is bound at ~8.0 µs, K1 at B = 1024, W = 5 at ~21.6 µs.
  assert abs(work.least_seconds([work.frame_prep(128)], 1.0) - 8.0e-6) \
      < 0.1e-6
  assert abs(work.least_seconds([work.window_gather(1024, 5)], 1.0)
             - 21.6e-6) < 0.1e-6


def test_least_time_takes_the_larger_bound_launch_by_launch():
  w = [(495e12, 0.0), (0.0, 3.35e12)]
  assert work.least_seconds(w, work.PEAK["tf32"]) == pytest.approx(2.0)


@pytest.mark.parametrize("family,flags", [("iqn", IQN),
                                          ("rainbow", RAINBOW)])
def test_launch_pattern_and_model_ops(family, flags):
  pat = work.superstep_launches(family, 128, 1024, flags, 6)
  assert len(pat["dqn_torso_fwd"]) == (2 if family == "iqn" else 3)
  assert pat["gather_windows"] == [work.window_gather(
      1024, 4 + flags["n_steps"])]
  ops = work.model_ops(family, 128, 1024, flags, 6)
  torso = work.torso_fwd(1)[0]
  assert ops > (128 + 3 * 1024) * torso


def test_iqn_superstep_model_ops():
  ops = work.model_ops("iqn", 128, 1024, IQN, 6)
  head = lambda b, s: 2 * b * s * (64 * 3136 + 3136 * 512 + 512 * 6)
  want = (work.torso_fwd(128)[0] + head(128, 64)
          + work.torso_fwd(1024)[0] + head(1024, 64)
          + work.torso_bwd_ops(1024)
          + 2 * 65536 * (2 * 3136 * 512 + 64 * 3136) + 4 * 65536 * 512 * 6
          + work.torso_fwd(1024)[0] + head(1024, 128))
  assert ops == want
  assert 1.2e12 < ops < 1.3e12
