"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: they skip without a card. On a machine with one (and without
JAX, which tests/conftest.py imports), run them with
  python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from dqn_zoo_torch import kernels
from dqn_zoo_torch.device import set_numerics
from dqn_zoo_torch.nets import torso_cuda
from dqn_zoo_torch.prep import atari as tprep
from dqn_zoo_torch.prep import cuda_prep
from dqn_zoo_torch.replay import window_gather as twg

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  set_numerics()
  return torch.device("cuda")


def _gen(seed):
  g = torch.Generator(device="cuda")
  g.manual_seed(seed)
  return g


@pytest.mark.parametrize("batch,window", [(1024, 5), (3, 7)])
def test_k1_matches_plain(dev, batch, window):
  g = _gen(0)
  frames = torch.randint(0, 256, (16, 40, 84, 84), generator=g, device=dev,
                         dtype=torch.uint8)
  stream = torch.randint(-2, 18, (batch,), generator=g, device=dev)
  start = torch.randint(-3, 42, (batch,), generator=g, device=dev)
  before = twg.KERNEL.launches
  got = twg.gather_windows(frames, stream, start, window)
  torch.cuda.synchronize()
  assert twg.KERNEL.launches == before + 1
  assert torch.equal(got, twg.gather_windows_plain(frames, stream, start,
                                                   window))


@pytest.mark.parametrize("batch", [128, 5])
def test_k2_matches_plain(dev, batch):
  g = _gen(1)
  f1 = torch.randint(0, 256, (batch, 210, 160, 3), generator=g, device=dev,
                     dtype=torch.uint8)
  f2 = torch.randint(0, 256, (batch, 210, 160, 3), generator=g, device=dev,
                     dtype=torch.uint8)
  f1[0] = 0  # the zero-penult (episode start) case
  got = cuda_prep.pooled_frame_to_84(f1, f2)
  torch.cuda.synchronize()
  want = tprep.pooled_frame_to_84_plain(f1, f2)
  diff = (got.int() - want.int()).abs()
  assert int(diff.max()) <= 1
  assert float((diff == 0).float().mean()) > 0.98


def _torso_params(dev, seed):
  g = _gen(seed)
  ws = []
  for name, shape in torso_cuda.SHAPES.items():
    fan_in = int(np.prod(shape[:-1])) if name.startswith("w") else 256
    u = torch.rand(shape, generator=g, device=dev) * 2 - 1
    ws.append(u / fan_in ** 0.5)
  return ws


@pytest.mark.parametrize("batch", [128, 1024, 7])
def test_k3a_matches_plain(dev, batch):
  ws = _torso_params(dev, 2)
  x = torch.randint(0, 256, (batch, 84, 84, 4), generator=_gen(3),
                    device=dev, dtype=torch.uint8)
  with torch.no_grad():
    got = torso_cuda.dqn_torso(*ws, x)
  want = torso_cuda.torso_plain(*ws, x)
  torch.cuda.synchronize()
  # f32 on both sides, summed in another order (TF32 is off).
  torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_k3b_residuals_and_gradients_match_plain(dev):
  ws = _torso_params(dev, 4)
  x = torch.randint(0, 256, (64, 84, 84, 4), generator=_gen(5), device=dev,
                    dtype=torch.uint8)
  out, z1, z2 = torso_cuda.torso_forward(ws, x, residuals=True)
  want, wz1, wz2 = torso_cuda.torso_plain_residuals(*ws, x)
  torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-5)
  torch.testing.assert_close(z1, wz1, rtol=1e-4, atol=1e-5)
  torch.testing.assert_close(z2, wz2, rtol=1e-4, atol=1e-5)

  dy = torch.randn((64, 3136), generator=_gen(6), device=dev)
  a = [w.clone().requires_grad_(True) for w in ws]
  b = [w.clone().requires_grad_(True) for w in ws]
  ga = torch.autograd.grad((torso_cuda.dqn_torso(*a, x) * dy).sum(), a)
  # The reference takes the kernel's ReLU masks: a pre-activation within
  # f32 rounding of 0 may take the other branch in the plain forward and
  # move a weight gradient by a whole term (chip_smoke.py counts them).
  masks = [(t > 0).float() for t in (z1, z2, out.reshape(-1, 7, 7, 64))]
  gb = torch.autograd.grad(
      (torso_cuda.torso_plain_masked(*b, x, masks) * dy).sum(), b)
  for u, v in zip(ga, gb):
    assert float(torch.linalg.vector_norm(u - v)
                 / torch.linalg.vector_norm(v)) <= 1e-4


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
  with pytest.raises(ValueError):
    twg.gather_windows(torch.zeros((2, 8, 84, 84), device=dev),
                       torch.zeros(3, dtype=torch.int32, device=dev),
                       torch.zeros(3, dtype=torch.int32, device=dev), 5)
  z = torch.zeros((2, 210, 160, 3), dtype=torch.uint8, device=dev)
  with pytest.raises(ValueError):
    cuda_prep.pooled_frame_to_84(z, z[:, :, :, :1].contiguous())
  ws = _torso_params(dev, 7)
  with pytest.raises(ValueError):
    torso_cuda.torso_forward(ws, torch.zeros((2, 84, 84, 4), device=dev),
                             residuals=False)


def test_every_kernel_builds(dev):
  kernels.build_all()
  for k in kernels.REGISTRY.values():
    assert k._func() is not None
