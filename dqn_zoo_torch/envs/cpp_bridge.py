"""ctypes bridge to the C++ env farm (port of dqn_zoo_tpu/envs/cpp_bridge.py).

The farm (`cpp/dz_env.cc`, C ABI in `cpp/dz_env.h`) is a thread-pooled set
of C++ game instances that does the whole Atari host protocol (action
repeat, max-pool, grayscale and resize to 84×84, noop starts, life-loss
discount, frame-cap truncation, auto-reset) and hands back upload-ready
uint8 observations. `engine/host_env.py` drives it.

The library is built from the repository's source at first use: `g++` (or
`$CXX`) with the flags of `cpp/Makefile`, into `.torch_kernels/` at the root
of the checkout, under a name that carries the hash of `dz_env.cc`,
`dz_env.h`, the flags and this machine's CPU (`-march=native` code runs only
where it was built). Nothing is written into `cpp/`, and the committed
`cpp/libdz_env.so` is never loaded. `DZ_ENV_LIB` selects another build, such
as the ALE backend's (`make -C cpp ale`): an absolute path, or a name
relative to `cpp/`.

`CppVectorEnv.step` returns the farm's outputs in host memory;
`CppVectorEnv.upload` copies a group to the env's device. On the card the
group lies in pinned memory and the copy is asynchronous, so the farm writes
into two buffer sets in turn, and before it writes into a set again it waits
for the CUDA event recorded after that set's copy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from dqn_zoo_torch.device import resolve_device

_ROOT = pathlib.Path(__file__).resolve().parents[2]
CPP_DIR = _ROOT / "cpp"
BUILD_DIR = _ROOT / ".torch_kernels"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-pthread", "-shared")
OBS = 84

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


class HostGroupOutput(NamedTuple):
  """One agent-step of B host envs. `obs84`, `reward_sum` and
  `discount_prod` are the env's own buffers: the farm overwrites them two
  steps later."""

  obs84: np.ndarray  # (B, 84, 84) uint8 (pooled+gray+resized)
  reward_sum: np.ndarray  # (B,) f32 raw group sum
  discount_prod: np.ndarray  # (B,) f32
  is_first: np.ndarray  # (B,) bool
  is_last: np.ndarray  # (B,) bool
  is_truncated: np.ndarray  # (B,) bool
  lives: np.ndarray  # (B,) i32
  frames_used: np.ndarray  # (B,) i32


class DeviceGroupOutput(NamedTuple):
  """What the device half-step reads of a group, on the env's device."""

  obs84: torch.Tensor  # (B, 84, 84) uint8
  reward_sum: torch.Tensor  # (B,) f32
  discount_prod: torch.Tensor  # (B,) f32
  is_first: torch.Tensor  # (B,) bool
  is_last: torch.Tensor  # (B,) bool
  frames_used: torch.Tensor  # (B,) i32


def find_cxx() -> str:
  for cand in (os.environ.get("CXX"), "g++"):
    path = cand and shutil.which(cand)
    if path:
      return path
  raise RuntimeError(
      "no C++ compiler found (set CXX or install g++): the env farm is built "
      "from cpp/dz_env.cc at first use.")


def _cpu_id() -> bytes:
  """The first CPU's model and feature flags, which `-march=native`
  compiles for."""
  try:
    with open("/proc/cpuinfo", "rb") as f:
      lines = f.read().split(b"\n\n")[0].splitlines()
  except OSError:
    import platform
    return platform.processor().encode()
  return b"\n".join(x for x in lines
                    if x.startswith((b"model name", b"flags")))


def farm_path(cxx: str) -> pathlib.Path:
  h = hashlib.sha256()
  for name in ("dz_env.cc", "dz_env.h"):
    h.update((CPP_DIR / name).read_bytes())
  h.update(" ".join((cxx,) + CXX_FLAGS).encode())
  h.update(_cpu_id())
  return BUILD_DIR / f"libdz_env_{h.hexdigest()[:16]}.so"


def build_farm() -> float:
  """Builds the farm from cpp/dz_env.cc unless this build exists; returns
  the seconds the build took (0.0 when there was nothing to build)."""
  cxx = find_cxx()
  out = farm_path(cxx)
  if out.exists():
    return 0.0
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  # A private name, then an atomic rename: test processes may build at once.
  tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
  t0 = time.monotonic()
  proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                         str(CPP_DIR / "dz_env.cc")],
                        capture_output=True, text=True)
  if proc.returncode != 0:
    tmp.unlink(missing_ok=True)
    raise RuntimeError(f"building the env farm failed:\n{proc.stderr}")
  os.replace(tmp, out)
  return time.monotonic() - t0


def library_path() -> pathlib.Path:
  """DZ_ENV_LIB's library if set (absolute, or relative to cpp/), else the
  farm built from source."""
  chosen = os.environ.get("DZ_ENV_LIB")
  if chosen:
    path = pathlib.Path(chosen)
    path = path if path.is_absolute() else CPP_DIR / path
    if not path.exists():
      raise FileNotFoundError(f"DZ_ENV_LIB names {path}, which does not "
                              "exist.")
    return path
  build_farm()
  return farm_path(find_cxx())


def get_lib() -> ctypes.CDLL:
  with _LOCK:
    path = str(library_path())
    lib = _LIBS.get(path)
    if lib is None:
      lib = ctypes.CDLL(path)
      lib.dz_create.restype = ctypes.c_void_p
      lib.dz_create.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int]
      lib.dz_destroy.restype = None
      lib.dz_destroy.argtypes = [ctypes.c_void_p]
      lib.dz_num_actions.restype = ctypes.c_int
      lib.dz_num_actions.argtypes = [ctypes.c_void_p]
      lib.dz_step.restype = None
      lib.dz_step.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 7
      _LIBS[path] = lib
    return lib


class _BufferSet:
  """One group's outputs in one byte buffer (pinned for the card), carved
  into the farm's arrays: rewards, discounts, lives, frames (4-byte
  fields first), then the observations and the flags."""

  def __init__(self, b: int, pin: bool):
    self.nbytes = 16 * b + OBS * OBS * b + b
    self.raw = torch.empty((self.nbytes,), dtype=torch.uint8, pin_memory=pin)
    raw = self.raw.numpy()
    field = lambda i, dtype: raw[4 * b * i:4 * b * (i + 1)].view(dtype)
    self.rewards = field(0, np.float32)
    self.discounts = field(1, np.float32)
    self.lives = field(2, np.int32)
    self.frames = field(3, np.int32)
    self.obs = raw[16 * b:16 * b + OBS * OBS * b].reshape(b, OBS, OBS)
    self.flags = raw[16 * b + OBS * OBS * b:]
    self.copied: Optional[torch.cuda.Event] = None


class CppVectorEnv:
  """Batched host env with the same agent-step contract as envs.vector."""

  def __init__(self, game: str, batch_size: int, seed: int = 0,
               num_threads: int = 0, max_noops: int = 30,
               action_repeat: int = 4, episode_frame_cap: int = 108_000,
               device=None):
    self.device = resolve_device(device)
    self._lib = get_lib()
    self.batch_size = batch_size
    self._handle = self._lib.dz_create(game.encode(), batch_size, seed,
                                       num_threads, max_noops, action_repeat,
                                       episode_frame_cap)
    if not self._handle:
      raise ValueError(f"unknown game {game!r}")
    self.num_actions = self._lib.dz_num_actions(self._handle)
    pin = self.device.type == "cuda"
    self._sets = (_BufferSet(batch_size, pin), _BufferSet(batch_size, pin))
    self._next = 0

  def step(self, actions: np.ndarray) -> HostGroupOutput:
    actions = np.ascontiguousarray(actions, np.int32)
    if actions.shape != (self.batch_size,):
      raise ValueError(f"actions of shape {actions.shape}, expected "
                       f"({self.batch_size},)")
    s = self._sets[self._next]
    if s.copied is not None:  # this set's last upload must have landed
      s.copied.synchronize()
      s.copied = None
    c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    self._lib.dz_step(self._handle, c(actions), c(s.obs), c(s.rewards),
                      c(s.discounts), c(s.flags), c(s.lives), c(s.frames))
    self._next = 1 - self._next
    flags = s.flags
    return HostGroupOutput(
        obs84=s.obs,
        reward_sum=s.rewards,
        discount_prod=s.discounts,
        is_first=(flags & 1).astype(bool),
        is_last=(flags & 2).astype(bool),
        is_truncated=(flags & 4).astype(bool),
        lives=s.lives.copy(),
        frames_used=s.frames.copy(),
    )

  def upload(self, group: HostGroupOutput) -> DeviceGroupOutput:
    """`group` (one this env's `step` returned, still in its buffers) on
    the env's device: one asynchronous copy from pinned memory on the card,
    a copy on the CPU."""
    s = next((s for s in self._sets if group.obs84 is s.obs), None)
    if s is None:
      raise ValueError("upload takes a group that this env's step returned.")
    if self.device.type == "cuda":
      raw = torch.empty((s.nbytes,), dtype=torch.uint8, device=self.device)
      raw.copy_(s.raw, non_blocking=True)
      s.copied = torch.cuda.Event()
      s.copied.record()
    else:
      raw = s.raw.clone()
    b = self.batch_size
    field = lambda i, dtype: raw[4 * b * i:4 * b * (i + 1)].view(dtype)
    flags = raw[16 * b + OBS * OBS * b:]
    return DeviceGroupOutput(
        obs84=raw[16 * b:16 * b + OBS * OBS * b].view(b, OBS, OBS),
        reward_sum=field(0, torch.float32),
        discount_prod=field(1, torch.float32),
        is_first=(flags & 1) != 0,
        is_last=(flags & 2) != 0,
        frames_used=field(3, torch.int32),
    )

  def close(self) -> None:
    if self._handle:
      self._lib.dz_destroy(self._handle)
      self._handle = None

  def __del__(self):
    try:
      self.close()
    except Exception:
      pass
