"""Build, load and count the port's hand-written CUDA kernels.

Each `csrc/*.cu` file is compiled by `nvcc` into its own shared library with
a plain C interface and loaded with `ctypes` (no PyTorch headers, so a build
takes seconds). All sources build in parallel, one `nvcc` each, at first use,
into `.torch_kernels/` at the root of the checkout; a library's file name
carries the hash of its source, of the shared headers (`csrc/*.cuh`) and of
the nvcc flags, so an edited source is rebuilt and an unchanged one is
reused.

`-Xptxas -v` is among the flags: each build's compiler output (registers,
shared memory and spills of every kernel) is kept in `BUILD_LOG`.

Every kernel wrapper owns a `Kernel` whose `launches` counter goes up by one
where the wrapper launches the kernel and nowhere else, so a run can show
that its main path went through the kernels.
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
from typing import Dict, Optional

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / ".torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}  # source -> nvcc's output, for those built


def find_nvcc() -> str:
  for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
               "/usr/local/cuda/bin/nvcc"):
    if cand and os.path.exists(cand):
      return cand
  raise RuntimeError("nvcc not found (set NVCC or install the CUDA toolkit); "
                     "the port's CUDA kernels are built from csrc/ at first "
                     "use.")


def _lib_path(source: str) -> pathlib.Path:
  h = hashlib.sha256((CSRC / source).read_bytes())
  for header in sorted(CSRC.glob("*.cuh")):
    h.update(header.read_bytes())
  h.update(" ".join(NVCC_FLAGS).encode())
  return BUILD_DIR / f"{pathlib.Path(source).stem}_{h.hexdigest()[:16]}.so"


def build_all(sources=None) -> Dict[str, float]:
  """Builds every (or the named) csrc source not yet built; one nvcc each,
  all started together. Returns {source: seconds} for the ones built."""
  sources = sorted(sources or (p.name for p in CSRC.glob("*.cu")))
  todo = [s for s in sources if not _lib_path(s).exists()]
  if not todo:
    return {}
  nvcc = find_nvcc()
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  procs = {}
  t0 = time.monotonic()
  for s in todo:
    tmp = _lib_path(s).with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / s)]
    procs[s] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
  took, failed = {}, []
  for s, (tmp, p) in procs.items():
    out, _ = p.communicate()
    took[s] = time.monotonic() - t0
    BUILD_LOG[s] = out
    if p.returncode != 0:
      failed.append(f"{s}:\n{out}")
      continue
    os.replace(tmp, _lib_path(s))  # atomic: a reader never sees a half file
  if failed:
    raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
  return took


def load(source: str) -> ctypes.CDLL:
  with _LOCK:
    lib = _LIBS.get(source)
    if lib is None:
      build_all([source])
      lib = ctypes.CDLL(str(_lib_path(source)))
      _LIBS[source] = lib
    return lib


class Kernel:
  """One C entry point of one csrc library, with its launch counter."""

  def __init__(self, name: str, source: str, symbol: str, argtypes):
    self.name = name
    self.source = source
    self.symbol = symbol
    self.argtypes = list(argtypes)
    self.launches = 0
    self._fn: Optional[ctypes._CFuncPtr] = None

  def _func(self):
    if self._fn is None:
      fn = getattr(load(self.source), self.symbol)
      fn.argtypes = self.argtypes
      fn.restype = ctypes.c_int
      self._fn = fn
    return self._fn

  def launch(self, *args) -> None:
    """Calls the C launcher (which returns cudaGetLastError()) and counts."""
    err = self._func()(*args)
    if err != 0:
      raise RuntimeError(f"{self.name}: CUDA launch failed with error {err}")
    self.launches += 1


REGISTRY: Dict[str, Kernel] = {}


def register(kernel: Kernel) -> Kernel:
  REGISTRY[kernel.name] = kernel
  return kernel


def reset_counts() -> None:
  for k in REGISTRY.values():
    k.launches = 0


def counts() -> Dict[str, int]:
  return {name: k.launches for name, k in REGISTRY.items()}


def stream_ptr(device) -> int:
  """The raw pointer of the current CUDA stream of `device` (a CUDA tensor's
  device, which carries its index). Cheaper on the host than
  `torch.cuda.current_stream(device).cuda_stream`, which builds a Stream
  object on every call."""
  import torch
  index = device.index if device.index is not None else \
      torch.cuda.current_device()
  return torch._C._cuda_getCurrentRawStream(index)


P = ctypes.c_void_p
I = ctypes.c_int
