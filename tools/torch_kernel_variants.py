"""Design checks for the port's K4a and K1 kernels on one card.

  python tools/torch_kernel_variants.py

Prints one JSON line per check, each time a device time from CUDA-graph
replays (the host out of the way):
  MMA_PEAK  the TF32 rate `mma.sync.m16n8k8` reaches on this card with
            8 warps per SM and no memory traffic: the ceiling of K4a's
            tensor-core path (3xTF32 takes three of these per f32 product);
  K4A       K4a as built from csrc/iqn_head.cu against a variant built from
            the same source without the per-k-step fold (all three TF32
            products added straight into the accumulator), at the act, eval,
            ragged and learn shapes: time, and the largest error of q and h
            as a share of the tolerance (rtol 1e-4, atol 1e-5);
  K1        K1 against `index_select` on precomputed rows and a contiguous
            copy of the same bytes (the rate this mix of reads and writes
            reaches at best), rotating 8 index sets as chip_smoke.py does.
Needs a CUDA card and nvcc; builds into .torch_kernels/variants/.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from dqn_zoo_torch import kernels  # noqa: E402
from dqn_zoo_torch.nets import iqn_head as ih  # noqa: E402
from dqn_zoo_torch.replay import window_gather as twg  # noqa: E402

OUT = kernels.BUILD_DIR / "variants"

PEAK_SRC = r"""
#include <cstdint>
__global__ void __launch_bounds__(256, 1) peak(float* out, int iters) {
  float c[16][4] = {};
  const uint32_t a[4] = {threadIdx.x, 3u * threadIdx.x, 7u, 9u};
  const uint32_t b[2] = {5u * threadIdx.x, 11u};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < 16; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}
extern "C" int run(void* out, int blocks, int iters, void* stream) {
  peak<<<blocks, 256, 0, (cudaStream_t)stream>>>((float*)out, iters);
  return (int)cudaGetLastError();
}
"""


def build(name: str, source: str) -> ctypes.CDLL:
  OUT.mkdir(parents=True, exist_ok=True)
  cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
  cu.write_text(source)
  subprocess.run([kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-o", str(so),
                  str(cu)], check=True, capture_output=True)
  return ctypes.CDLL(str(so))


def graph_ms(fn, n: int, reps: int = 5) -> float:
  fn()
  torch.cuda.synchronize()
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    for _ in range(n):
      fn()
  graph.replay()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    graph.replay()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / (n * reps)


def mma_peak(dev) -> dict:
  lib = build("mma_peak", PEAK_SRC)
  lib.run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p]
  sms = torch.cuda.get_device_properties(dev).multi_processor_count
  out = torch.empty(sms * 256, device=dev)
  iters = 4000
  ms = graph_ms(lambda: lib.run(out.data_ptr(), sms, iters,
                                kernels.stream_ptr(out.device)), n=2)
  flops = sms * 8 * iters * 16 * 2 * 16 * 8 * 8
  return dict(blocks=sms, warps_per_sm=8, tflops=flops / ms / 1e9)


def k4a(dev, gen) -> None:
  src = (kernels.CSRC / "iqn_head.cu").read_text()
  fold = "mma_3xtf32_rn(acc[i][j]"
  if fold not in src:
    raise SystemExit("iqn_head.cu no longer has the per-k-step fold")
  libs = {"kernel": build("iqn_head", src),
          "no_fold": build("iqn_head_no_fold",
                           src.replace(fold, "mma_3xtf32(acc[i][j]"))}
  for lib in libs.values():
    lib.dz_iqn_head.argtypes = ih._ARGS
    lib.dz_iqn_head.restype = ctypes.c_int
  for b, s, a, res in [(128, 64, 6, False), (4, 64, 6, False),
                       (3, 24, 18, True), (1024, 64, 6, True),
                       (1024, 128, 6, False)]:
    n = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    args = (n(64, 3136) * 0.05, n(3136) * 0.05, n(3136, 512) * 0.015,
            n(512) * 0.05, n(512, a) * 0.05, n(a) * 0.05, n(b, s, 64),
            torch.relu(n(b, 3136)))
    want_q, want_h = ih.iqn_head_plain_residuals(*args)
    q = torch.empty((b, s, a), device=dev)
    h = torch.empty((b * s, 512), device=dev) if res else None
    splits = ih.d_splits(b, s)
    part = torch.empty((splits, b * s, 512), device=dev) if splits > 1 \
        else None
    ptrs = [t.data_ptr() for t in args[6:]] + \
        [t.data_ptr() for t in args[:6]]
    line = dict(shape=f"B={b} S={s} A={a}", residuals=res, splits=splits)
    for name, lib in libs.items():
      call = lambda: lib.dz_iqn_head(
          ptrs[0], ptrs[1], *ptrs[2:], q.data_ptr(),
          None if h is None else h.data_ptr(),
          None if part is None else part.data_ptr(), b, s, 3136, a,
          int(res), splits, ih.chunks_per_split(splits),
          kernels.stream_ptr(q.device))
      if call() != 0:
        raise SystemExit(f"{name}: launch failed")
      torch.cuda.synchronize()
      share = lambda got, want: float(
          ((got - want).abs() / (1e-5 + 1e-4 * want.abs())).max())
      line[name] = dict(
          ms=graph_ms(call, n=5 if b == 1024 else 20),
          q_err=float((q - want_q).abs().max()),
          q_share_of_tolerance=share(q, want_q))
      if res:
        line[name].update(h_err=float((h - want_h).abs().max()),
                          h_share_of_tolerance=share(h, want_h))
    print("K4A " + json.dumps(line), flush=True)
    del args, q, h, part, want_q, want_h


def k1(dev, gen) -> None:
  b, w, s, r = 1024, 5, 128, 2048
  frames = torch.randint(0, 256, (s, r, 84, 84), generator=gen, device=dev,
                         dtype=torch.uint8)
  flat = frames.view(s * r, 84 * 84)
  sets = []
  for _ in range(8):
    stream = torch.randint(0, s, (b,), generator=gen, device=dev)
    start = torch.randint(0, r - w + 1, (b,), generator=gen, device=dev)
    rows = (stream[:, None] * r + start[:, None]
            + torch.arange(w, device=dev)).reshape(-1)
    sets.append((stream, start, rows))
  turn = [0]

  def rotating(fn):
    def call():
      fn(*sets[turn[0] % len(sets)])
      turn[0] += 1
    return call

  src, dst = flat[:b * w], torch.empty_like(flat[:b * w])
  line = dict(shape=f"B={b} W={w}", mb_each_way=b * w * 7056 / 1e6)
  for _ in range(3):  # in turns
    for name, fn in (
        ("kernel", rotating(lambda st, sa, _: twg.gather_windows(
            frames, st, sa, w))),
        ("index_select", rotating(
            lambda _, __, rw: torch.index_select(flat, 0, rw))),
        ("contiguous_copy", lambda: dst.copy_(src))):
      line.setdefault(f"{name}_ms", []).append(graph_ms(fn, n=16))
  print("K1 " + json.dumps(line), flush=True)


def main() -> int:
  if not torch.cuda.is_available():
    print("needs a CUDA card", file=sys.stderr)
    return 1
  dev = torch.device("cuda")
  gen = torch.Generator(device=dev)
  gen.manual_seed(0)
  print("MMA_PEAK " + json.dumps(mma_peak(dev)), flush=True)
  k4a(dev, gen)
  k1(dev, gen)
  return 0


if __name__ == "__main__":
  sys.exit(main())
