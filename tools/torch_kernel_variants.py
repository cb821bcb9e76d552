"""Design checks for the port's K3, K4a, K4b, K4c, K2 and K1 kernels on one
card.

  python tools/torch_kernel_variants.py [check ...] [--parent=PATH]

(checks: mma_peak k3_parts k4a k4b k4b_parts k4c k4c_parts k4c_sass
k4_bf16 k4_bf16_parts k4a_bf16 k4a_bf16_parts k2 k2_parent k1; all but
k2_parent, k4_bf16 and k4a_bf16 by default. --parent names another version
of the sources, such as the parent commit's: the root of its checkout, or
one source file, for k3_parts (csrc/dqn_torso.cu), k4_bf16
(csrc/iqn_head_bwd.cu), k2 and k2_parent (csrc/pooled_frame_to_84.cu) to
time beside this one; k4a_bf16 takes the root of a checkout whose
csrc/iqn_head.cu still has the TF32 kernel's bf16 mode.)

Prints one JSON line per check, each time a device time from CUDA-graph
replays (the host out of the way):
  MMA_PEAK  the TF32 rate `mma.sync.m16n8k8` reaches on this card with
            8 warps per SM and no memory traffic: the ceiling of K4a's
            tensor-core path (3xTF32 takes three of these per f32 product);
  K3_PARTS  K3a (csrc/dqn_torso.cu, and the --parent source) at B=1024
            with one convolution cut out at a time and with all three cut
            (the outputs are then wrong; only the time counts): where the
            kernel's time goes, layer by layer. A cut puts `if (false)`
            before the layer's routine (tensor-core source) or empties its
            loop (the CUDA-core source before it); the sources are run in
            the order parent, this, this, parent;
  K4A       K4a as built from csrc/iqn_head.cu against a variant built from
            the same source without the per-k-step fold (all three TF32
            products added straight into the accumulator), at the act, eval,
            ragged and learn shapes: time, and the largest error of q and h
            as a share of the tolerance (rtol 1e-4, atol 1e-5);
  K4B       K4b as built from csrc/iqn_head_bwd.cu (a rounding fold of dwh's
            products every 4 k-steps) against variants that fold every
            k-step, every 2 or never (all products straight into the
            accumulator), at the learn shape (B=1024, S=64) and the act
            shape: time, and for dwh and dbh the relative Frobenius error
            and largest elementwise error as shares of chip_smoke.py's
            tolerances (1e-4; rtol 1e-4, atol 1e-5 x max|output|) against
            the plain version;
  K4B_PARTS K4b at the learn shape with one phase cut out at a time (the
            outputs are then wrong; only the time counts): te_pre's
            products, dwh's products, the dh copies, the TF32 splits, the
            fold, the block barrier;
  K4C       K4c as built from csrc/iqn_head_bwd.cu against a variant with a
            per-k-step fold (as dwe has) in its 512-deep product
            dhi = dh @ wh^T, at the learn shape (B=1024, S=64, no dcos)
            and the act shape (with dcos): time, and for each output its
            relative Frobenius error and largest elementwise error as shares
            of chip_smoke.py's tolerances (1e-4; rtol 1e-4, atol 1e-5 x
            max|output|), against the plain version with the kernel's own
            te_pre > 0 bits;
  K4C_PARTS K4c at the learn shape with one phase cut out at a time (the
            outputs are then wrong; only the time counts), and with its TF32
            splits on the FP32 pipe (Veltkamp's) or left out: where the time
            of a 128-row step goes;
  K4C_SASS  instructions and HMMA of K4c's loops that issue `mma`;
  K4_BF16   K4b and K4c in bf16 mode at the learn shape: this source's
            kernels (csrc/iqn_head_bwd_bf16.cu, on operands staged once;
            the staging pass timed apart) against the --parent checkout's
            bf16 mode of csrc/iqn_head_bwd.cu, and the f32 K4b and K4c of
            both, in turns (parent, this, this, parent); and whether the f32
            kernels' SASS (cuobjdump, addresses and encodings dropped) is
            the parent's instruction for instruction;
  K4_BF16_PARTS the bf16 K4b and K4c at the learn shape with one phase cut
            out at a time (w_*: K4b's te_pre products, all of te, its dwh
            products, its loads; d_*: K4c's dhi, te_pre and dwe products,
            ds_emb, the dh copies, and all but dhi's products): where the
            time of each goes;
  K4A_BF16  K4a in bf16 mode at the iqn path's three shapes (act B=128
            S=64; online B=1024 S=64 with h; target B=1024 S=128; A=6):
            this source's kernel (csrc/iqn_head_bf16.cu, on weights staged
            once, and with its staging pass) against the --parent
            checkout's bf16 mode of csrc/iqn_head.cu (f32 operands rounded
            at each load, TF32 mma.sync), and the f32 K4a of both, in turns
            (parent, this, this, parent), beside bf16 cuBLAS for the same
            products (three addmm on operands cast beforehand); the staging
            pass alone; and whether every f32 kernel of iqn_head.cu,
            iqn_head_bwd.cu and dqn_torso.cu (their shared header
            csrc/tf32_mma.cuh changed with this source) has the parent's
            SASS (cuobjdump, addresses and encodings dropped) instruction
            for instruction;
  K4A_BF16_PARTS K4a's bf16 kernel at the act, online and target shapes
            with one phase cut out at a time (te_pre's wgmma, forming hi,
            forming's shared-memory loads, the main wgmma, the stage
            refills, the q epilogue; te_pre with its loads alone, the main
            wgmma with its loads alone): where its
            time goes; and a ring of 3 stages in place of 4;
  K2        K2 (csrc/pooled_frame_to_84.cu) at B=128 (train; 8 rotated
            input sets, 206 MB, larger than the 50 MB L2) and B=4 (eval; 8
            sets of 0.8 MB, which stay in L2 as freshly rendered frames
            do), under a CUDA graph: the --parent source (one block per env,
            its own C interface) and this one in turns (parent, this, this,
            parent), this one at band sizes of 2, 3, 4, 6, 8 and 12 output rows,
            and a phase cut of this one at its main-path band size (the
            bulk loads only; loads and luma; the full kernel). Beside them
            `torch.maximum` of the same frames (it reads what K2 reads and
            writes one frame back: a yardstick of what HBM gives this
            traffic), and for each source its exact share against the
            plain version, whether two launches give the same bits, and its
            eager time (16 launches from the host between two events)
            beside its graph time;
  K2_PARENT the --parent source alone, as in K2 (the reading a change is
            predicted from before it is timed);
  K1        K1 against `index_select` on precomputed rows and a contiguous
            copy of the same bytes (the rate this mix of reads and writes
            reaches at best), rotating 8 index sets as chip_smoke.py does.
Needs a CUDA card and nvcc; builds into .torch_kernels/variants/.
"""

from __future__ import annotations

import collections
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from dqn_zoo_torch import kernels  # noqa: E402
from dqn_zoo_torch.nets import iqn_head as ih  # noqa: E402
from dqn_zoo_torch.nets import torso_cuda  # noqa: E402
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


def build(name: str, source: str, include=None) -> ctypes.CDLL:
  """Builds `source` as OUT/name.so; its quoted includes are found in
  `include` (this tree's csrc by default)."""
  OUT.mkdir(parents=True, exist_ok=True)
  cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
  cu.write_text(source)
  done = subprocess.run([kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-I",
                         str(include or kernels.CSRC), "-o", str(so),
                         str(cu)],
                        capture_output=True, text=True)
  if done.returncode != 0:
    raise SystemExit(f"nvcc failed on {cu}:\n{done.stdout}{done.stderr}")
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


# K3's layers, each cut out by a text substitution: in the tensor-core
# source by skipping its layer routine, in the CUDA-core one by emptying
# its loop over register tiles.
K3_CUTS = {
    "tensor_cores": {"no_conv1": ("  conv_layer<uint8_t,",
                                  "  if (false) conv_layer<uint8_t,"),
                     "no_conv2": ("  conv_layer<float, 4, 4,",
                                  "  if (false) conv_layer<float, 4, 4,"),
                     "no_conv3": ("  conv_layer<float, 3, 3,",
                                  "  if (false) conv_layer<float, 3, 3,")},
    "cuda_cores": {"no_conv1": ("item < 80 * 8;", "item < 0;"),
                   "no_conv2": ("item < 27 * 8;", "item < 0;"),
                   "no_conv3": ("item < 7 * 32;", "item < 0;")},
}


def parent_source(parent, name: str):
  """The path of the parent's csrc/`name`, where --parent gives one: the
  root of a checkout, or the source file itself."""
  if parent is None:
    return None
  if os.path.isdir(parent):
    return os.path.join(parent, "dqn_zoo_torch", "csrc", name)
  return parent if os.path.basename(parent) == name else None


def k3_parts(dev, gen, parent=None) -> None:
  sources = {"change": (kernels.CSRC / "dqn_torso.cu").read_text()}
  parent = parent_source(parent, "dqn_torso.cu")
  if parent:
    sources["parent"] = open(parent).read()
  # Each source with its own csrc/tf32_mma.cuh.
  include = dict(change=None, parent=parent and os.path.dirname(parent))
  libs = {}
  for who, src in sources.items():
    design = "tensor_cores" if "conv_layer<" in src else "cuda_cores"
    cuts = {name: [cut] for name, cut in K3_CUTS[design].items()}
    cuts["no_convs"] = [cut for (cut,) in cuts.values()]
    libs[who] = dict(design=design)
    for name in ["kernel", *cuts]:
      cut = src
      for old, new in cuts.get(name, []):
        if old not in cut:
          raise SystemExit(f"{who} {name}: {old!r} is not in the source")
        cut = cut.replace(old, new)
      lib = build(f"dqn_torso_{who}_{name}", cut, include=include[who])
      lib.dz_dqn_torso.argtypes = torso_cuda._ARGS
      lib.dz_dqn_torso.restype = ctypes.c_int
      libs[who][name] = lib
  ws = [torch.rand(shape, generator=gen, device=dev) * 0.1 - 0.05
        for shape in torso_cuda.SHAPES.values()]
  b = 1024
  x = torch.randint(0, 256, (b, 84, 84, 4), generator=gen, device=dev,
                    dtype=torch.uint8)
  out = torch.empty((b, 3136), device=dev)
  order = ["parent", "change", "change", "parent"] if parent else ["change"]
  line = dict(shape=f"B={b}", residuals=False)
  for who in order:
    times = {}
    for name, lib in libs[who].items():
      if name == "design":
        continue
      call = lambda: lib.dz_dqn_torso(
          x.data_ptr(), *(w.data_ptr() for w in ws), out.data_ptr(), None,
          None, b, 0, kernels.stream_ptr(out.device))
      if call() != 0:
        raise SystemExit(f"{who} {name}: launch failed")
      times[name] = graph_ms(call, n=5)
    line.setdefault(who, dict(design=libs[who]["design"], ms=[]))
    line[who]["ms"].append(times)
  print("K3_PARTS " + json.dumps(line), flush=True)


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


def k4c(dev, gen) -> None:
  src = (kernels.CSRC / "iqn_head_bwd.cu").read_text()
  plain = "mma_3xtf32(acc"
  if src.count(plain) != 2:
    raise SystemExit("iqn_head_bwd.cu's dhi products are not as expected")
  libs = {"kernel": bwd_build("iqn_head_bwd", src),
          "dhi_fold": bwd_build("iqn_head_bwd_dhi_fold",
                                src.replace(plain, "mma_3xtf32_rn(acc"))}
  for b, s, need_dcos in [(1024, 64, False), (128, 64, True)]:
    line = k4c_run(dev, gen, libs, b, s, need_dcos, check=True)
    print("K4C " + json.dumps(line), flush=True)


# K4c's phases, each cut out by replacing its text in the source.
K4C_CUTS = {
    "no_dh_copies": [
        ("if (q + kStages - 1 < nchunks) copy_dh(q + kStages - 1);", "")],
    "no_dhi_mma": [("mma_3xtf32(acc[j], a0b", "(void)(acc[j], a0b"),
                   ("mma_3xtf32(acc_odd[j], a1b",
                    "(void)(acc_odd[j], a1b")],
    "no_te_pre_mma": [("mma_3xtf32(tp[j], ab, as, bb, bs);", "")],
    "no_dwe_mma": [("mma_3xtf32_rn(dwe_acc[jj], ab, as, bb, bs);", "")],
    "no_ds_emb_sums": [("k < nst; k += kWarps", "k < 0; k += kWarps")],
    "no_semb_loads": [("sv[h][j] = __ldg(reinterpret_cast<const float2*>"
                       "(sp + 8 * j));", "sv[h][j] = make_float2(1.f, 1.f);")],
    "no_block_barriers": [("__syncthreads();  // step c's", "// step c's"),
                          ("__syncthreads();\n\n    // dwe +=",
                           "\n\n    // dwe +=")],
}
K4C_CUTS["fp32_pipe_split"] = [  # Veltkamp's split on the FP32 pipe
    ("split_tf32(", "split_fp32("),
    ('#include "tf32_mma.cuh"\n',
     '#include "tf32_mma.cuh"\nnamespace { __device__ __forceinline__ void '
     'split_fp32(float x, uint32_t& b, uint32_t& s) { const float c = '
     '__fmul_rn(x, 8193.f); const float h = __fsub_rn(c, __fsub_rn(c, x)); '
     'b = __float_as_uint(h); s = __float_as_uint(__fsub_rn(x, h)); } }\n')]
K4C_CUTS["no_splits"] = [  # raw bits as both parts: no split instructions
    ("split_tf32(", "split_none("),
    ('#include "tf32_mma.cuh"\n',
     '#include "tf32_mma.cuh"\nnamespace { __device__ __forceinline__ void '
     'split_none(float x, uint32_t& b, uint32_t& s) { b = s = '
     '__float_as_uint(x); } }\n')]
# Every phase but dhi's cut at once, with and without the splits.
K4C_CUTS["dhi_only"] = [cut for name in ("no_te_pre_mma", "no_dwe_mma",
                                         "no_ds_emb_sums", "no_semb_loads")
                        for cut in K4C_CUTS[name]]
K4C_CUTS["dhi_only_no_splits"] = K4C_CUTS["dhi_only"] + K4C_CUTS["no_splits"]


K4B_FOLD = "constexpr int kFold = 4;"


def k4b(dev, gen) -> None:
  src = (kernels.CSRC / "iqn_head_bwd.cu").read_text()
  if K4B_FOLD not in src:
    raise SystemExit("iqn_head_bwd.cu no longer folds dwh every 4 k-steps")
  libs = {"kernel": bwd_build("iqn_head_bwd", src)}
  for every in (1, 2, 0):
    libs[f"fold_{every}" if every else "no_fold"] = bwd_build(
        f"iqn_head_bwd_fold{every}",
        src.replace(K4B_FOLD, f"constexpr int kFold = {every};"))
  for b, s in [(1024, 64), (128, 64)]:
    print("K4B " + json.dumps(k4b_run(dev, gen, libs, b, s, check=True)),
          flush=True)


# K4b's phases, each cut out by replacing its text in the source.
K4B_CUTS = {
    "no_te_pre_mma": [("mma_3xtf32(tp[i][h], ab, as, bb[h], bs[h]);", "")],
    "no_dwh_mma": [("mma_3xtf32(kFold ? pend[i][n] : acc[i][n], ab[i], "
                    "as[i], bb, bs);", ";")],
    "no_dh_copies": [
        ("if (q + kWStages - 1 < nchunks) copy_dh(q + kWStages - 1);", "")],
    "no_splits": K4C_CUTS["no_splits"],
    "no_fold": [(K4B_FOLD, "constexpr int kFold = 0;")],
    "no_block_barrier": [("__syncthreads();  // the step's hi is in",
                          "// the step's hi is in")],
}


def k4b_parts(dev, gen) -> None:
  src = (kernels.CSRC / "iqn_head_bwd.cu").read_text()
  libs = {"kernel": bwd_build("iqn_head_bwd", src)}
  for name, cuts in K4B_CUTS.items():
    cut = src
    for old, new in cuts:
      if old not in cut:
        raise SystemExit(f"{name}: {old!r} is no longer in iqn_head_bwd.cu")
      cut = cut.replace(old, new)
    libs[name] = bwd_build(f"iqn_head_bwd_w_{name}", cut)
  print("K4B_PARTS " + json.dumps(k4b_run(dev, gen, libs, 1024, 64,
                                          check=False)), flush=True)


def k4b_run(dev, gen, libs, b, s, check):
  """One timing (and, with `check`, the errors against the plain version)
  per library in `libs`; returns the line."""
  n = lambda *shape: torch.randn(shape, generator=gen, device=dev)
  d = 3136
  we, be = n(64, d) * 0.05, n(d) * 0.05
  cos_emb, s_emb = n(b, s, 64), torch.relu(n(b, d))
  dh = n(b * s, 512) * 0.05 * (n(b * s, 512) > 0)
  groups = ih.row_groups(b, s)
  out = torch.empty(d * 512 + 512, device=dev)
  part = torch.empty((groups, d * 512 + 512), device=dev) if groups > 1 \
      else None
  want = ih.iqn_head_bwd_w_plain(we, be, cos_emb, s_emb, dh) if check \
      else None
  line = dict(shape=f"B={b} S={s}", groups=groups)
  for name, lib in libs.items():
    def call():
      if lib.dz_iqn_head_bwd_w(
          cos_emb.data_ptr(), s_emb.data_ptr(), dh.data_ptr(),
          we.data_ptr(), be.data_ptr(), out.data_ptr(),
          None if part is None else part.data_ptr(), b, s, d, groups,
          kernels.stream_ptr(out.device)) != 0:
        raise SystemExit(f"{name}: launch failed")
    call()
    torch.cuda.synchronize()
    line[name] = dict(ms=graph_ms(call, n=5 if b == 1024 else 20))
    if check:
      got = (out[:d * 512].view(d, 512), out[d * 512:])
      for o, g, w in zip(("dwh", "dbh"), got, want):
        line[name][o] = error_shares(g, w)
  return line


def error_shares(got, want) -> dict:
  """The relative Frobenius error and the largest elementwise error as
  shares of chip_smoke.py's tolerances."""
  fro = float(torch.linalg.vector_norm(got - want)
              / torch.linalg.vector_norm(want))
  elem = float(((got - want).abs() / (1e-5 * want.abs().max()
                                      + 1e-4 * want.abs())).max())
  return dict(frobenius_share_of_tolerance=fro / 1e-4,
              elementwise_share_of_tolerance=elem)



def bwd_build(name: str, src: str, include=None) -> ctypes.CDLL:
  """A variant of iqn_head_bwd.cu, with K4b's and K4c's entries typed."""
  lib = build(name, src, include=include)
  for kernel in (ih.BWD_W, ih.BWD_D):
    getattr(lib, kernel.symbol).argtypes = kernel.argtypes
    getattr(lib, kernel.symbol).restype = ctypes.c_int
  return lib


def k4c_parts(dev, gen) -> None:
  src = (kernels.CSRC / "iqn_head_bwd.cu").read_text()
  libs = {"kernel": bwd_build("iqn_head_bwd", src)}
  for name, cuts in K4C_CUTS.items():
    cut = src
    for old, new in cuts:
      if old not in cut:
        raise SystemExit(f"{name}: {old!r} is no longer in iqn_head_bwd.cu")
      cut = cut.replace(old, new)
    libs[name] = bwd_build(f"iqn_head_bwd_{name}", cut)
  line = k4c_run(dev, gen, libs, 1024, 64, False, check=False)
  print("K4C_PARTS " + json.dumps(line), flush=True)


def k4c_sass(dev, gen) -> None:
  """Instruction counts of K4c's loops that issue `mma` (SASS by cuobjdump
  next to nvcc): per loop body, its instructions and its HMMA."""
  del dev, gen
  lib = OUT / "iqn_head_bwd.so"
  bwd_build("iqn_head_bwd", (kernels.CSRC / "iqn_head_bwd.cu").read_text())
  tool = os.path.join(os.path.dirname(kernels.find_nvcc()), "cuobjdump")
  sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                        text=True, check=True).stdout
  body = [f for f in re.split(r"\n\s*Function : ", sass)
          if "iqn_head_bwd_d_kernel" in f.split("\n", 1)[0]][0]
  op_re = r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)"
  ins = [(int(a, 16), op) for a, op in re.findall(op_re, body)]
  loops = []
  for m in re.finditer(r"/\*([0-9a-f]{4,})\*/[^\n]*BRA[^\n]*?(0x[0-9a-f]+)",
                       body):
    end, start = int(m.group(1), 16), int(m.group(2), 16)
    ops = [op for a, op in ins if start <= a <= end]
    if start < end and "HMMA" in ops:
      loops.append(dict(instructions=len(ops), hmma=ops.count("HMMA"),
                        most=collections.Counter(ops).most_common(8)))
  print("K4C_SASS " + json.dumps(dict(kernel_instructions=len(ins),
                                      loops=loops)), flush=True)


def k4c_run(dev, gen, libs, b, s, need_dcos, check):
  """One timing (and, with `check`, the errors against the plain version)
  per library in `libs`; returns the line."""
  n = lambda *shape: torch.randn(shape, generator=gen, device=dev)
  d = 3136
  we, be, wh = n(64, d) * 0.05, n(d) * 0.05, n(d, 512) * 0.015
  cos_emb, s_emb = n(b, s, 64), torch.relu(n(b, d))
  dh = n(b * s, 512) * 0.05 * (n(b * s, 512) > 0)
  groups = ih.row_groups(b, s)
  out = torch.empty(64 * d + d, device=dev)
  part = torch.empty((groups, 64 * d + d), device=dev) if groups > 1 \
      else None
  ds_emb = torch.empty((b, d), device=dev)
  dcos = torch.empty((b, s, 64), device=dev) if need_dcos else None
  dcos_part = torch.empty((d // 32, b * s, 64), device=dev) \
      if need_dcos else None
  mask = torch.empty((b * s, d), dtype=torch.uint8, device=dev)
  ptr = lambda x: None if x is None else x.data_ptr()
  line = dict(shape=f"B={b} S={s}", groups=groups, dcos=need_dcos)
  for name, lib in libs.items():
    def call(m=None):
      if lib.dz_iqn_head_bwd_d(
          cos_emb.data_ptr(), s_emb.data_ptr(), dh.data_ptr(),
          we.data_ptr(), be.data_ptr(), wh.data_ptr(), out.data_ptr(),
          ptr(part), ds_emb.data_ptr(), ptr(dcos), ptr(dcos_part), ptr(m),
          b, s, d, groups, kernels.stream_ptr(out.device)) != 0:
        raise SystemExit(f"{name}: launch failed")
    call(mask)
    torch.cuda.synchronize()
    if not check:
      line[name] = dict(ms=graph_ms(call, n=5))
      continue
    got = [out[:64 * d].view(64, d).clone(), out[64 * d:].clone(),
           ds_emb.clone()] + ([dcos.clone()] if need_dcos else [])
    want = ih.iqn_head_bwd_d_plain(we, be, wh, cos_emb, s_emb, dh,
                                   need_dcos=need_dcos, te_mask=mask)
    errs = {o: error_shares(g, w)
            for o, g, w in zip(("dwe", "dbe", "ds_emb", "dcos"), got, want)}
    line[name] = dict(ms=graph_ms(call, n=5 if b == 1024 else 20), **errs)
    del got, want
  return line


def _bf16_head(dev, gen, b, s):
  """The bf16 backward kernels' inputs at (b, s), made as chip_smoke.py
  makes them, and their staging."""
  n = lambda *shape: torch.randn(shape, generator=gen, device=dev)
  d = 3136
  we, be, wh = n(64, d) * 0.05, n(d) * 0.05, n(d, 512) * 0.015
  cos_emb, s_emb = n(b, s, 64), torch.relu(n(b, d))
  dh = (n(b * s, 512) * 0.05 * (n(b * s, 512) > 0)).contiguous()
  return (we, be, wh, cos_emb, s_emb, dh,
          ih.iqn_head_stage_bf16(we, cos_emb, dh, wh))


def _sass(lib_path, kernel: str):
  """The SASS instructions of the function whose name holds `kernel` and not
  `ILb1E` (a `<true>` instantiation of a template, such as the parent's
  bf16 mode), by cuobjdump, addresses and encodings dropped."""
  tool = os.path.join(os.path.dirname(kernels.find_nvcc()), "cuobjdump")
  sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                        text=True, check=True).stdout
  body = [f for f in re.split(r"\n\s*Function : ", sass)
          if kernel in f.split("\n", 1)[0]
          and "ILb1E" not in f.split("\n", 1)[0]]
  if len(body) != 1:
    raise SystemExit(f"{kernel}: {len(body)} functions in {lib_path}")
  return re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)", body[0])


def k4_bf16(dev, gen, parent=None) -> None:
  """K4b and K4c in bf16 mode: this source's kernels (csrc/
  iqn_head_bwd_bf16.cu, on staged operands; the staging pass timed apart)
  against the --parent checkout's bf16 mode of csrc/iqn_head_bwd.cu (f32
  operands rounded at each load, TF32 mma), and the f32 K4b and K4c of both,
  in turns (parent, this, this, parent) at the learn shape; and whether the
  f32 kernels' SASS is the parent's."""
  src = parent_source(parent, "iqn_head_bwd.cu")
  if src is None:
    raise SystemExit("k4_bf16 needs --parent (a checkout root)")
  plib = bwd_build("parent_iqn_head_bwd", open(src).read(),
                   include=os.path.dirname(src))
  for name in ("dz_iqn_head_bwd_w_bf16", "dz_iqn_head_bwd_d_bf16"):
    f32 = ih.BWD_W if name.endswith("w_bf16") else ih.BWD_D
    getattr(plib, name).argtypes = f32.argtypes
    getattr(plib, name).restype = ctypes.c_int
  b, s, d = 1024, 64, 3136
  we, be, wh, cos_emb, s_emb, dh, st = _bf16_head(dev, gen, b, s)
  groups = ih.row_groups(b, s)
  out_w = torch.empty(d * 512 + 512, device=dev)
  part_w = torch.empty((groups, d * 512 + 512), device=dev)
  out_d = torch.empty(64 * d + d, device=dev)
  part_d = torch.empty((groups, 64 * d + d), device=dev)
  ds_emb = torch.empty((b, d), device=dev)

  def parent_w(entry):
    if getattr(plib, entry)(
        cos_emb.data_ptr(), s_emb.data_ptr(), dh.data_ptr(), we.data_ptr(),
        be.data_ptr(), out_w.data_ptr(), part_w.data_ptr(), b, s, d, groups,
        kernels.stream_ptr(dev)) != 0:
      raise SystemExit(f"parent {entry} failed")

  def parent_d(entry):
    if getattr(plib, entry)(
        cos_emb.data_ptr(), s_emb.data_ptr(), dh.data_ptr(), we.data_ptr(),
        be.data_ptr(), wh.data_ptr(), out_d.data_ptr(), part_d.data_ptr(),
        ds_emb.data_ptr(), None, None, None, b, s, d, groups,
        kernels.stream_ptr(dev)) != 0:
      raise SystemExit(f"parent {entry} failed")

  bf = torch.bfloat16
  runs = {
      "k4b_bf16": (lambda: parent_w("dz_iqn_head_bwd_w_bf16"),
                   lambda: ih.iqn_head_bwd_w(we, be, cos_emb, s_emb, dh,
                                             mm=bf, staged=st)),
      "k4c_bf16": (lambda: parent_d("dz_iqn_head_bwd_d_bf16"),
                   lambda: ih.iqn_head_bwd_d(we, be, wh, cos_emb, s_emb, dh,
                                             need_dcos=False, mm=bf,
                                             staged=st)),
      "k4b_f32": (lambda: parent_w("dz_iqn_head_bwd_w"),
                  lambda: ih.iqn_head_bwd_w(we, be, cos_emb, s_emb, dh)),
      "k4c_f32": (lambda: parent_d("dz_iqn_head_bwd_d"),
                  lambda: ih.iqn_head_bwd_d(we, be, wh, cos_emb, s_emb, dh,
                                            need_dcos=False)),
  }
  line = dict(shape=f"B={b} S={s}")
  for name, (par, this) in runs.items():
    order = [("parent", par), ("this", this), ("this", this),
             ("parent", par)]
    got = collections.defaultdict(list)
    for who, fn in order:
      got[who].append(graph_ms(fn, n=5))
    line[name] = dict(got)
  line["stage_bf16_ms"] = graph_ms(
      lambda: ih.iqn_head_stage_bf16(we, cos_emb, dh, wh), n=5)
  kernels.load("iqn_head_bwd.cu")
  this_lib = kernels._lib_path("iqn_head_bwd.cu")
  for kernel in ("iqn_head_bwd_w_kernel", "iqn_head_bwd_d_kernel"):
    mine = _sass(this_lib, kernel)
    theirs = _sass(OUT / "parent_iqn_head_bwd.so", kernel)
    line[f"{kernel}_sass"] = dict(
        instructions=len(mine), parent_instructions=len(theirs),
        identical=mine == theirs,
        differing=sum(a != b for a, b in zip(mine, theirs)))
  print("K4_BF16 " + json.dumps(line), flush=True)


# The bf16 kernels' phases, each cut out by replacing its text in
# csrc/iqn_head_bwd_bf16.cu (the outputs are then wrong; only the time
# counts).
K4_BF16_CUTS = {
    "w_no_te_mma": [("mma_bf16(tp[2 * pp], afr[ks], b[0], b[1]);\n"
                     "          mma_bf16(tp[2 * pp + 1], afr[ks], b[2], "
                     "b[3]);", "")],
    "w_no_te": [("if (k + 1 < nsteps) te(k + 1, next);", "")],
    "w_no_dwh_mma": [("wgmma_256(acc, a[kk], desc_sw128(dhb + kk * 16 * 128, "
                      "kRC * 128, 1024));", ";")],
    "w_no_loads": [("if (k + kWStages - 1 < nsteps) load_chunk(k + kWStages "
                    "- 1);", "")],
    "d_no_dhi_mma": [("        wgmma_64_ss(acc,\n",
                      "        if (false) wgmma_64_ss(acc,\n")],
    "d_no_te_pre_mma": [("          wgmma_64_ss(tp, desc_sw128(cosb",
                         "          if (false) wgmma_64_ss(tp, "
                         "desc_sw128(cosb")],
    "d_no_dwe_mma": [("mma_bf16(dwe_acc[i][2 * p], a[i], b[p][0], "
                      "b[p][1]);\n          mma_bf16(dwe_acc[i][2 * p + 1], "
                      "a[i], b[p][2], b[p][3]);", "")],
    "d_no_ds_emb": [("slice_sums(st0 * s, st0 * s + s, v);", ""),
                    ("for (int st = w0 / s; w0 < w1 && st <= (w1 - 1) / s; "
                     "++st) {", "for (int st = 0; st < 0; ++st) {")],
    "d_no_dh_copies": [("if (q + kDStages - 1 < nq) copy_dh(q + kDStages - "
                        "1);", "")],
}
K4_BF16_CUTS["d_dhi_only"] = [cut for name in (
    "d_no_te_pre_mma", "d_no_dwe_mma", "d_no_ds_emb") for cut in
                              K4_BF16_CUTS[name]]
K4_BF16_CUTS["d_dhi_mma_only"] = K4_BF16_CUTS["d_dhi_only"] + \
    K4_BF16_CUTS["d_no_dh_copies"]


def _ok(name: str, err: int) -> None:
  if err != 0:
    raise SystemExit(f"{name}: launch failed with error {err}")


def k4_bf16_parts(dev, gen) -> None:
  """K4b and K4c in bf16 mode at the learn shape with one phase cut out at a
  time (w_*: K4b's, d_*: K4c's; no dcos): where their time goes."""
  src = (kernels.CSRC / "iqn_head_bwd_bf16.cu").read_text()
  b, s, d = 1024, 64, 3136
  we, be, wh, cos_emb, s_emb, dh, st = _bf16_head(dev, gen, b, s)
  gw, gd = ih.bf16_groups_w(b, s, d), ih.bf16_groups_d(b, s, d)
  out_w = torch.empty((gw, d, 512), device=dev)
  out_d = torch.empty((gd, 64 * d + d), device=dev)
  ds_emb = torch.empty((b, d), device=dev)
  variants = {"kernel": src}
  for name, cuts in K4_BF16_CUTS.items():
    cut = src
    for old, new in cuts:
      if old not in cut:
        raise SystemExit(f"{name}: {old!r} is no longer in "
                         "iqn_head_bwd_bf16.cu")
      cut = cut.replace(old, new)
    variants[name] = cut
  line = dict(shape=f"B={b} S={s}", groups_w=gw, groups_d=gd)
  for name, text in variants.items():
    lib = build(f"iqn_head_bwd_bf16_{name}", text)
    for kernel in (ih.BWD_W_BF16, ih.BWD_D_BF16):
      getattr(lib, kernel.symbol).argtypes = kernel.argtypes
      getattr(lib, kernel.symbol).restype = ctypes.c_int
    # out doubles as the groups' partials (the sum of group partials reads
    # each element before it writes it), so the time includes that sum.
    w = lambda: _ok(name, lib.dz_iqn_head_bwd_w_bf16(
        st.cos.data_ptr(), s_emb.data_ptr(), st.dh.data_ptr(),
        st.we_t.data_ptr(), be.data_ptr(), out_w.data_ptr(),
        out_w.data_ptr(), b, s, d, gw, kernels.stream_ptr(dev)))
    dd = lambda: _ok(name, lib.dz_iqn_head_bwd_d_bf16(
        st.cos.data_ptr(), s_emb.data_ptr(), st.dh.data_ptr(),
        st.we_t.data_ptr(), be.data_ptr(), st.wh.data_ptr(),
        out_d.data_ptr(), out_d.data_ptr(), ds_emb.data_ptr(), None, None,
        None, b, s, d, gd, kernels.stream_ptr(dev)))
    line[name] = dict(w_ms=graph_ms(w, n=5), d_ms=graph_ms(dd, n=5))
  print("K4_BF16_PARTS " + json.dumps(line), flush=True)


def _sass_functions(lib_path) -> dict:
  """{mangled name without its anonymous namespace: SASS instructions} of
  every function in a library, by cuobjdump, addresses and encodings
  dropped."""
  tool = os.path.join(os.path.dirname(kernels.find_nvcc()), "cuobjdump")
  sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                        text=True, check=True).stdout
  out = {}
  for f in re.split(r"\n\s*Function : ", sass)[1:]:
    name = re.sub(r"_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "_ZN",
                  f.split("\n", 1)[0].strip())
    out[name] = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)", f)
  return out


def _f32_sass_against(parent_root) -> dict:
  """Whether each f32 kernel of iqn_head.cu, iqn_head_bwd.cu and
  dqn_torso.cu, built from this tree and from the parent's (each with its
  own csrc/tf32_mma.cuh), is the same SASS. The parent's K4a kernels carry
  a second template flag, bf16 mode, whose false instantiations are the
  ones compared."""
  pcsrc = os.path.join(parent_root, "dqn_zoo_torch", "csrc")
  out = {}
  for source in ("iqn_head.cu", "iqn_head_bwd.cu", "dqn_torso.cu"):
    kernels.build_all([source])
    mine = _sass_functions(kernels._lib_path(source))
    build(f"parent_{source[:-3]}", open(os.path.join(pcsrc, source)).read(),
          include=pcsrc)
    theirs = {}
    for name, body in _sass_functions(
        OUT / f"parent_{source[:-3]}.so").items():
      if source == "iqn_head.cu":
        if "ELb1EE" in name:
          continue  # the bf16 mode this tree moved to iqn_head_bf16.cu
        name = name.replace("ELb0EE", "EE")
      theirs[name] = body
    for name, body in mine.items():
      other = theirs.get(name)
      out[f"{source}:{name}"] = dict(
          instructions=len(body),
          parent_instructions=None if other is None else len(other),
          identical=other == body)
  return out


def _head_args(dev, gen, b, s, a=6):
  n = lambda *shape: torch.randn(shape, generator=gen, device=dev)
  return (n(64, 3136) * 0.05, n(3136) * 0.05, n(3136, 512) * 0.015,
          n(512) * 0.05, n(512, a) * 0.05, n(a) * 0.05, n(b, s, 64),
          torch.relu(n(b, 3136)))


# K4a's bf16 path shapes: (B, S, residuals, role).
K4A_BF16_SHAPES = ((128, 64, False, "act"), (1024, 64, True, "online"),
                   (1024, 128, False, "target"))


def k4a_bf16(dev, gen, parent=None) -> None:
  """K4a in bf16 mode at the iqn path's shapes: this source's kernel (on
  staged weights, and with its staging pass) against the --parent
  checkout's bf16 mode of csrc/iqn_head.cu, and the f32 K4a of both, in
  turns; bf16 cuBLAS beside; the f32 kernels' SASS against the parent's."""
  if parent is None or not os.path.isdir(parent):
    raise SystemExit("k4a_bf16 needs --parent (a checkout root)")
  pcsrc = os.path.join(parent, "dqn_zoo_torch", "csrc")
  plib = build("parent_iqn_head_k4a", open(os.path.join(
      pcsrc, "iqn_head.cu")).read(), include=pcsrc)
  for name in ("dz_iqn_head", "dz_iqn_head_bf16"):
    getattr(plib, name).argtypes = ih._ARGS
    getattr(plib, name).restype = ctypes.c_int
  bf = torch.bfloat16
  for b, s, res, role in K4A_BF16_SHAPES:
    args = _head_args(dev, gen, b, s)
    we, be, wh, bh, wo, bo, cos_emb, s_emb = args
    a, d = 6, 3136
    q = torch.empty((b, s, a), device=dev)
    h = torch.empty((b * s, 512), device=dev) if res else None
    splits = ih.d_splits(b, s)
    part = torch.empty((splits, b * s, 512), device=dev) if splits > 1 \
        else None

    def parent_call(entry):
      ptrs = [t.data_ptr() for t in (cos_emb, s_emb, we, be, wh, bh, wo, bo)]
      _ok(entry, getattr(plib, entry)(
          *ptrs, q.data_ptr(), None if h is None else h.data_ptr(),
          None if part is None else part.data_ptr(), b, s, d, a, int(res),
          splits, ih.chunks_per_split(splits), kernels.stream_ptr(dev)))

    st = ih.iqn_head_stage_fwd_bf16(we, be, wh)
    lib_args = [t.to(bf) for t in (we, be, wh, bh, wo, bo,
                                   cos_emb.reshape(b * s, -1), s_emb)]

    def library():
      lw, lbe, lwh, lbh, lwo, lbo, lcos, lse = lib_args
      te = torch.addmm(lbe, lcos, lw).relu_()
      hi = (te.view(b, s, -1) * lse[:, None, :]).view(b * s, -1)
      return torch.addmm(lbo, torch.addmm(lbh, hi, lwh).relu_(), lwo)

    runs = {
        "bf16": (lambda: parent_call("dz_iqn_head_bf16"),
                 lambda: ih.iqn_head_forward(*args, residuals=res, mm=bf,
                                             staged=st)),
        "bf16_with_staging": (lambda: parent_call("dz_iqn_head_bf16"),
                              lambda: ih.iqn_head_forward(
                                  *args, residuals=res, mm=bf)),
        "f32": (lambda: parent_call("dz_iqn_head"),
                lambda: ih.iqn_head_forward(*args, residuals=res)),
    }
    it = 5 if b == 1024 else 20
    line = dict(shape=f"B={b} S={s} A={a}", role=role, residuals=res)
    for name, (par, this) in runs.items():
      got = collections.defaultdict(list)
      for who, fn in (("parent", par), ("this", this), ("this", this),
                      ("parent", par)):
        got[who].append(graph_ms(fn, n=it))
      line[name] = dict(got)
    line["stage_ms"] = graph_ms(
        lambda: ih.iqn_head_stage_fwd_bf16(we, be, wh), n=20)
    line["bf16_cublas_ms"] = graph_ms(library, n=it)
    print("K4A_BF16 " + json.dumps(line), flush=True)
    del args, q, h, part, st, lib_args
  print("K4A_BF16_SASS " + json.dumps(_f32_sass_against(parent)), flush=True)


# K4a's bf16 kernel's phases, each cut out by replacing its text in
# csrc/iqn_head_bf16.cu (the outputs are then wrong; only the time counts).
# Cutting the refills also cuts the waits on chunks past the first ring.
K4A_BF16_CUTS = {
    "no_te_mma": [("      wgmma_64_ss(tp, desc_sw128(cb + 32 * ks",
                   "      if (false) wgmma_64_ss(tp, desc_sw128(cb + 32 * ks")],
    "no_form": [("    if constexpr (kNext) form(k + 1, nxt);", "")],
    "no_main_mma": [("      wgmma_256(acc, x[kk], desc_sw128(whb",
                     "      if (false) wgmma_256(acc, x[kk], desc_sw128(whb")],
    "no_refills": [("if (tid == 0 && k >= 1 && k - 1 + kStages < n) "
                    "issue(k - 1 + kStages);", ""),
                   ("      mbar_wait(bar_s + 8 * ((k + 1) % kStages), "
                    "((k + 1) / kStages) & 1);",
                    "      if (k + 1 < kStages) mbar_wait(bar_s + 8 * "
                    "((k + 1) % kStages), ((k + 1) / kStages) & 1);")],
    "no_q_epilogue": [("  for (int o0 = 0; o0 < a; o0 += 8 * kQT) {",
                       "  for (int o0 = 0; o0 < 0; o0 += 8 * kQT) {")],
    # Forming hi without its shared-memory loads of be and s_emb.
    "form_no_smem": [("        const float2 b = *reinterpret_cast<const "
                      "float2*>(bes + col);\n        const float2 sv",
                      "        const float2 b = make_float2(0.f, 0.f);\n"
                      "        const float2 sv"),
                     ("        const float2 sv = *reinterpret_cast<const "
                      "float2*>(ses + col);", "        const float2 sv = "
                      "make_float2(1.f, 1.f);")],
}
K4A_BF16_CUTS["te_and_loads_only"] = K4A_BF16_CUTS["no_form"] + \
    K4A_BF16_CUTS["no_main_mma"]
K4A_BF16_CUTS["main_and_loads_only"] = K4A_BF16_CUTS["no_form"] + \
    K4A_BF16_CUTS["no_te_mma"]
# A variant that keeps the outputs right: a ring of 3 stages.
K4A_BF16_CUTS["stages_3"] = [("constexpr int kStages = 4;",
                              "constexpr int kStages = 3;")]


def k4a_bf16_parts(dev, gen) -> None:
  """K4a's bf16 kernel at its three path shapes with one phase cut out at a
  time, and its variants: where its time goes."""
  src = (kernels.CSRC / "iqn_head_bf16.cu").read_text()
  variants = {"kernel": src}
  for name, cuts in K4A_BF16_CUTS.items():
    cut = src
    for old, new in cuts:
      if old not in cut:
        raise SystemExit(f"{name}: {old!r} is no longer in iqn_head_bf16.cu")
      cut = cut.replace(old, new)
    variants[name] = cut
  inputs = {}
  for b, s, res, role in K4A_BF16_SHAPES:
    args = _head_args(dev, gen, b, s)
    st = ih.iqn_head_stage_fwd_bf16(*args[:3])
    q = torch.empty((b, s, 6), device=dev)
    h = torch.empty((b * s, 512), device=dev)
    qpart = torch.empty((2, b * s, 6), device=dev)
    inputs[role] = (b, s, res, args, st, q, h, qpart)
  line = {}
  for name, text in variants.items():
    lib = build(f"iqn_head_bf16_{name}", text)
    fn = getattr(lib, ih.FWD_BF16.symbol)
    fn.argtypes, fn.restype = ih.FWD_BF16.argtypes, ctypes.c_int
    line[name] = {}
    for role, (b, s, res, args, st, q, h, qpart) in inputs.items():
      call = lambda: _ok(name, fn(
          args[6].data_ptr(), args[7].data_ptr(), st.data_ptr(),
          args[3].data_ptr(), args[4].data_ptr(), args[5].data_ptr(),
          q.data_ptr(), h.data_ptr(), None, qpart.data_ptr(), b, s, 3136, 6,
          int(res), 1, ih.bf16_fwd_chunks_per_split(1),
          kernels.stream_ptr(dev)))
      line[name][f"{role}_ms"] = graph_ms(call, n=5 if b == 1024 else 20)
  print("K4A_BF16_PARTS " + json.dumps(line), flush=True)


# K2's phases, each cut by a text substitution after its block barrier (the
# outputs are then wrong; only the time counts).
K2_CUTS = {
    "loads": ("  mbar_wait(&bar, 0);\n", "  mbar_wait(&bar, 0);\n  return;\n"),
    "loads_luma": ("  __syncthreads();\n\n  // Vertical pass",
                   "  __syncthreads();\n  return;\n\n  // Vertical pass"),
}
K2_BAND_ROWS = (2, 3, 4, 6, 8, 12)


def eager_ms(fn, n: int) -> float:
  """Device milliseconds per call of `n` calls launched one after another
  from the host (its launch cost included), after 3 warm-ups."""
  for _ in range(3):
    fn()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(n):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / n


def k2(dev, gen, parent=None, parent_only=False) -> None:
  """K2 as above; with `parent_only` the --parent source alone (its exact
  share, repeat bits, eager and graph times at both shapes): the reading a
  change is predicted from before it is timed."""
  from dqn_zoo_torch.prep import atari as tprep
  from dqn_zoo_torch.prep import cuda_prep

  parent = parent_source(parent, "pooled_frame_to_84.cu")
  if parent_only and not parent:
    raise SystemExit("k2_parent needs --parent")
  versions = {}
  if parent:
    lib = build("pooled_frame_to_84_parent", open(parent).read())
    # The parent's interface: both resize matrices and each row's nonzero
    # run [first, last + 1).
    mats = [tprep.resize_weights(n, 84) for n in (210, 160)]
    runs = []
    for w in mats:
      first, count, _ = cuda_prep.tap_table(w)
      runs.append(np.stack([first, first + count], 1).astype(np.int32))
    args = [torch.from_numpy(a).to(dev) for a in mats + runs]

    def run_parent(f1, f2):
      out = torch.empty((f1.shape[0], 84, 84), dtype=torch.uint8, device=dev)
      err = lib.dz_pooled_frame_to_84(
          ctypes.c_void_p(f1.data_ptr()), ctypes.c_void_p(f2.data_ptr()),
          *(ctypes.c_void_p(t.data_ptr()) for t in args),
          ctypes.c_void_p(out.data_ptr()), ctypes.c_int(f1.shape[0]),
          ctypes.c_void_p(kernels.stream_ptr(dev)))
      if err:
        raise SystemExit(f"parent K2 launch failed: {err}")
      return out
    versions["parent"] = run_parent
  if not parent_only:
    versions["change"] = cuda_prep.pooled_frame_to_84

  def entry(lib):
    fn = lib.dz_pooled_frame_to_84
    fn.argtypes = cuda_prep.KERNEL.argtypes

    def call(*args):
      if fn(*args):
        raise SystemExit("K2 variant launch failed")
    return call

  cuts = {}
  if not parent_only:
    src = (kernels.CSRC / "pooled_frame_to_84.cu").read_text()
    for name, (old, new) in K2_CUTS.items():
      if old not in src:
        raise SystemExit(f"k2 {name}: {old!r} is not in the source")
      cuts[name] = entry(build(f"pooled_frame_to_84_{name}",
                               src.replace(old, new)))
    cuts["full"] = cuda_prep.KERNEL.launch

  for b in (128, 4):
    sets = []
    for _ in range(8):
      f1 = torch.randint(0, 256, (b, 210, 160, 3), generator=gen, device=dev,
                         dtype=torch.uint8)
      f2 = torch.randint(0, 256, (b, 210, 160, 3), generator=gen, device=dev,
                         dtype=torch.uint8)
      f1[0] = 0
      sets.append((f1, f2))
    turn = [0]

    def rotating(fn):
      def call():
        fn(*sets[turn[0] % len(sets)])
        turn[0] += 1
      return call

    n = 2 * len(sets)
    line = dict(shape=f"B={b}", inputs_mb=16 * b * 100800 / 1e6,
                band_rows=cuda_prep.BAND_ROWS)
    want = [tprep.pooled_frame_to_84_plain(*fs) for fs in sets]
    for who, fn in versions.items():
      got = [fn(*fs) for fs in sets]
      diff = torch.cat([(g.int() - w.int()).abs() for g, w in zip(got, want)])
      line[who] = dict(
          exact_share=float((diff == 0).float().mean()),
          differing_pixels=int((diff != 0).sum()),
          max_abs_diff=int(diff.max()),
          bit_identical_repeat=all(torch.equal(g, fn(*fs))
                                   for g, fs in zip(got, sets)),
          graph_ms=[], eager_ms=[])
    order = ["parent", "change", "change", "parent"] if len(versions) == 2 \
        else list(versions) * 2
    for who in order:
      line[who]["graph_ms"].append(graph_ms(rotating(versions[who]), n=n))
      line[who]["eager_ms"].append(eager_ms(rotating(versions[who]), n=n))
    if not parent_only:
      for r in K2_BAND_ROWS:
        line.setdefault("band_rows_ms", {})[r] = graph_ms(rotating(
            lambda f1, f2: cuda_prep.launch(f1, f2, r,
                                            cuda_prep.KERNEL.launch)), n=n)
      for name, call in cuts.items():
        line.setdefault("phase_ms", {})[name] = graph_ms(rotating(
            lambda f1, f2: cuda_prep.launch(f1, f2, cuda_prep.BAND_ROWS,
                                            call)), n=n)
    pooled = torch.empty_like(sets[0][0])
    line["max_of_frames_ms"] = graph_ms(rotating(
        lambda f1, f2: torch.maximum(f1, f2, out=pooled)), n=n)
    print("K2 " + json.dumps(line), flush=True)
    del sets, want


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
  parent = [a.split("=", 1)[1] for a in sys.argv[1:]
            if a.startswith("--parent=")]
  names = [a for a in sys.argv[1:] if not a.startswith("--")]
  checks = dict(mma_peak=lambda: print(
      "MMA_PEAK " + json.dumps(mma_peak(dev)), flush=True),
                k3_parts=lambda: k3_parts(dev, gen, *parent),
                k4a=lambda: k4a(dev, gen), k4b=lambda: k4b(dev, gen),
                k4b_parts=lambda: k4b_parts(dev, gen),
                k4c=lambda: k4c(dev, gen),
                k4c_parts=lambda: k4c_parts(dev, gen),
                k4c_sass=lambda: k4c_sass(dev, gen),
                k4_bf16=lambda: k4_bf16(dev, gen, *parent),
                k4_bf16_parts=lambda: k4_bf16_parts(dev, gen),
                k4a_bf16=lambda: k4a_bf16(dev, gen, *parent),
                k4a_bf16_parts=lambda: k4a_bf16_parts(dev, gen),
                k2=lambda: k2(dev, gen, *parent),
                k2_parent=lambda: k2(dev, gen, *parent, parent_only=True),
                k1=lambda: k1(dev, gen))
  for name in names or [c for c in checks
                        if c not in ("k2_parent", "k4_bf16", "k4a_bf16")]:
    checks[name]()
  return 0


if __name__ == "__main__":
  sys.exit(main())
