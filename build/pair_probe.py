#!/usr/bin/env python3
"""The floors of the bf16 FFN kernel (K1 and K2) on the card, beside the
kernel itself: its one-block forms (H = 128, 256, 384, 512 and 640) and
its cluster-pair forms (H = 896, 1,024, 1,152, 1,280, 1,408 and 1,536),
F = 4H.

    python3 build/pair_probe.py [--csrc DIR] [--out DIR] [--widths H ...]
                                [--rows M ...] [--variants V ...] [--trace]
                                [--build-only] [--check-only] [--no-ncu]

From `csrc/ffn_ln.cuh` (or DIR's) it builds one small library per width
and variant, all nvccs at once, into `build/pair_probe/` (or --out):

- `kernel`: the header as it is, the kernel kernels/build.py builds;
- `stream`: the weight stream alone: every W1 and W2 tile goes through
  its ring by TMA, and the consumers wait for it and release it, with no
  product, GELU or LayerNorm;
- `stage1`: stage 1 alone: no W2 tile is loaded, and stage 2 only
  releases each chunk stage 1 hands it;
- `fixed` (one-block forms): a tile with no chunk: the prologue (x, LN0
  for K1), the rings' first fill, LN2 of zero products and the store;
- `trace` (with --trace): the kernel with the clock of each step of every
  chunk in one row tile (both blocks of a pair).

The variants are written into a copy of the header (`PATCHES`, each
anchored on text that must occur once in it) under MRD_FFN_PROBE 1, 2, 3
and 4,
which only this script defines; the header the package builds holds none
of them.

For each width it first holds the kernel variant's K1 and K2 against the
package's plain version (`ffn_ln_plain`, bf16 products with f32 sums on
the card) at each M, with the slices of F that `kernels/ffn.py::ffn_plan`
gives, within chip_smoke.py's bf16 limits (5e-2 max, 1e-4 mean). Then at
each M (default 16,384) it prints K1's (f32 vectors) and K2's device time
per call of each variant, with the plan's slices, taken in turns (the
variants, then the same in reverse; CUDA events over 20 calls queued
behind a spinning card), the W1 + W2 bytes the blocks read from L2 per
call (each block reads every tile of its column group) and those bytes
over each time; then `cudaOccupancyMaxActiveClusters` at the width's
shared memory for clusters of 2 and of 4 (pair forms). Where the toolkit
has `ncu` it also tries to read the L2-to-SM sectors and the tensor pipe's
active share of one K1 call per width. Prints the card's name and power
limit first and a JSON line of every reading last. Run it on the card,
from the repository root.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "build"))

from h768_old_vs_new import per_call_ms, sleep_cycles_per_ms  # noqa: E402

NARROW_WIDTHS = (128, 256, 384, 512, 640)
PAIR_WIDTHS = (896, 1024, 1152, 1280, 1408, 1536)
VARIANTS = {"kernel": 0, "stream": 1, "stage1": 2, "fixed": 4}
# the kernel with a timeline of one row tile's steps (MRD_FFN_PROBE 3),
# read with --trace
TRACE = 3

# The probe variants, written into a copy of csrc/ffn_ln.cuh: (anchor, what
# replaces it), each anchor once in the header. 1: the weight stream alone;
# 2: stage 1 alone; 3: a timeline, the clock of each step of every chunk in
# one row tile (40, or the middle one of fewer; slice 0), stage 1's and
# stage-2 warpgroup 0's, in mrd_ffn_trace; 4: a tile with no chunk (the
# one-block forms). MRD_STAMP(role, chunk, step) is empty but at 3. Stage
# 1 of 768's loop stamps each half of a chunk: 4 half + 0 its products
# start, + 1 they are done, + 2 the chunk buffer is free, + 3 its GELU is
# stored; kNarrow's stage 1: 0 products start, 1 done, 2 its share of the
# GELU stored and the products slot free, 3 the products stored. Stage 2 of the one-block forms: 0 the wait for the
# chunk, 1 its arrival, 2 the products issued, 3 done; kNarrow's first
# takes the chunk's GELU: 4 the wait for stage 1's products, 5 their
# arrival, 6 the buffer is free, 7 the GELU is stored.
_ASSERT_REGS = "static_assert(2 * 128 * kS2Regs + 128 * kS1Regs"
# the tile's own steps (one-block forms), as chunk 127 of stage 2: 0 the
# kernel starts, 1 the prologue is done, 2 the epilogue starts, 3 y stored
_ENTRY = ("  using P = Ffn<kH>;\n  extern __shared__ __align__(1024) unsigned char "
          "smem_raw[];\n")
_ROLE = "  const int role = threadIdx.x / 128;\n"
_EPI = "    // ---- epilogue. Thread (warp, lane) holds rows wrow and wrow + 8, and\n"
_END = ("                        ld_f32(beta + col + 1));\n              }\n          }\n"
        "        }\n      }\n    }\n  }\n}\n\ntemplate <int kH, typename V, bool kInputLN>\n"
        "cudaError_t launch(")
_PASS_ALT = "    s1_pass<kH>(acc, g, w1_map, base, c_begin, rank, n_w1, leader);\n"
_PASS_WIDE = "      s1_pass<kH>(acc, g, w1_map, base, c_begin, rank, n_w1, leader);\n"
_ALT_WAIT = ("    mrd::mbar_wait_cluster(base + P::kBarHEmpty + 8 * rank, "
             "((k / kHStages) & 1) ^ 1);\n")
_ALT_COPY = ("                             mrd::map_to_rank(base + P::kBarHFull + "
             "8 * rank, rank ^ 1));\n")
_S2_WAIT = ("  mrd::wgmma_wait<0>();\n#pragma unroll\n  for (int j = 0; j < "
            "P::kW2PerChunk / kS2; ++j) mrd::fence_operand(acc[j]);\n")
_TAKE_H = ("    take_h<kH>(base, hs, k, n_w2 / P::kW2PerChunk, rank, wg, "
           "leader);\n")
_W2_FILL = "    for (int g = 0; g < P::kW2Stages && g < n_w2; ++g)\n"
_S2_HEAD = ("bool leader, int rank) {\n  using P = Ffn<kH>;\n"
            "  const int hs = k % kHStages;\n")
_S2_ONE_WAIT = ("  else\n    mbar_wait(base + P::kBarHFull + 8 * hs, "
                "(k / kHStages) & 1);\n")
_ONE_HALF = "          float p[16];\n"
_ONE_DONE = "          mrd::wgmma_wait<0>();\n          mrd::fence_operand(p);\n"
_ONE_EMPTY = ("          if (half == 0) mbar_wait(base + P::kBarHEmpty + 8 * hs, "
              "((k / kHStages) & 1) ^ 1);\n")
_ONE_GELU = ("                                        0.5f * v1 * (1.0f + "
             "erff(v1 * 0.70710678118654752f)));\n            }\n          }\n"
             "        }\n        fence_proxy_async();  // the stores, to stage "
             "2's wgmma\n")
_N1_PASS = "    s1_pass<kH>(acc, g, w1_map, base, c_begin, 0, n_w1, leader);\n"
_N1_EMPTY = "    }\n    const uint32_t slot = base + P::kOffP + ps * P::kPBytes + 8 * tid;\n"
_N1_STORED = "    mbar_arrive(base + P::kBarPFull + 8 * ps);\n"
_N2_HEAD = ("                                               int k) {\n"
            "  using P = Ffn<kH>;\n")
_N2_WAIT = ("  mbar_wait(base + P::kBarPFull + 8 * (k % P::kPStages), "
            "(k / P::kPStages) & 1);\n")
_N2_EMPTY = ("  mbar_wait(base + P::kBarHEmpty + 8 * hs, ((k / kHStages) & 1) ^ 1);\n"
             "  const int s = threadIdx.x;  // 0 .. 255\n")
_N2_GELU = "  fence_proxy_async();  // the chunk, to the wgmma\n"
PATCHES = (
    (_ASSERT_REGS, r"""#ifndef MRD_FFN_PROBE
#define MRD_FFN_PROBE 0
#endif
#if MRD_FFN_PROBE == 3
// row tile 40, or the middle one of fewer
#define MRD_TRACE_TILE (gridDim.x > 40 ? 40u : gridDim.x / 2)
__device__ long long mrd_ffn_trace[2][2][128][8];  // [rank][stage 1, 2][chunk][step]
#define MRD_STAMP(role, k, step)                                                     \
  do {                                                                               \
    if (blockIdx.x == MRD_TRACE_TILE && blockIdx.y == 0 && threadIdx.x % 128 == 0 && \
        (role == 0 || threadIdx.x == 0))                                             \
      mrd_ffn_trace[blockIdx.z][role][k][step] = clock64();                          \
  } while (0)
#else
#define MRD_STAMP(role, k, step)
#endif

""" + _ASSERT_REGS),
    (_ENTRY, _ENTRY + "  if constexpr (!Ffn<kH>::kPair) MRD_STAMP(1, 127, 0);\n"),
    (_ROLE, "  if constexpr (!P::kPair) MRD_STAMP(1, 127, 1);\n" + _ROLE),
    (_EPI, "    if constexpr (!P::kPair) MRD_STAMP(1, 127, 2);\n" + _EPI),
    (_END, _END.replace("      }\n    }\n  }\n}\n\ntemplate",
                        "      }\n      MRD_STAMP(1, 127, 3);\n    }\n  }\n}\n\ntemplate")),
    # before the patches whose text holds this anchor too
    (_W2_FILL, "    if constexpr (MRD_FFN_PROBE != 2)\n" + _W2_FILL),
    (_S2_HEAD, r"""bool leader, int rank) {
  using P = Ffn<kH>;
  if constexpr (MRD_FFN_PROBE == 4 && !P::kPair) {  // no chunk: the fills land
    if constexpr (kFirst) {
#pragma unroll
      for (int j = 0; j < P::kW2PerChunk / kS2; ++j)
#pragma unroll
        for (int i = 0; i < P::kAcc; ++i) acc[j][i] = 0.0f;
      for (int g = 0; g < P::kW2Stages && g < n_w2; ++g)
        mbar_wait(base + P::kBarW2Full + 8 * g, 0);
    }
    return;
  }
  const int hs = k % kHStages;
"""),
    (_TAKE_H, "  {\n    MRD_STAMP(1, k, 0);\n" + _TAKE_H
     + "    MRD_STAMP(1, k, 1);\n  }\n"),
    (_S2_ONE_WAIT, "  else {\n    MRD_STAMP(1, k, 0);\n"
     "    mbar_wait(base + P::kBarHFull + 8 * hs, (k / kHStages) & 1);\n"
     "    MRD_STAMP(1, k, 1);\n  }\n"),
    (_S2_WAIT, "  MRD_STAMP(1, k, 2);\n" + _S2_WAIT + "  MRD_STAMP(1, k, 3);\n"),
    (_PASS_ALT + _ALT_WAIT,
     "    MRD_STAMP(0, k, 0);\n" + _PASS_ALT + "    MRD_STAMP(0, k, 1);\n"
     + _ALT_WAIT + "    MRD_STAMP(0, k, 2);\n"),
    ("        0.5f * v1 * (1.0f + erff(v1 * 0.70710678118654752f))));\n"
     "      }\n    }\n    fence_proxy_async();",
     "        0.5f * v1 * (1.0f + erff(v1 * 0.70710678118654752f))));\n"
     "      }\n    }\n    MRD_STAMP(0, k, 3);\n    fence_proxy_async();"),
    (_ALT_COPY, _ALT_COPY + "    MRD_STAMP(0, k, 4);\n"),
    (_PASS_WIDE, "      MRD_STAMP(0, k, 2 * pass);\n" + _PASS_WIDE
     + "      MRD_STAMP(0, k, 2 * pass + 1);\n"),
    (_ONE_HALF, "          MRD_STAMP(0, k, 4 * half);\n" + _ONE_HALF),
    (_ONE_DONE, _ONE_DONE + "          MRD_STAMP(0, k, 4 * half + 1);\n"),
    (_ONE_EMPTY, _ONE_EMPTY + "          MRD_STAMP(0, k, 4 * half + 2);\n"),
    (_ONE_GELU, _ONE_GELU.replace("        }\n        fence_proxy_async();",
                                  "          MRD_STAMP(0, k, 4 * half + 3);\n"
                                  "        }\n        fence_proxy_async();")),
    (_N1_PASS, "    MRD_STAMP(0, k, 0);\n" + _N1_PASS + "    MRD_STAMP(0, k, 1);\n"),
    (_N1_EMPTY, _N1_EMPTY.replace("    const uint32_t slot",
                                  "    MRD_STAMP(0, k, 2);\n    const uint32_t slot")),
    (_N1_STORED, _N1_STORED + "    MRD_STAMP(0, k, 3);\n"),
    (_N2_HEAD, _N2_HEAD + "  if constexpr (MRD_FFN_PROBE == 4) return;  // no chunk\n"),
    (_N2_WAIT, "  MRD_STAMP(1, k, 4);\n" + _N2_WAIT + "  MRD_STAMP(1, k, 5);\n"),
    (_N2_EMPTY, _N2_EMPTY.replace("  const int s", "  MRD_STAMP(1, k, 6);\n  const int s")),
    (_N2_GELU, "  MRD_STAMP(1, k, 7);\n" + _N2_GELU),
    ("      mrd::setmaxnreg_dec<P::kRegs1>();\n", r"""      mrd::setmaxnreg_dec<P::kRegs1>();
    if constexpr (MRD_FFN_PROBE == 1) {  // the W1 stream alone
      const int tiles = w1_tiles<kH>(chunks_per_slice, rank);
      Ring w1;
      for (int g = 0; g < tiles; ++g) {
        mbar_wait(base + P::kBarW1Full + 8 * w1.slot, w1.phase);
        if (leader && g + P::kW1Stages < tiles)
          load_w1<kH>(&w1_map, base, c_begin, rank, g + P::kW1Stages);
        w1.next<P::kW1Stages>();
      }
      if constexpr (P::kPair) mrd::cluster_sync();
      return;
    }
    if constexpr (MRD_FFN_PROBE == 4 && !P::kPair) {  // no chunk: the fills land
      for (int g = 0; g < P::kW1Stages && g < n_w1; ++g)
        mbar_wait(base + P::kBarW1Full + 8 * g, 0);
      return;
    }
"""),
    ("    const int wg = role;\n", r"""    const int wg = role;
    if constexpr (MRD_FFN_PROBE == 1) {  // the W2 stream alone:
      // each warpgroup waits for its own tiles only (the slots of its parity)
      Ring w2;
      for (int g = 0; g < n_w2; ++g) {
        if (g % kS2 == wg) {
          mbar_wait(base + P::kBarW2Full + 8 * w2.slot, w2.phase);
          if (leader && g + P::kW2Stages < n_w2)
            load_w2<kH>(&w2_map, base, c_begin, col0, g + P::kW2Stages);
        }
        w2.next<P::kW2Stages>();
      }
      if constexpr (P::kPair) mrd::cluster_sync();
      return;
    }
    if constexpr (MRD_FFN_PROBE == 2) {  // stage 1 alone
      for (int k = 0; k < chunks_per_slice; ++k) {
        const int hs = k % kHStages;
        if constexpr (P::kPair) {
          if constexpr (P::kWide)  // the chunk's GELU is stage 2's
            s2_gelu<kH, V>(base, b1, c_begin + k, k, chunks_per_slice, rank, wg, leader);
          take_h<kH>(base, hs, k, chunks_per_slice, rank, wg, leader);
          if (leader) release_h<kH>(base, hs, rank);
        } else if constexpr (P::kNarrow) {  // the products slot and the buffer back
          mbar_wait(base + P::kBarPFull + 8 * (k % P::kPStages), (k / P::kPStages) & 1);
          mbar_arrive(base + P::kBarHFull + 8 * hs);
          mbar_wait(base + P::kBarHFull + 8 * hs, (k / kHStages) & 1);
          if (leader) mbar_arrive(base + P::kBarHEmpty + 8 * hs);
        } else {
          mbar_wait(base + P::kBarHFull + 8 * hs, (k / kHStages) & 1);
          if (leader) mbar_arrive(base + P::kBarHEmpty + 8 * hs);
        }
      }
      if constexpr (P::kPair) mrd::cluster_sync();
      return;
    }
"""),
)
ROW_ATOL, ROW_MEAN_ATOL = 5e-2, 1e-4

SOURCE = """#include "{header}"
extern "C" {{
const char* mrd_error_string(int err) {{
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}}
MRD_FFN_WIDTH({h})
#if MRD_FFN_PROBE == 3
int mrd_probe_trace(void* out) {{
  return static_cast<int>(cudaMemcpyFromSymbol(out, mrd_ffn_trace, sizeof(mrd_ffn_trace)));
}}
#endif
}}
"""

# clusters of (x, 1, z) blocks of 384 threads with `smem` bytes each: how
# many the card holds at once (the kernel's placement depends only on the
# block's shared memory, threads and registers, one block per SM)
OCCUPANCY = r"""#include <cuda_runtime.h>
__global__ void __launch_bounds__(384, 1) probe_block() {}
extern "C" int probe_clusters(int smem, int cx, int cz) {
  if (cudaFuncSetAttribute(probe_block, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cx;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cz;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cx * 64, 1, cz);
  config.blockDim = dim3(384);
  config.dynamicSmemBytes = smem;
  config.attrs = attr;
  config.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, probe_block, &config) != cudaSuccess) return -2;
  return n;
}
"""


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if not found:
        raise SystemExit("nvcc not found")
    return found


def probe_csrc(csrc: Path, out: Path) -> Path:
    """A copy of `csrc` in `out` whose ffn_ln.cuh holds the probe variants
    (PATCHES); raises where an anchor is not in the header once."""
    dst = out / "csrc_probe"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    text = (dst / "ffn_ln.cuh").read_text()
    for anchor, patched in PATCHES:
        if text.count(anchor) != 1:
            raise SystemExit(f"probe anchor found {text.count(anchor)} times "
                             f"in {csrc / 'ffn_ln.cuh'}:\n{anchor}")
        text = text.replace(anchor, patched)
    (dst / "ffn_ln.cuh").write_text(text)
    return dst


def build(csrc: Path, widths, out: Path, trace: bool = False) -> dict:
    """{(variant, width): library path} and the occupancy library, built
    by one nvcc each, all at once, into `out`: the kernel from `csrc`, the
    probe variants from its patched copy."""
    out.mkdir(parents=True, exist_ok=True)
    probes = probe_csrc(csrc, out) if set(VARIANTS) - {"kernel"} or trace \
        else csrc
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-shared", "-Xptxas=-v"]
    jobs = {}
    for name, v in {**VARIANTS, **({"trace": TRACE} if trace else {})}.items():
        for h in widths:
            if name == "fixed" and name not in variants_at(h):
                continue
            src = out / f"{name}_h{h}.cu"
            header = (csrc if name == "kernel" else probes) / "ffn_ln.cuh"
            src.write_text(SOURCE.format(header=header, h=h))
            lib = out / f"lib{name}_h{h}.so"
            jobs[(name, h)] = (lib, [nvcc(), *flags, f"-DMRD_FFN_PROBE={v}",
                                     "-o", str(lib), str(src)])
    occ_src = out / "occupancy.cu"
    occ_src.write_text(OCCUPANCY)
    occ = out / "liboccupancy.so"
    jobs["occupancy"] = (occ, [nvcc(), *flags, "-o", str(occ), str(occ_src)])
    procs = {k: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, (_, cmd) in jobs.items()}
    logs = {k: p.communicate()[0] for k, p in procs.items()}
    for k, p in procs.items():
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for {k}:\n{logs[k]}")
    (out / "ptxas.log").write_text("".join(f"== {k}\n{v}" for k, v in
                                           logs.items()))
    spills = [k for k, v in logs.items()
              if re.search(r"\b[1-9][0-9]* bytes spill|C75[0-9][0-9]", v)]
    if spills:
        print(f"ptxas spills or C75xx in {spills} (see "
              f"{out / 'ptxas.log'})", flush=True)
    return {k: lib for k, (lib, _) in jobs.items()}


def variants_at(h: int) -> list:
    """The variants built and read at width h: `fixed` only at the
    one-block forms (a pair's tile without a chunk has nothing to wait for
    from its peer's stage 1, which the variant does not model)."""
    return [n for n in VARIANTS if n != "fixed" or h not in PAIR_WIDTHS]


def bind(path: Path, h: int) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, args in ((f"mrd_ffn_pre_ln_bf16_h{h}", [p] * 11 + [i, i, i, f, i, p]),
                       (f"mrd_ffn_ln_bf16_h{h}", [p] * 9 + [i, i, i, f, p]),
                       (f"mrd_ffn_smem_bytes_h{h}", [])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, i
    return lib


def calls(lib: ctypes.CDLL, h: int, m: int, dev, slices: int = 1) -> dict:
    """K1 (f32 vectors) and K2 of `lib` at width h on seeded tensors, F in
    `slices` slices (one: the plan at M = 16,384); each call returns the
    tensors it read and wrote."""
    f = 4 * h
    gen = torch.Generator().manual_seed(h)

    def rnd(shape, scale, offset=0.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen) * scale + offset).to(
            dev, dtype)

    z = rnd((m, h), 1.0)
    w1t, w2t = rnd((f, h), 0.05), rnd((h, f), 0.05)
    b1 = rnd((f,), 0.5)
    vec = [rnd((h,), 0.5), rnd((h,), 0.25, 1.0), rnd((h,), 0.5)]
    ln0 = [rnd((h,), 0.25, 1.0), rnd((h,), 0.5)]
    y = torch.empty_like(z)
    scratch = (torch.empty((slices, m, h), dtype=torch.float32, device=dev)
               if slices > 1 else None)
    part = scratch.data_ptr() if scratch is not None else None
    f32 = [t.float() for t in (b1, *vec, *ln0)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    k1 = getattr(lib, f"mrd_ffn_pre_ln_bf16_h{h}")
    k2 = getattr(lib, f"mrd_ffn_ln_bf16_h{h}")
    keep = dict(z=z, w1t=w1t, w2t=w2t, b1=b1, vec=vec, ln0=ln0, y=y, f32=f32,
                scratch=scratch)

    def run_k1():
        err = k1(z.data_ptr(), w1t.data_ptr(), f32[0].data_ptr(),
                 w2t.data_ptr(), *(t.data_ptr() for t in f32[1:]),
                 y.data_ptr(), part, m, f, slices, 1e-12, 0, stream)
        if err:
            raise RuntimeError(f"K1 H={h}: CUDA error {err}")
        return keep

    def run_k2():
        err = k2(z.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(),
                 *(t.data_ptr() for t in vec), y.data_ptr(), part, m, f,
                 slices, 1e-12, stream)
        if err:
            raise RuntimeError(f"K2 H={h}: CUDA error {err}")
        return keep

    return {"K1": run_k1, "K2": run_k2}


def timeline(path: Path, h: int, m: int, dev) -> dict:
    """One K1 call of the timeline variant at m rows (the plan's slices of
    F): for each block of the traced row tile (both of a pair) and each of
    stage 1 and stage-2 warpgroup 0, the median over the middle chunks of
    the clocks between a chunk's consecutive steps, and of the chunk's
    period (step 0 to the next chunk's step 0)."""
    import numpy as np

    lib = bind(path, h)
    lib.mrd_probe_trace.argtypes, lib.mrd_probe_trace.restype = \
        [ctypes.c_void_p], ctypes.c_int
    fns = calls(lib, h, m, dev, plan_slices(h, m, dev))
    fns["K1"]()
    fns["K1"]()
    torch.cuda.synchronize()
    buf = np.zeros((2, 2, 128, 8), np.int64)
    if lib.mrd_probe_trace(buf.ctypes.data):
        raise RuntimeError("mrd_probe_trace failed")
    n = h // 16 // plan_slices(h, m, dev)  # chunks (F / 64) of slice 0
    out = {}
    for rank in (0, 1) if h in PAIR_WIDTHS else (0,):
        for role, name in ((0, "stage 1"), (1, "stage 2 WG 0")):
            t = buf[rank, role, :n].astype(np.float64)
            t = t[t[:, 0] != 0]  # the chunks this role of the block stamped
            steps = [j for j in range(8) if t[:, j].all()]
            mid = t[2:-2]
            d = {f"{a}->{b}": float(np.median(mid[:, b] - mid[:, a]))
                 for a, b in zip(steps, steps[1:])}
            d["period"] = float(np.median(np.diff(mid[:, 0])))
            out[f"rank {rank} {name}"] = d
            print(f"H={h} M={m} timeline rank {rank} {name} (clk, median of "
                  f"{len(mid)} chunks): " + ", ".join(f"{k} {v:.0f}"
                                                      for k, v in d.items()),
                  flush=True)
    if h not in PAIR_WIDTHS:  # the tile's prologue, chunks and epilogue
        t = buf[0, 1, 127, :4].astype(np.float64)
        out["tile"] = {"prologue": t[1] - t[0], "chunks": t[2] - t[1],
                       "epilogue": t[3] - t[2]}
        print(f"H={h} M={m} tile (clk): " + ", ".join(
            f"{k} {v:.0f}" for k, v in out["tile"].items()), flush=True)
    return out


def plan_slices(h: int, m: int, dev) -> int:
    """The slices of F the package's plan gives m rows at width h."""
    sys.path.insert(0, str(ROOT))
    from multimodal_rare_disease_tpu_torch.kernels import ffn

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    return ffn.ffn_plan(m, 4 * h, n_sm, h).slices


def check(lib: ctypes.CDLL, h: int, m: int, dev) -> dict:
    """max and mean |kernel - plain| of K1 and K2 at m rows, with the
    package plan's slices of F."""
    slices = plan_slices(h, m, dev)
    from multimodal_rare_disease_tpu_torch.kernels import ffn

    out = {"slices": slices}
    for k, fn in calls(lib, h, m, dev, slices).items():
        t = fn()
        torch.cuda.synchronize()
        w1, w2 = t["w1t"].t(), t["w2t"].t()
        if k == "K1":
            want = ffn.ffn_ln_plain(t["z"], w1, *t["f32"][:1], w2,
                                    *t["f32"][1:4], 1e-12, input_ln=True,
                                    pre_gamma=t["f32"][4],
                                    pre_beta=t["f32"][5])
        else:
            want = ffn.ffn_ln_plain(t["z"], w1, t["b1"], w2, *t["vec"],
                                    1e-12, input_ln=False)
        d = (t["y"].float() - want.float()).abs()
        out[k] = (d.max().item(), d.mean().item())
    return out


def ncu_reading(h: int, m: int, out: Path) -> str:
    """ncu's L2-to-SM sectors and tensor-pipe share of one K1 call at
    width h (the kernel variant), or why there is none."""
    exe = shutil.which("ncu") or (
        "/usr/local/cuda/bin/ncu"
        if Path("/usr/local/cuda/bin/ncu").is_file() else None)
    if exe is None:
        return "no ncu in the toolkit"
    metrics = ("lts__t_sectors_srcunit_tex_op_read.sum,"
               "sm__pipe_tensor_op_hmma_cycles_active.avg.pct_of_peak_"
               "sustained_active")
    cmd = [exe, "--metrics", metrics, "--kernel-name", "regex:ffn_ln",
           "--launch-count", "1", "--csv", sys.executable, __file__,
           "--one", str(h), "--rows", str(m), "--out", str(out)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=90)
    except subprocess.TimeoutExpired:
        return "ncu timed out"
    tail = (r.stdout + r.stderr).strip().splitlines()[-6:]
    return f"rc {r.returncode}: " + " | ".join(tail)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", type=Path,
                    default=ROOT / "multimodal_rare_disease_tpu_torch" / "csrc")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "pair_probe")
    ap.add_argument("--widths", type=int, nargs="*",
                    default=NARROW_WIDTHS + PAIR_WIDTHS)
    ap.add_argument("--no-ncu", action="store_true")
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--build-only", action="store_true",
                    help="build and report ptxas spills, nothing more")
    ap.add_argument("--check-only", action="store_true",
                    help="hold the kernel to the plain version, time nothing")
    ap.add_argument("--trace", action="store_true",
                    help="also print one row tile's timeline of a K1 call")
    ap.add_argument("--rows", type=int, nargs="*", default=[16384])
    ap.add_argument("--one", type=int, default=0,
                    help="run one K1 call of the kernel variant (for ncu)")
    args = ap.parse_args()
    args.out = args.out.resolve()  # the generated sources include by path
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    if args.one:
        lib = bind(args.out / f"libkernel_h{args.one}.so", args.one)
        calls(lib, args.one, args.rows[0], dev)["K1"]()
        torch.cuda.synchronize()
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    for name in [v for v in VARIANTS if v not in args.variants]:
        del VARIANTS[name]
    libs = build(args.csrc.resolve(), args.widths, args.out, args.trace)
    if args.build_only:
        return 0
    occ = ctypes.CDLL(str(libs.pop("occupancy")))
    occ.probe_clusters.argtypes = [ctypes.c_int] * 3
    occ.probe_clusters.restype = ctypes.c_int
    cyc = sleep_cycles_per_ms()
    readings, bad = {}, []
    for h in args.widths:
        names = variants_at(h)
        bound = {name: bind(libs[(name, h)], h) for name in names}
        agree = {mm: check(bound["kernel"], h, mm, dev) for mm in args.rows}
        for mm, e in agree.items():
            ok = all(e[k][0] <= ROW_ATOL and e[k][1] <= ROW_MEAN_ATOL
                     for k in ("K1", "K2"))
            print(f"H={h} M={mm} ({e['slices']} slices): K1 max/mean "
                  f"|kernel - plain| {e['K1'][0]:.3e} / {e['K1'][1]:.3e}, K2 "
                  f"{e['K2'][0]:.3e} / {e['K2'][1]:.3e} "
                  f"{'ok' if ok else 'OFF'}", flush=True)
            if not ok:
                bad.append(f"H={h} M={mm}")
        if args.check_only:
            readings[h] = {"agreement": agree}
            continue
        smem = bound["kernel"][f"mrd_ffn_smem_bytes_h{h}"]()
        row = {"agreement": agree, "smem_bytes": smem}
        if h in PAIR_WIDTHS:
            row["max_active_clusters"] = {
                f"{cx}x1x2": occ.probe_clusters(smem, cx, 2) for cx in (1, 2)}
            print(f"H={h}: {smem} bytes of shared memory a block; clusters "
                  f"resident at once {row['max_active_clusters']}", flush=True)
        for m in args.rows:
            slices = plan_slices(h, m, dev)
            fns = {name: calls(lib, h, m, dev, slices)
                   for name, lib in bound.items()}
            for by_kernel in fns.values():
                for fn in by_kernel.values():
                    for _ in range(3):
                        fn()
            torch.cuda.synchronize()
            # every block reads its column group's W1 and W2
            w_bytes = 4 * h * (4 * h) * -(-m // 64)
            at = row.setdefault(f"M={m}", {"slices": slices,
                                           "weight_bytes": w_bytes})
            for k in ("K1", "K2"):
                order = names + names[::-1]
                t = {name: [] for name in names}
                for name in order:
                    t[name].append(per_call_ms(fns[name][k], cyc))
                ms = {name: sum(v) / len(v) for name, v in t.items()}
                at[k] = {name: {"ms": ms[name], "runs": t[name],
                                "weight_TBps": w_bytes / ms[name] / 1e9}
                         for name in names}
                label = {"kernel": "kernel", "stream": "weight stream alone",
                         "stage1": "stage 1 alone",
                         "fixed": "tile with no chunk"}
                print(f"H={h} {k} M={m} ({slices} slices): dev ms " + ", ".join(
                    f"{label[n]} {ms[n]:.4f}" for n in names)
                    + (f" (no chunk {ms['fixed'] / ms['kernel']:.1%} of the "
                       f"kernel)" if "fixed" in ms else "")
                    + f" | W1+W2 read per call {w_bytes / 1e9:.2f} GB; over "
                    f"each time " + ", ".join(
                        f"{w_bytes / ms[n] / 1e9:.2f}" for n in names)
                    + " TB/s", flush=True)
            if args.trace:
                at["timeline"] = timeline(libs[("trace", h)], h, m, dev)
        readings[h] = row
    for h in [] if args.no_ncu else args.widths:  # stop at ncu's first failure
        readings[h]["ncu"] = ncu_reading(h, args.rows[0], args.out)
        print(f"H={h} ncu: {readings[h]['ncu']}", flush=True)
        if not readings[h]["ncu"].startswith("rc 0"):
            break
    print(json.dumps({"card": card, "rows": args.rows, "readings": readings,
                      "off": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
