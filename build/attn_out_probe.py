#!/usr/bin/env python3
"""The floors of the bf16 attention-output kernel (K3) on the card, beside
the kernel itself, at its cluster forms (H = 896, 1,024, 1,152, 1,280,
1,408 and 1,536) and at two of its one-block widths (128 and 640).

    python3 build/attn_out_probe.py [--csrc DIR] [--out DIR] [--widths H ...]
                                    [--rows M ...] [--variants V ...]
                                    [--form parent|overlap] [--trace] [--trap]
                                    [--build-only] [--check-only]

From `csrc/attn_out_ln.cuh` (or DIR's) it builds one small library per
width and variant, all nvccs at once, into `build/attn_out_probe/` (or
--out):

- `kernel`: the header as it is, the kernel kernels/build.py builds;
- `stream`: the Wo stream alone: every Wo tile (and ctx block) goes
  through its ring by TMA, and the consumers wait for it and release it,
  with no product and no epilogue (they wait for x, so that no copy is in
  flight when the block exits);
- `product`: the product with no Wo stream: each consumer's first Wo tile
  is loaded once and every group of every chunk reads it; ctx, x, the
  LayerNorm and the y store as in the kernel;
- `fixed`: a tile with no chunk: the prologue, x, the LayerNorm over the
  cluster of zero products and the y store;
- `trace` (with --trace): the kernel with the clock of each step of every
  chunk in one row tile (every block of its cluster) and of the tile's
  own steps.

The variants are written into a copy of the header (`PATCHES`, each
anchored on text that must occur as often as the patch says) under
MRD_K3_PROBE 1, 2, 3 and 4, which only this script defines; the header
the package builds holds none of them. `PATCHES` cover the split-K and
cluster-pair kernel (`attn_out_ln_kernel`) and, where the header has it,
the persistent cluster-of-four kernel that runs the whole-K path at these
widths (`attn_out_quad_kernel`). With --trap every wait loop of the
copy's `hopper.cuh` traps after 10 s (a deadlock then fails the launch
instead of hanging the card); it only checks (wgmma serializes under it).

With `--form overlap` every call at 640 asks the C entry for the
overlapped form (`slices` 0; csrc/attn_out_ln_overlap.cu) at every M, and
the one-block form the plan gives (`parent`) is timed in the same turns;
the variants are those of the cluster-of-four kernel, which runs that
form in clusters of two. At 128, where the header has the tile form
(attn_out_tile_kernel, the width's only form), every call takes it
(`slices` 0) whatever --form says, and only the kernel is timed.

For each width it first holds the kernel variant against the package's
plain version (`attn_out_ln_plain`, f32 sums of bf16 products) at each M,
with the slices of the k loop that `kernels/attn_out.py::attn_out_plan`
gives, within chip_smoke.py's bf16 limits (5e-2 max, 1e-4 mean), and the
same bits on a second launch. Then at each M (default 16,384 and 1,024)
it prints the device time per call of each variant, taken in turns (the
variants, then the same in reverse; CUDA events over 20 calls queued
behind a spinning card), beside, at 16,384 rows, the classic bf16 chain
that K3 stands for (`F.linear`, the residual add, `F.layer_norm`) and
`F.linear` alone in the same turns; the Wo bytes the blocks read from L2
per call and those bytes over each time; and
`cudaOccupancyMaxActiveClusters` for clusters of 2 and of 4 at the shared
memory of each form. Prints the card's name and power limit first and a
JSON line of every reading last. Run it on the card, from the repository
root.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "build"))
sys.path.insert(0, str(ROOT))

from h768_old_vs_new import per_call_ms, sleep_cycles_per_ms  # noqa: E402
from pair_probe import OCCUPANCY, nvcc  # noqa: E402

WIDTHS = (128, 640, 896, 1024, 1152, 1280, 1408, 1536)
# the widths whose whole-K path runs on the cluster of four
QUAD_WIDTHS = (896, 1024, 1152, 1280, 1408, 1536)
VARIANTS = {"kernel": 0, "stream": 1, "product": 2, "fixed": 4}
TRACE = 3
LABEL = {"kernel": "kernel", "stream": "Wo stream alone",
         "product": "product, no Wo stream", "fixed": "tile with no chunk",
         "chain": "linear + add + layer_norm", "linear": "F.linear alone",
         "parent": "one-block form"}
ROW_ATOL, ROW_MEAN_ATOL = 5e-2, 1e-4
# the shared memory a block of each form may take, for the occupancy
# readings (bytes): 200 KB to the 227 KB limit
SMEM_STEPS = (200 * 1024, 208 * 1024, 216 * 1024, 224 * 1024, 232448)

# The probe variants of attn_out_ln_kernel (the split path and, before the
# cluster of four, the whole-K path): (anchor, replacement, times the
# anchor occurs). MRD_STAMP(role, k, step) stamps consumer thread 0 (role
# 0) or the producer thread (role 1) of row tile 40 (or the middle one of
# fewer), slice 0, every block of its cluster: role 0 per chunk 0 its
# ctx wait starts, 1 ctx there, 2 its first Wo tile there, 3 its groups
# issued; role 1 per chunk 0 its loads start, 1 its Wo tiles issued; role
# 0 chunk 127 the tile: 0 the kernel starts, 1 the barriers are shared, 2
# the product is done, 3 x is there, 4 the mean is known, 5 the rstd, 6 y
# is stored.
_PRELUDE = r"""#ifndef MRD_K3_PROBE
#define MRD_K3_PROBE 0
#endif
#if MRD_K3_PROBE == 3
// [cluster rank][consumer thread 0, producer thread][chunk][step]
__device__ long long mrd_k3_trace[4][2][128][8];
#define MRD_TRACE_TILE (gridDim.x > 40 ? 40u : gridDim.x / 2)
#define MRD_STAMP(role, k, step)                                              \
  do {                                                                        \
    if (blockIdx.x == MRD_TRACE_TILE && blockIdx.y == 0 &&                    \
        threadIdx.x == (role == 0 ? 0 : kConsumerThreads))                    \
      mrd_k3_trace[blockIdx.z][role][k][step] = clock64();                    \
  } while (0)
#define MRD_QSTAMP(on, role, k, step)                                         \
  do {                                                                        \
    if ((on) && threadIdx.x == (role == 0 ? 0 : kConsumerThreads))            \
      mrd_k3_trace[blockIdx.z][role][k][step] = clock64();                    \
  } while (0)
#else
#define MRD_STAMP(role, k, step)
#define MRD_QSTAMP(on, role, k, step)
#endif

"""
_PRODUCER_W = "        const uint32_t s = wg * P::kStages + ring[wg].slot;\n"
_X_SHARED = ("      if constexpr (kShared)  // and the block its columns end in\n"
             "        mbar_wait(xbar + 8 * (own0 + kOwnBlocks), kXPhase);\n")
_OLD_B0 = "    const uint32_t b0 = opaque(base) + P::kOffW + s * P::kTileBytes;\n"
_OLD_COMMIT = ("    mrd::wgmma_commit();\n    mrd::fence_operand(acc[j]);\n"
               "    if (!kFirst || j > 0) {\n      mrd::wgmma_wait<1>();\n      if (signal) {\n"
               "        mbar_arrive(base + P::kBarWEmpty")
_OLD_PRODUCER = ("  if (threadIdx.x / 128 == kWG) {\n    // ---- the producer warpgroup: one thread "
                 "issues every TMA load\n    mrd::setmaxnreg_dec<kProducerRegs>();\n"
                 "    if (threadIdx.x == kConsumerThreads)\n      produce<kH>(")
_PAIR_END = ("      if constexpr (P::kPair) mrd::cluster_sync();  // the peer is done "
             "with this block\n    }\n  }\n}\n")
PATCHES = (
    ("// The shape of the kernel at hidden width kH: 768 as the header sets out,\n",
     _PRELUDE + "// The shape of the kernel at hidden width kH: 768 as the header sets "
     "out,\n", 1),
    # the producer: stamps, one resident Wo tile (2), x alone (4)
    ("  using P = AttnOut<kH>;\n  Ring ring[kWG];\n", r"""  using P = AttnOut<kH>;
  Ring ring[kWG];
  if constexpr (MRD_K3_PROBE == 4) {  // no chunk: x of the block's columns only
    if (!split)
      for (int b = 0; b < P::kCols / kKC; ++b) {
        const int cb = col0 / kKC + b;  // global column block
        const uint32_t at = P::kWide ? b : cb;
        mbar_arrive_expect_tx(base + P::kBarAFull + 8 * at, kBlockBytes);
        tma_load_2d(base + P::kOffA + at * kBlockBytes, x_map, base + P::kBarAFull + 8 * at,
                    cb * kKC, row0);
      }
    return;
  }
""", 1),
    ("    const int c = c_begin + k;\n",
     "    const int c = c_begin + k;\n    MRD_STAMP(1, k, 0);\n", 1),
    (_PRODUCER_W, r"""        if constexpr (MRD_K3_PROBE == 2) {  // one resident Wo tile a consumer
          if (k == 0 && j == 0) {
            const uint32_t s0 = wg * P::kStages;
            mbar_arrive_expect_tx(base + P::kBarWFull + 8 * s0, P::kTileBytes);
            tma_load_2d(base + P::kOffW + s0 * P::kTileBytes, wo_map,
                        base + P::kBarWFull + 8 * s0, c * kKC, col0 + P::kHalf * wg);
          }
          continue;
        }
""" + _PRODUCER_W, 1),
    ("        ring[wg].next<P::kStages>();\n      }\n",
     "        ring[wg].next<P::kStages>();\n      }\n    MRD_STAMP(1, k, 1);\n", 1),
    # the consumers' chunks: stamps, no product (1), one resident tile (2)
    ("  using P = AttnOut<kH>;\n  mbar_wait(base + P::kBarAFull + 8 * c, 0);\n",
     "  using P = AttnOut<kH>;\n  const int mrd_k = c;\n  MRD_STAMP(0, mrd_k, 0);\n"
     "  mbar_wait(base + P::kBarAFull + 8 * c, 0);\n  MRD_STAMP(0, mrd_k, 1);\n", 1),
    ("  const uint32_t cs = k % P::kCtxStages;\n"
     "  mbar_wait(base + P::kBarCFull + 8 * cs, (k / P::kCtxStages) & 1);\n",
     "  const uint32_t cs = k % P::kCtxStages;\n  const int mrd_k = k;\n"
     "  MRD_STAMP(0, mrd_k, 0);\n"
     "  mbar_wait(base + P::kBarCFull + 8 * cs, (k / P::kCtxStages) & 1);\n"
     "  MRD_STAMP(0, mrd_k, 1);\n", 1),
    ("    const uint32_t s = wg * P::kStages + ring.slot;\n",
     "    const uint32_t s = wg * P::kStages + (MRD_K3_PROBE == 2 ? 0u : ring.slot);\n", 2),
    ("    mbar_wait(base + P::kBarWFull + 8 * s, ring.phase);\n",
     "    mbar_wait(base + P::kBarWFull + 8 * s, MRD_K3_PROBE == 2 ? 0u : ring.phase);\n"
     "    if (j == 0) MRD_STAMP(0, mrd_k, 2);\n", 2),
    (_OLD_B0 + "    mrd::fence_operand(acc[j]);\n    mrd::wgmma_fence();\n",
     _OLD_B0 + "    if constexpr (MRD_K3_PROBE != 1) {\n    mrd::fence_operand(acc[j]);\n"
     "    mrd::wgmma_fence();\n", 2),
    (_OLD_COMMIT, _OLD_COMMIT.replace("    if (!kFirst", "    }\n    if (!kFirst"), 2),
    ("    prev = s;\n    ring.next<P::kStages>();\n  }\n}\n",
     "    prev = s;\n    ring.next<P::kStages>();\n  }\n  MRD_STAMP(0, mrd_k, 3);\n}\n", 2),
    # the tile's steps; no chunk (4); no epilogue (1)
    ("  using P = AttnOut<kH>;\n  extern __shared__ __align__(1024) unsigned char "
     "smem_raw[];\n",
     "  using P = AttnOut<kH>;\n  extern __shared__ __align__(1024) unsigned char "
     "smem_raw[];\n  MRD_STAMP(0, 127, 0);\n", 1),
    (_OLD_PRODUCER, "  MRD_STAMP(0, 127, 1);\n" + _OLD_PRODUCER, 1),
    ("    if constexpr (P::kWide) {\n      consume_chunk_wide<kH, true>(acc, ring, prev, "
     "base, 0, wg, signal);\n",
     "    if constexpr (MRD_K3_PROBE == 4) {  // no chunk\n#pragma unroll\n"
     "      for (int j = 0; j < P::kTiles; ++j)\n#pragma unroll\n"
     "        for (int i = 0; i < P::kAcc; ++i) acc[j][i] = 0.0f;\n    } else\n"
     "    if constexpr (P::kWide) {\n      consume_chunk_wide<kH, true>(acc, ring, prev, "
     "base, 0, wg, signal);\n", 1),
    ("    mrd::wgmma_wait<0>();\n#pragma unroll\n"
     "    for (int j = 0; j < P::kTiles; ++j) mrd::fence_operand(acc[j]);\n",
     "    mrd::wgmma_wait<0>();\n#pragma unroll\n"
     "    for (int j = 0; j < P::kTiles; ++j) mrd::fence_operand(acc[j]);\n"
     "    MRD_STAMP(0, 127, 2);\n", 1),
    ("      constexpr uint32_t kXPhase = P::kWide ? 0 : 1;\n",
     "      constexpr uint32_t kXPhase = P::kWide || MRD_K3_PROBE == 4 ? 0 : 1;\n", 1),
    (_X_SHARED, _X_SHARED + "      MRD_STAMP(0, 127, 3);\n"
     "      if constexpr (MRD_K3_PROBE == 1) {  // the stream alone: no epilogue\n"
     "        if constexpr (P::kPair) mrd::cluster_sync();\n        return;\n      }\n", 1),
    ("                   (1.0f / kH);\n        s[half] = 0.0f;\n      }\n",
     "                   (1.0f / kH);\n        s[half] = 0.0f;\n      }\n"
     "      MRD_STAMP(0, 127, 4);\n", 1),
    ("                            eps);\n      }\n",
     "                            eps);\n      }\n      MRD_STAMP(0, 127, 5);\n", 1),
    (_PAIR_END, "      MRD_STAMP(0, 127, 6);\n" + _PAIR_END, 1),
)
# The same variants of attn_out_quad_kernel (applied where the header has
# it), stamped in the second group of cluster 0 (MRD_QSTAMP): role 0 per
# chunk 0 the consumer's chunk starts, 1 it has issued its groups; role 1
# per chunk 0 the producer's loads start, 1 its Wo tiles are issued; role
# 0 chunk 127 the group: 0 it starts, 1 the product is done, 2 x is there,
# 3 the mean is known, 4 the rstd, 5 y is written and its store issued.
QUAD_MARK = "attn_out_quad_kernel"
_Q_ON = "it == 1 && blockIdx.x == 0"
_Q_ROW0 = "    const int row0 = g * Q::kRows;\n"
_Q_WTILE = ("        const uint32_t wfull = base + Q::kBarWFull + 8 * wr.slot;\n"
            "        mbar_wait(base + Q::kBarWEmpty + 8 * wr.slot, wr.phase ^ 1);\n")
_Q_CHUNKS = ("      consume_quad<kH, true>(acc, cr, wr, base, wg, signal);\n"
             "      for (int k = 1; k < Q::kChunks; ++k) {\n"
             "        consume_quad<kH, false>(acc, cr, wr, base, wg, signal);\n")
_Q_WAIT = "    mbar_wait(base + Q::kBarWFull + 8 * wr.slot, wr.phase);\n"
_Q_B0 = "    const uint32_t b0 = opaque(base) + Q::kOffW + wr.slot * Q::kTileBytes;\n"
_Q_MMA = "    mrd::fence_operand(acc[j]);\n    mrd::wgmma_fence();\n"
_Q_COMMIT = ("    mrd::wgmma_commit();\n    mrd::fence_operand(acc[j]);\n"
             "    if (!kFirst || j > 0) {\n")
_Q_X = "      mbar_wait(base + Q::kBarXFull, it & 1);\n"
_Q_EX0 = "      quad_total<Q::kSize>(s, red_b, bar, parity, q, lane, wrow, rearm, arms);\n"
_Q_EX1 = ("      quad_total<Q::kSize>(s, red_b + 4 * kQuadExBytes, bar + 8 * kWG, parity, q, "
          "lane, wrow,\n                           rearm, arms);\n")
QUAD_PATCHES = (
    # the producer: x alone (4), one resident Wo tile (2), stamps
    (_Q_ROW0, _Q_ROW0 + r"""    if constexpr (MRD_K3_PROBE == 4) {  // no chunk: x alone
      if (it > 0) mbar_wait(base + Q::kBarXEmpty, (it - 1) & 1);
      mbar_arrive_expect_tx(base + Q::kBarXFull, Q::kXBlocks * Q::kXBlockBytes);
      for (int b = 0; b < Q::kXBlocks; ++b)
        tma_load_2d(base + Q::kOffX + b * Q::kXBlockBytes, x_map, base + Q::kBarXFull,
                    q * Q::kQ + b * Q::kXCols, row0);
      continue;
    }
""", 1),
    ("      const uint32_t cfull = base + Q::kBarCFull + 8 * cr.slot;\n",
     "      MRD_QSTAMP(" + _Q_ON + ", 1, k, 0);\n"
     "      const uint32_t cfull = base + Q::kBarCFull + 8 * cr.slot;\n", 1),
    (_Q_WTILE, r"""        if constexpr (MRD_K3_PROBE == 2) {  // one resident Wo tile
          if (it == 0 && k == 0 && j == 0) {
            mbar_arrive_expect_tx(base + Q::kBarWFull, Q::kTileBytes);
            tma_load_2d(base + Q::kOffW, wo_map, base + Q::kBarWFull, 0, q * Q::kQ);
          }
          continue;
        }
""" + _Q_WTILE, 1),
    ("        wr.next<Q::kStages>();\n      }\n",
     "        wr.next<Q::kStages>();\n      }\n      MRD_QSTAMP(" + _Q_ON + ", 1, k, 1);\n", 1),
    # the consumers' chunks: no product (1), one resident tile (2)
    (_Q_WAIT, "    mbar_wait(base + Q::kBarWFull + 8 * (MRD_K3_PROBE == 2 ? 0u : wr.slot),\n"
     "              MRD_K3_PROBE == 2 ? 0u : wr.phase);\n", 1),
    (_Q_B0 + _Q_MMA, "    const uint32_t b0 = opaque(base) + Q::kOffW +\n"
     "                        (MRD_K3_PROBE == 2 ? 0u : wr.slot) * Q::kTileBytes;\n"
     "    if constexpr (MRD_K3_PROBE != 1) {\n" + _Q_MMA, 1),
    (_Q_COMMIT, _Q_COMMIT.replace("    if (!kFirst", "    }\n    if (!kFirst"), 1),
    # the group: no chunk (4), stamps, no epilogue (1)
    (_Q_CHUNKS, "      MRD_QSTAMP(" + _Q_ON + ", 0, 127, 0);\n"
     "      if constexpr (MRD_K3_PROBE == 4) {  // no chunk\n#pragma unroll\n"
     "        for (int j = 0; j < Q::kTiles; ++j)\n#pragma unroll\n"
     "          for (int i = 0; i < Q::kAcc; ++i) acc[j][i] = 0.0f;\n"
     "        if (it > 0 && threadIdx.x % 128 == 0) {\n"
     "          mrd::tma_store_wait();\n          mbar_arrive(base + Q::kBarXEmpty);\n"
     "        }\n      } else {\n"
     "      MRD_QSTAMP(" + _Q_ON + ", 0, 0, 0);\n"
     "      consume_quad<kH, true>(acc, cr, wr, base, wg, signal);\n"
     "      MRD_QSTAMP(" + _Q_ON + ", 0, 0, 1);\n"
     "      for (int k = 1; k < Q::kChunks; ++k) {\n"
     "        MRD_QSTAMP(" + _Q_ON + ", 0, k, 0);\n"
     "        consume_quad<kH, false>(acc, cr, wr, base, wg, signal);\n"
     "        MRD_QSTAMP(" + _Q_ON + ", 0, k, 1);\n", 1),
    ("      mrd::wgmma_wait<0>();\n#pragma unroll\n"
     "      for (int j = 0; j < Q::kTiles; ++j) mrd::fence_operand(acc[j]);\n",
     "      }\n      mrd::wgmma_wait<0>();\n#pragma unroll\n"
     "      for (int j = 0; j < Q::kTiles; ++j) mrd::fence_operand(acc[j]);\n"
     "      MRD_QSTAMP(" + _Q_ON + ", 0, 127, 1);\n", 1),
    (_Q_X, _Q_X + "      MRD_QSTAMP(" + _Q_ON + ", 0, 127, 2);\n"
     "      if constexpr (MRD_K3_PROBE == 1) continue;  // the stream alone: no epilogue\n",
     1),
    (_Q_EX0, _Q_EX0 + "      MRD_QSTAMP(" + _Q_ON + ", 0, 127, 3);\n", 1),
    (_Q_EX1, _Q_EX1 + "      MRD_QSTAMP(" + _Q_ON + ", 0, 127, 4);\n", 1),
    ("        mrd::tma_store_commit();\n      }\n    }\n",
     "        mrd::tma_store_commit();\n      }\n      MRD_QSTAMP(" + _Q_ON + ", 0, 127, 5);\n"
     "    }\n", 1),
)

# every wait loop of hopper.cuh with a 10-s trap (--trap)
_TRAP_WAITS = (
    ("__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {\n"
     "  while (!mbar_try_wait(bar, parity)) {\n  }\n}\n"),
    ("__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {\n"
     "  while (!mbar_try_wait_cluster(bar, parity)) {\n  }\n}\n"),
)
_TRAP_BODY = r"""{
  uint64_t t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  while (!{try_wait}(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (t - t0 > 10000000000ull) __trap();
  }
}
"""

SOURCE = """#include "{header}"
extern "C" {{
const char* mrd_error_string(int err) {{
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}}
MRD_ATTN_OUT_WIDTH({h})
#if MRD_K3_PROBE == 3
int mrd_probe_trace(void* out) {{
  return static_cast<int>(cudaMemcpyFromSymbol(out, mrd_k3_trace, sizeof(mrd_k3_trace)));
}}
#endif
}}
"""


def patch_text(text: str, patches, where: str) -> str:
    for anchor, patched, times in patches:
        if text.count(anchor) != times:
            raise SystemExit(f"probe anchor found {text.count(anchor)} times, not "
                             f"{times}, in {where}:\n{anchor}")
        text = text.replace(anchor, patched)
    return text


def probe_csrc(csrc: Path, out: Path, trap: bool) -> Path:
    """A copy of `csrc` in `out` whose attn_out_ln.cuh holds the probe
    variants (PATCHES, and QUAD_PATCHES where the header has the cluster
    of four) and, with `trap`, whose wait loops trap after 10 s."""
    dst = out / "csrc_probe"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    header = dst / "attn_out_ln.cuh"
    text = patch_text(header.read_text(), PATCHES, str(csrc / "attn_out_ln.cuh"))
    if QUAD_MARK in text:
        text = patch_text(text, QUAD_PATCHES, str(csrc / "attn_out_ln.cuh"))
    header.write_text(text)
    if trap:
        hop = dst / "hopper.cuh"
        text = hop.read_text()
        for loop in _TRAP_WAITS:
            if text.count(loop) != 1:
                raise SystemExit(f"wait loop not found once in {hop}:\n{loop}")
            head, _ = loop.split("{\n", 1)
            try_wait = re.search(r"while \(!(\w+)\(", loop).group(1)
            text = text.replace(loop, head + _TRAP_BODY.replace("{try_wait}",
                                                                  try_wait))
        hop.write_text(text)
    return dst


def build(csrc: Path, widths, variants, out: Path, trace: bool,
          trap: bool) -> dict:
    """{(variant, width): library path} and the occupancy library, built
    by one nvcc each, all at once, into `out`: the kernel from `csrc` (from
    the trapping copy with `trap`), the probe variants from the patched
    copy."""
    out.mkdir(parents=True, exist_ok=True)
    probes = probe_csrc(csrc, out, trap)
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-shared", "-Xptxas=-v"]
    jobs = {}
    names = {v: VARIANTS[v] for v in variants}
    if trace:
        names["trace"] = TRACE
    for name, v in names.items():
        for h in widths:
            src = out / f"{name}_h{h}.cu"
            header = (probes if name != "kernel" or trap else csrc) / "attn_out_ln.cuh"
            src.write_text(SOURCE.format(header=header, h=h))
            lib = out / f"lib{name}_h{h}.so"
            jobs[(name, h)] = (lib, [nvcc(), *flags, f"-DMRD_K3_PROBE={v}",
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
    print(f"built {len(jobs)} libraries; ptxas spills or C75xx in "
          f"{spills or 'none'}", flush=True)
    for k in spills:  # each spilling function and its spill counts
        for fn, line in re.findall(r"Function properties for (\S+)\n\s+(.*spill.*)", logs[k]):
            if re.search(r"\b[1-9][0-9]* bytes spill", line):
                print(f"  {k}: {fn}: {line.strip()}", flush=True)
    return {k: lib for k, (lib, _) in jobs.items()}


def bind(path: Path, h: int) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, args in ((f"mrd_attn_out_ln_bf16_h{h}", [p] * 8 + [i, i, f, p]),
                       (f"mrd_attn_out_smem_bytes_h{h}", [])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, i
    if hasattr(lib, "mrd_probe_trace"):
        lib.mrd_probe_trace.argtypes = [p]
        lib.mrd_probe_trace.restype = i
    return lib


# --form, and whether the header has the tile form at 128 (then the
# width's only form)
FORM = "parent"
TILE_MARK = "attn_out_tile_kernel"
TILE = False


def plan_slices(h: int, m: int, dev, form: str = "") -> int:
    """The slices of the k loop the package's plan gives m rows at h, or 0:
    at 640 with --form overlap (the overlapped form), at 128 where the
    header has the tile form."""
    from multimodal_rare_disease_tpu_torch.kernels import attn_out

    if ((form or FORM) == "overlap" and h == 640) or (TILE and h == 128):
        return 0
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    return attn_out.attn_out_plan(m, n_sm, h).slices


def tensors(h: int, m: int, dev) -> dict:
    """Seeded ctx, x, Wo (nn.Linear's [out, in]) and bo, gamma, beta at
    the scales of the GPU tests, in bf16."""
    gen = torch.Generator().manual_seed(h + m)

    def rnd(shape, scale, offset=0.0):
        return (torch.randn(shape, generator=gen) * scale + offset).to(
            dev, torch.bfloat16)

    return dict(ctx=rnd((m, h), 1.0), x=rnd((m, h), 1.0),
                wot=rnd((h, h), 0.05), bo=rnd((h,), 0.5),
                gamma=rnd((h,), 0.25, 1.0), beta=rnd((h,), 0.5))


def call(lib: ctypes.CDLL, h: int, t: dict, slices: int, dev):
    """A function that launches `lib`'s K3 on `t` into a new y and
    returns y (f32 scratch for the split path, kept in the closure)."""
    m = t["ctx"].shape[0]
    y = torch.empty_like(t["ctx"])
    scratch = (torch.empty((slices, m, h), dtype=torch.float32, device=dev)
               if slices > 1 else None)
    fn = getattr(lib, f"mrd_attn_out_ln_bf16_h{h}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t[k].data_ptr() for k in ("ctx", "x", "wot", "bo", "gamma",
                                      "beta")]

    def run():
        err = fn(*ptrs, y.data_ptr(),
                 scratch.data_ptr() if scratch is not None else None, m,
                 slices, 1e-12, stream)
        if err:
            raise RuntimeError(f"K3 H={h} M={m}: CUDA error {err}")
        return y

    return run


def chain(t: dict):
    """The classic bf16 chain K3 stands for, and F.linear alone."""
    h = t["ctx"].shape[1]
    return {"chain": lambda: F.layer_norm(
                F.linear(t["ctx"], t["wot"], t["bo"]) + t["x"], (h,),
                t["gamma"], t["beta"], 1e-12),
            "linear": lambda: F.linear(t["ctx"], t["wot"], t["bo"])}


def check(lib: ctypes.CDLL, h: int, m: int, dev) -> dict:
    """max and mean |kernel - plain| at m rows with the plan's slices, and
    whether a second launch gives the same bits."""
    from multimodal_rare_disease_tpu_torch.kernels import attn_out

    slices = plan_slices(h, m, dev)
    t = tensors(h, m, dev)
    run = call(lib, h, t, slices, dev)
    first = run().clone()
    again = run()
    torch.cuda.synchronize()
    want = attn_out.attn_out_ln_plain(t["ctx"], t["x"], t["wot"].t(), t["bo"],
                                      t["gamma"], t["beta"], 1e-12)
    d = (first.float() - want.float()).abs()
    out = {"slices": slices, "max": d.max().item(), "mean": d.mean().item(),
           "same_bits": bool(torch.equal(first, again))}
    if slices == 0 and h == 640:  # against the one-block form's bits
        parent = call(lib, h, t, plan_slices(h, m, dev, "parent"), dev)()
        torch.cuda.synchronize()
        differ = (first != parent).nonzero()
        out["bits_of_parent"] = not len(differ)
        if len(differ):  # the first element that differs, and by how much
            r, c = differ[0].tolist()
            out["first_differing"] = [r, c, first[r, c].item(), parent[r, c].item()]
            out["n_differing"] = len(differ)
    return out


def wo_bytes(h: int, m: int, quad: bool) -> int:
    """Wo bytes the blocks read from L2 per call on the whole-K path:
    each 64-row tile's two blocks read half of Wo each (the pair), or
    each 128 rows' four blocks a quarter each (the cluster of four)."""
    rows = 128 if quad else 64
    return -(-m // rows) * h * h * 2


def timeline(lib: ctypes.CDLL, h: int, m: int, dev, quad: bool) -> dict:
    """One call of the trace variant at m rows: per block of the traced
    cluster, the median over the middle chunks of the clocks between
    consecutive steps of the consumer's and the producer's chunks, their
    period, and the tile's steps."""
    import numpy as np

    slices = plan_slices(h, m, dev)
    run = call(lib, h, tensors(h, m, dev), slices, dev)
    run()
    run()
    torch.cuda.synchronize()
    buf = np.zeros((4, 2, 128, 8), np.int64)
    if lib.mrd_probe_trace(buf.ctypes.data):
        raise RuntimeError("mrd_probe_trace failed")
    n = h // 64 // max(slices, 1)
    out = {}
    for rank in range(2 if h == 640 and quad else 4 if quad else 2 if h >= 896 else 1):
        for role, name in ((0, "consumer"), (1, "producer")):
            t = buf[rank, role, :n].astype(np.float64)
            steps = [j for j in range(8) if t[:, j].all()]
            mid = t[2:-2] if len(t) > 6 else t
            d = {f"{a}->{b}": float(np.median(mid[:, b] - mid[:, a]))
                 for a, b in zip(steps, steps[1:])}
            d["period"] = float(np.median(np.diff(mid[:, 0]))) if len(mid) > 1 \
                else 0.0
            out[f"rank {rank} {name}"] = d
            print(f"H={h} M={m} timeline rank {rank} {name} (clk, median of "
                  f"{len(mid)} chunks): " + ", ".join(
                      f"{k} {v:.0f}" for k, v in d.items()), flush=True)
        tile = buf[rank, 0, 127].astype(np.float64)
        names = (("start", "product", "x", "mean", "rstd", "stored") if quad else
                 ("start", "shared", "product", "x", "mean", "rstd", "stored"))
        st = {f"{names[a]}->{names[a + 1]}": tile[a + 1] - tile[a]
              for a in range(len(names) - 1) if tile[a] and tile[a + 1]}
        if tile[0]:  # the chunks' starts from the tile's (group's) start
            st["chunk starts"] = [float(buf[rank, 0, k, 0] - tile[0])
                                  for k in range(n) if buf[rank, 0, k, 0]]
            # the producer's: its loads of each chunk start, and its Wo
            # tiles are issued (waits for free slots included)
            st["producer"] = [[float(buf[rank, 1, k, s] - tile[0]) for s in (0, 1)]
                              for k in range(n) if buf[rank, 1, k, 0]]
        out[f"rank {rank} tile"] = st
        print(f"H={h} M={m} tile rank {rank} (clk): " + ", ".join(
            f"{k} {v:.0f}" for k, v in st.items()
            if k not in ("chunk starts", "producer"))
            + (f"; chunk starts {[int(v) for v in st['chunk starts'][:4]]} .. "
               f"{int(st['chunk starts'][-1])}" if st.get("chunk starts") else ""),
            flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", type=Path,
                    default=ROOT / "multimodal_rare_disease_tpu_torch" / "csrc")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "attn_out_probe")
    ap.add_argument("--widths", type=int, nargs="*", default=list(WIDTHS))
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--rows", type=int, nargs="*", default=[16384, 1024])
    ap.add_argument("--form", choices=("parent", "overlap"), default="parent",
                    help="the form of the calls at 128 and 640")
    ap.add_argument("--trace", action="store_true",
                    help="also print one row tile's timeline")
    ap.add_argument("--trap", action="store_true",
                    help="wait loops that trap after 10 s; check only")
    ap.add_argument("--build-only", action="store_true",
                    help="build and report ptxas spills, nothing more")
    ap.add_argument("--check-only", action="store_true",
                    help="hold the kernel to the plain version, time nothing")
    args = ap.parse_args()
    args.out = args.out.resolve()  # the generated sources include by path
    global FORM, TILE
    FORM = args.form
    if "kernel" not in args.variants:
        args.variants.insert(0, "kernel")
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    csrc = args.csrc.resolve()
    has_quad = QUAD_MARK in (csrc / "attn_out_ln.cuh").read_text()
    TILE = TILE_MARK in (csrc / "attn_out_ln.cuh").read_text()
    libs = build(csrc, args.widths, args.variants, args.out, args.trace,
                 args.trap)
    if args.build_only:
        return 0
    occ = ctypes.CDLL(str(libs.pop("occupancy")))
    occ.probe_clusters.argtypes = [ctypes.c_int] * 3
    occ.probe_clusters.restype = ctypes.c_int
    clusters = {f"{s} B": {f"1x1x{cz}": occ.probe_clusters(s, 1, cz)
                           for cz in (2, 4)} for s in SMEM_STEPS}
    print(f"clusters resident at once by shared memory a block: {clusters}",
          flush=True)
    readings, bad = {"clusters": clusters}, []
    check_only = args.check_only or args.trap
    cyc = None if check_only else sleep_cycles_per_ms()
    for h in args.widths:
        bound = {n: bind(libs[(n, h)], h) for n in args.variants}
        smem = bound["kernel"][f"mrd_attn_out_smem_bytes_h{h}"]()
        row = {"smem_bytes": smem}
        overlap = args.form == "overlap" and h == 640
        quad = has_quad and (h in QUAD_WIDTHS or overlap)
        if TILE and h == 128:  # the tile form has no probe variants
            bound = {"kernel": bound["kernel"]}
        for m in args.rows:
            e = check(bound["kernel"], h, m, dev)
            ok = (e["max"] <= ROW_ATOL and e["mean"] <= ROW_MEAN_ATOL
                  and e["same_bits"])
            print(f"H={h} M={m} ({e['slices']} slices): max/mean |kernel - "
                  f"plain| {e['max']:.3e} / {e['mean']:.3e}, same bits twice "
                  f"{e['same_bits']}"
                  + (f", bits of the one-block form {e['bits_of_parent']}"
                     f"{' (first differing ' + str(e['first_differing']) + ' of ' + str(e['n_differing']) + ')' if not e['bits_of_parent'] else ''}"
                     if "bits_of_parent" in e else "")
                  + f" {'ok' if ok else 'OFF'}", flush=True)
            row[f"M={m}"] = {"agreement": e}
            if not ok:
                bad.append(f"H={h} M={m}")
        readings[h] = row
        if args.trap:  # every variant once: a deadlock traps here
            for n in list(bound)[1:]:
                for m in args.rows:
                    call(bound[n], h, tensors(h, m, dev), plan_slices(h, m, dev),
                         dev)()
                    torch.cuda.synchronize()
            print(f"H={h}: every variant ran to its end", flush=True)
        if check_only:
            continue
        for m in args.rows:
            slices = plan_slices(h, m, dev)
            t = tensors(h, m, dev)
            fns = {n: call(lib, h, t, slices, dev) for n, lib in bound.items()}
            if overlap:  # the one-block form in the same turns
                fns["parent"] = call(bound["kernel"], h, t,
                                     plan_slices(h, m, dev, "parent"), dev)
            if m == 16384:
                fns.update(chain(t))
            for fn in fns.values():
                for _ in range(3):
                    fn()
            torch.cuda.synchronize()
            names = list(fns)
            runs = {n: [] for n in names}
            for n in names + names[::-1]:
                runs[n].append(per_call_ms(fns[n], cyc))
            ms = {n: sum(v) / len(v) for n, v in runs.items()}
            wb = wo_bytes(h, m, quad and slices <= 1)
            at = row[f"M={m}"]
            at.update(slices=slices, wo_bytes=wb,
                      ms={n: ms[n] for n in names}, runs=runs,
                      wo_TBps={n: wb / ms[n] / 1e9 for n in VARIANTS
                               if n in ms})
            print(f"H={h} M={m} ({slices} slices): dev ms " + ", ".join(
                f"{LABEL[n]} {ms[n]:.4f}" for n in names)
                + f" | Wo from L2 per call {wb / 1e6:.1f} MB; over each "
                f"kernel variant's time " + ", ".join(
                    f"{wb / ms[n] / 1e9:.2f}" for n in names if n in VARIANTS)
                + " TB/s", flush=True)
            if args.trace and not (TILE and h == 128):  # no stamps there
                at["timeline"] = timeline(bind(libs[("trace", h)], h), h, m,
                                          dev, quad and slices <= 1)
    print(json.dumps({"card": card, "rows": args.rows, "readings": readings,
                      "off": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
