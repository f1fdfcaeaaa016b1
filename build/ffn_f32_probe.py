#!/usr/bin/env python3
"""The launches and floors of K1-f32 and K2-f32 at H = 128 and 256 on the
card: the four-launch form of an earlier tree (the operands' TF32 planes,
gemm_tf32x3<kGelu> into h's planes, gemm_tf32x3<kPartial> into f32
partials, split_reduce_f32's LayerNorm) beside this tree's one-pass form
(csrc/ffn_rows_f32.cuh).

    mkdir -p build/old_5e786d2                   # the earlier tree, once
    git archive 5e786d2 | tar -x -C build/old_5e786d2
    python3 build/ffn_f32_probe.py [--old-dir DIR] [--out DIR]
        [--widths H ...] [--rows M ...] [--trap] [--build-only]

It builds `csrc/ffn_ln_f32.cu` of both trees (with `csrc/ffn_rows_f32.cu`
where the tree has it), as it is and from copies
into which `PATCHES` write the probes under MRD_FFN_PROBE (the earlier
tree: 1, the first GEMM stores no h; 2, only the split and the first GEMM
run, with clock64 stamps; 4, only the second GEMM runs, on planes nothing
wrote this call; this tree: 2, clock64 stamps of the pass; 3, the pass
also writes h's TF32 planes to a buffer; 5, the pass with no weight stream
after the ring's first fill: the products read it stale; floors, timed
only), one small library per tree and variant, all nvccs at once, into
`build/ffn_f32_probe/` (or --out). The package's sources hold none of the
probes. With --trap this tree's kernel is built from a copy whose wait
loops trap after 10 s (a deadlock then fails the launch instead of hanging
the card) and only checked.

At each width, kernel (K1, K2) and M (default 64, 1,024, 2,048, 4,224,
8,192, 16,384 and 16,385), F = 4H:
- the pass against the plain version with TF32 off (the f32 limits 1e-4
  max, 1e-5 mean; the script fails outside them) and the same bits on a
  second launch; h's planes against the earlier tree's (bit for bit, and
  max |new - old| of h = hi + lo) and max / mean |new - old| of y;
- device time per call in turns (old, old with no h store, old's second
  GEMM alone, new, new with no weight stream, then the same in reverse;
  CUDA events over 20 calls queued behind a spinning card), and each
  launch's device time from torch.profiler (split_operands, the two
  gemm_tf32x3, split_reduce_f32; split_weights_rows, ffn_rows_f32);
- from 4,224 rows a clock64 timeline: the earlier first GEMM's row tile
  40 (each k-tile: its wait for the ring, the issue and retire of the one
  before; the tile's start, window and end with the h store), and the
  pass's first tile (per chunk: stage 1 retired, the GELU, stage 2 issued;
  the tile's x, LN0, chunks and epilogue).

Prints the card's name and power limit first and a JSON line of every
reading last. Run it on the card, from the repository root.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "build"))
sys.path.insert(0, str(ROOT))

from attn_out_probe import _TRAP_BODY, _TRAP_WAITS  # noqa: E402
from h768_old_vs_new import per_call_ms, sleep_cycles_per_ms  # noqa: E402
from pair_probe import nvcc  # noqa: E402

from multimodal_rare_disease_tpu_torch.kernels.ffn import gemm_plan_f32  # noqa: E402

OLD_COMMIT = "5e786d2"
WIDTHS = (128, 256)
ROWS = (64, 1024, 2048, 4224, 8192, 16384, 16385)
F32_ATOL, F32_MEAN_ATOL = 1e-4, 1e-5
CSRC = Path("multimodal_rare_disease_tpu_torch") / "csrc"

_PRELUDE = r"""#ifndef MRD_FFN_PROBE
#define MRD_FFN_PROBE 0
#endif
#if MRD_FFN_PROBE == 2
// consumer thread 0 of the traced block: [k-tile or chunk][4 steps];
// [tile][step]
__device__ long long mrd_kt_trace[512][4];
__device__ long long mrd_tile_trace[64][8];
__device__ int mrd_kt_n;
#define MRD_TRACED \
  (blockIdx.x == 0 && blockIdx.y == (gridDim.y > 40 ? 40u : gridDim.y / 2) && blockIdx.z == 0)
#define MRD_RESET()                                                  \
  do {                                                               \
    if (MRD_TRACED && threadIdx.x == 0) mrd_kt_n = 0;                \
  } while (0)
#define MRD_KSTAMP(step)                                             \
  do {                                                               \
    if (MRD_TRACED && threadIdx.x == 0 && mrd_kt_n < 512) {          \
      mrd_kt_trace[mrd_kt_n][step] = clock64();                      \
      if (step == 3) ++mrd_kt_n;                                     \
    }                                                                \
  } while (0)
#define MRD_TSTAMP(it, step)                                         \
  do {                                                               \
    if (MRD_TRACED && threadIdx.x == 0 && (it) < 64)                 \
      mrd_tile_trace[it][step] = clock64();                          \
  } while (0)
#else
#define MRD_RESET()
#define MRD_KSTAMP(step)
#define MRD_TSTAMP(it, step)
#endif
#if MRD_FFN_PROBE == 3
__device__ float* mrd_h_out;  // h's planes [2][M][F]
#endif

"""

# (file, anchor, replacement, times) in both trees
PATCHES = (
    ("gemm_tf32x3.cuh", "namespace {\n\nusing mrd::fence_barrier_init;",
     _PRELUDE + "namespace {\n\nusing mrd::fence_barrier_init;", 1),
    ("gemm_tf32x3.cuh",
     "  mbar_wait(base + kBarFull + 8 * ring.slot, ring.phase);\n"
     "  const uint32_t st = opaque(base) + ring.slot * kStageBytes;\n",
     "  MRD_KSTAMP(0);\n  mbar_wait(base + kBarFull + 8 * ring.slot, ring.phase);\n"
     "  MRD_KSTAMP(1);\n  MRD_KSTAMP(2);\n"
     "  const uint32_t st = opaque(base) + ring.slot * kStageBytes;\n", 1),
    ("gemm_tf32x3.cuh", "  prev = ring.slot;\n  ring.next<kStages>();\n}\n",
     "  prev = ring.slot;\n  ring.next<kStages>();\n  MRD_KSTAMP(3);\n}\n", 1),
    ("gemm_tf32x3.cuh",
     "  if (threadIdx.x == 0) {\n    for (int s = 0; s < kStages; ++s) {\n",
     "  MRD_RESET();\n  if (threadIdx.x == 0) {\n    for (int s = 0; s < kStages; ++s) {\n", 1),
    ("gemm_tf32x3.cuh",
     "  mrd::setmaxnreg_inc<kConsumerRegs>();\n  const int wg = threadIdx.x / 128;\n",
     "  mrd::setmaxnreg_inc<kConsumerRegs>();\n  MRD_TSTAMP(0, 0);\n"
     "  const int wg = threadIdx.x / 128;\n", 1),
    ("gemm_tf32x3.cuh",
     "    for (int i = 0; i < 64; ++i) total[i] += big[i] + small[i];\n  }\n",
     "    for (int i = 0; i < 64; ++i) total[i] += big[i] + small[i];\n"
     "    MRD_TSTAMP(0, 1);\n  }\n", 1),
    ("gemm_tf32x3.cuh",
     "        *reinterpret_cast<float2*>(out_hi + gr * N + col) = make_float2(h0, h1);\n"
     "        *reinterpret_cast<float2*>(out_lo + gr * N + col) = make_float2(g0 - h0, g1 - h1);\n",
     "        if (MRD_FFN_PROBE != 1 || M < 0) {\n"
     "        *reinterpret_cast<float2*>(out_hi + gr * N + col) = make_float2(h0, h1);\n"
     "        *reinterpret_cast<float2*>(out_lo + gr * N + col) = make_float2(g0 - h0, g1 - h1);\n"
     "        }\n", 1),
    ("gemm_tf32x3.cuh",
     "            make_float2(total[i], total[i + 1]);\n      }\n    }\n  }\n}\n",
     "            make_float2(total[i], total[i + 1]);\n      }\n    }\n  }\n"
     "  MRD_TSTAMP(0, 2);\n}\n", 1),
    ("ffn_ln_f32.cu",
     "  split_operands<kH, kInputLN><<<row_blocks + w_blocks, kSplitThreads, 0, stream>>>(",
     "  if (MRD_FFN_PROBE != 4)\n"
     "  split_operands<kH, kInputLN><<<row_blocks + w_blocks, kSplitThreads, 0, stream>>>(", 1),
    ("ffn_ln_f32.cu", "  err = launch_gemm<kGelu>(",
     "  if (MRD_FFN_PROBE != 4) err = launch_gemm<kGelu>(", 1),
    ("ffn_ln_f32.cu", "  err = launch_gemm<kPartial>(",
     "  if (MRD_FFN_PROBE == 2) return cudaSuccess;\n  err = launch_gemm<kPartial>(", 1),
    ("ffn_ln_f32.cu",
     "  split_reduce_f32<kH, kInputLN><<<(M + 7) / 8, kSplitThreads, 0, stream>>>(",
     "  if (MRD_FFN_PROBE != 4)\n"
     "  split_reduce_f32<kH, kInputLN><<<(M + 7) / 8, kSplitThreads, 0, stream>>>(", 1),
)
# the one-pass form (this tree's header only)
ROWS_PATCHES = (
    ("ffn_rows_f32.cuh",
     "  if (threadIdx.x == 0) {\n    for (int s = 0; s < R::kSlots; ++s) {\n",
     "  MRD_RESET();\n  if (threadIdx.x == 0) {\n    for (int s = 0; s < R::kSlots; ++s) {\n", 1),
    ("ffn_rows_f32.cuh", "      mbar_arrive_expect_tx(full, R::kSlot);\n",
     "      if (MRD_FFN_PROBE == 5 && c > 0) {\n        mbar_arrive(full);\n"
     "        ring.next<R::kSlots>();\n        continue;\n      }\n"
     "      mbar_arrive_expect_tx(full, R::kSlot);\n", 2),
    ("ffn_rows_f32.cuh", "  mrd::setmaxnreg_inc<R::kRegs>();\n",
     "  mrd::setmaxnreg_inc<R::kRegs>();\n  MRD_TSTAMP(0, 0);\n", 1),
    ("ffn_rows_f32.cuh", "  mbar_wait(base + R::kBarX, 0);\n",
     "  mbar_wait(base + R::kBarX, 0);\n  MRD_TSTAMP(0, 1);\n", 1),
    ("ffn_rows_f32.cuh",
     "  // x's row r in the buffer, at the thread's k column q of a k8 step\n",
     "  MRD_TSTAMP(0, 2);\n"
     "  // x's row r in the buffer, at the thread's k column q of a k8 step\n", 1),
    ("ffn_rows_f32.cuh", "    // ---- stage 1: s1 = x_hi . [W1_hi | W1_lo] + x_lo . [W1_hi | W1_lo]\n",
     "    MRD_KSTAMP(0);\n"
     "    // ---- stage 1: s1 = x_hi . [W1_hi | W1_lo] + x_lo . [W1_hi | W1_lo]\n", 1),
    ("ffn_rows_f32.cuh",
     "    drain<kH>(feed, a, base, signal);\n    mrd::fence_operand(s1);\n",
     "    drain<kH>(feed, a, base, signal);\n    mrd::fence_operand(s1);\n    MRD_KSTAMP(1);\n", 1),
    ("ffn_rows_f32.cuh",
     "        s1[i + 1] = 0.5f * v1 * (1.0f + erff(v1 * 0.70710678118654752f));\n",
     "        s1[i + 1] = 0.5f * v1 * (1.0f + erff(v1 * 0.70710678118654752f));\n"
     "#if MRD_FFN_PROBE == 3\n"
     "        {\n"
     "          const long long gr = row0 + r + 8 * half;\n"
     "          const long long col = R::kChunk * c + 8 * nb + 2 * q;\n"
     "          if (gr < M) {\n"
     "            const float h0 = tf32_rna(s1[i]), h1 = tf32_rna(s1[i + 1]);\n"
     "            float* o = mrd_h_out + gr * F + col;\n"
     "            o[0] = h0;\n            o[1] = h1;\n"
     "            o[static_cast<long long>(M) * F] = s1[i] - h0;\n"
     "            o[static_cast<long long>(M) * F + 1] = s1[i + 1] - h1;\n"
     "          }\n"
     "        }\n"
     "#endif\n", 1),
    ("ffn_rows_f32.cuh", "    // ---- stage 2: h's planes from s1",
     "    MRD_KSTAMP(2);\n    // ---- stage 2: h's planes from s1", 1),
    ("ffn_rows_f32.cuh",
     "    if constexpr (R::kWindowed) {\n      // a window's end before the last",
     "    MRD_KSTAMP(3);\n"
     "    if constexpr (R::kWindowed) {\n      // a window's end before the last", 1),
    ("ffn_rows_f32.cuh", "  // ---- epilogue. Per 128-column half",
     "  MRD_TSTAMP(0, 3);\n  // ---- epilogue. Per 128-column half", 1),
    ("ffn_rows_f32.cuh", "    mrd::tma_store_commit();\n    mrd::tma_store_wait();\n",
     "    mrd::tma_store_commit();\n    MRD_TSTAMP(0, 4);\n    mrd::tma_store_wait();\n", 1),
)

SOURCE = r"""#include "ffn_ln_f32.cu"
#if __has_include("ffn_rows_f32.cu")
#include "ffn_rows_f32.cu"
#endif
extern "C" {
const char* mrd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
#if MRD_FFN_PROBE == 2
int mrd_probe_trace(void* kt, void* tile, void* n) {
  cudaError_t e = cudaMemcpyFromSymbol(kt, mrd_kt_trace, sizeof(mrd_kt_trace));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(tile, mrd_tile_trace, sizeof(mrd_tile_trace));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(n, mrd_kt_n, sizeof(int));
  return static_cast<int>(e);
}
#endif
#if MRD_FFN_PROBE == 3
int mrd_probe_set_h(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(mrd_h_out, &p, sizeof(p)));
}
#endif
}
"""


def patched(csrc: Path, dst: Path, rows: bool, trap: bool = False) -> Path:
    """A copy of `csrc` in `dst` with the probes (PATCHES; ROWS_PATCHES
    where the one-pass form exists) or, with `trap`, only with wait loops
    that trap after 10 s. Raises where an anchor is missing."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    if trap:
        hop = dst / "hopper.cuh"
        text = hop.read_text()
        for loop in _TRAP_WAITS:
            if text.count(loop) != 1:
                raise SystemExit(f"wait loop not found once in {hop}:\n{loop}")
            head = loop.split("{\n", 1)[0]
            try_wait = loop.split("while (!", 1)[1].split("(", 1)[0]
            text = text.replace(loop, head + _TRAP_BODY.replace("{try_wait}", try_wait))
        hop.write_text(text)
        return dst
    for name, anchor, repl, times in PATCHES + (ROWS_PATCHES if rows else ()):
        f = dst / name
        text = f.read_text()
        if text.count(anchor) != times:
            raise SystemExit(f"probe anchor found {text.count(anchor)} times, not {times}, "
                             f"in {csrc / name}:\n{anchor}")
        f.write_text(text.replace(anchor, repl))
    return dst


def build(trees: dict, out: Path, trap: bool) -> dict:
    """{variant: library}, one nvcc each, all at once."""
    out.mkdir(parents=True, exist_ok=True)
    if trap:
        srcs = {"new": patched(trees["new"], out / "new_trap", rows=False, trap=True)}
        variants = {"new": ("new", 0)}
    else:
        srcs = {"old": trees["old"], "new": trees["new"],
                "old_probe": patched(trees["old"], out / "old_probe", rows=False),
                "new_probe": patched(trees["new"], out / "new_probe", rows=True)}
        variants = {"old": ("old", 0), "old_noh": ("old_probe", 1),
                    "old_trace": ("old_probe", 2), "old_gemm2": ("old_probe", 4),
                    "new": ("new", 0), "new_trace": ("new_probe", 2),
                    "new_h": ("new_probe", 3), "new_nowt": ("new_probe", 5)}
    cmds, libs = [], {}
    for v, (tree, probe) in variants.items():
        src = out / f"{v}.cu"
        src.write_text(SOURCE)
        lib = out / f"lib_{v}.so"
        cmds.append([nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                     "-Xcompiler", "-fPIC", "-shared", "-Xptxas=-v", f"-DMRD_FFN_PROBE={probe}",
                     "-I", str(srcs[tree]), "-o", str(lib), str(src)])
        libs[v] = lib

    def run(cmd):
        return subprocess.run(cmd, capture_output=True, text=True)

    with ThreadPoolExecutor(len(cmds)) as ex:
        done = list(ex.map(run, cmds))
    log = ""
    for cmd, r in zip(cmds, done):
        log += r.stdout + r.stderr
        if r.returncode != 0:
            raise SystemExit(f"nvcc failed: {' '.join(cmd)}\n{r.stdout}{r.stderr}")
    (out / "ptxas.log").write_text(log)
    lines = log.splitlines()
    spills = [f"{lines[i - 1].strip()} | {ln.strip()}" for i, ln in enumerate(lines)
              if "spill" in ln and " 0 bytes spill" not in ln]
    warns = [ln for ln in lines if "warning" in ln.lower()]
    print(f"ptxas: {len(spills)} lines with spill bytes, {len(warns)} warnings", flush=True)
    for ln in (spills + warns)[:20]:
        print("  " + ln.strip(), flush=True)
    # the pass's registers and spills, once per width and kernel
    seen = set()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and "ffn_rows_f32" in ln and ln not in seen:
            seen.add(ln)
            print("  " + " | ".join(x.strip() for x in lines[i:i + 4]), flush=True)
    return libs


def bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for h in WIDTHS:
        k1 = getattr(lib, f"mrd_ffn_pre_ln_f32_h{h}")
        k1.argtypes, k1.restype = [p] * 11 + [i, i, i, f, p], i
        k2 = getattr(lib, f"mrd_ffn_ln_f32_h{h}")
        k2.argtypes, k2.restype = [p] * 9 + [i, i, i, f, p], i
    if hasattr(lib, "mrd_probe_trace"):
        lib.mrd_probe_trace.argtypes, lib.mrd_probe_trace.restype = [p] * 3, i
    if hasattr(lib, "mrd_probe_set_h"):
        lib.mrd_probe_set_h.argtypes, lib.mrd_probe_set_h.restype = [p], i
    lib.mrd_error_string.argtypes, lib.mrd_error_string.restype = [i], ctypes.c_char_p
    return lib


def tensors(h: int, m: int, slices: int, dev) -> dict:
    f = 4 * h
    gen = torch.Generator().manual_seed(h + m)

    def rnd(shape, scale, offset=0.0):
        return (torch.randn(shape, generator=gen) * scale + offset).to(dev)

    # nn.Linear's [out, in]: W1^T [F, H] and W2^T [H, F], as the kernels
    # read them; the four launches' scratch with `slices` partials
    scratch = 2 * m * h + 4 * f * h + 2 * m * f + slices * m * h
    return dict(z=rnd((m, h), 1.0), w1t=rnd((f, h), 0.05), w2t=rnd((h, f), 0.05),
                b1=rnd((f,), 0.5), b2=rnd((h,), 0.5), gamma=rnd((h,), 0.25, 1.0),
                beta=rnd((h,), 0.5), g0=rnd((h,), 0.25, 1.0), o0=rnd((h,), 0.5),
                y=torch.empty(m, h, device=dev), scratch=torch.empty(scratch, device=dev))


def caller(lib: ctypes.CDLL, h: int, t: dict, k1: bool, slices: int):
    """A call of `lib`'s K1 (or K2) entry at width h on `t` with `slices`
    (0, in this tree: the one-pass form)."""
    m, f = t["z"].shape[0], t["w1t"].shape[0]
    names = ["z", "w1t", "b1", "w2t", "b2", "gamma", "beta"] + (["g0", "o0"] if k1 else [])
    fn = getattr(lib, f"mrd_ffn_pre_ln_f32_h{h}" if k1 else f"mrd_ffn_ln_f32_h{h}")

    def call():
        err = fn(*(t[k].data_ptr() for k in names), t["y"].data_ptr(), t["scratch"].data_ptr(),
                 m, f, slices, 1e-12, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"H={h} M={m}: {lib.mrd_error_string(err).decode()}")
        return t["y"]
    return call


def plain(t: dict, k1: bool) -> torch.Tensor:
    def ln(v, g, o):
        mu = v.mean(1, keepdim=True)
        var = ((v - mu) ** 2).mean(1, keepdim=True)
        return (v - mu) * torch.rsqrt(var + 1e-12) * g + o

    x = ln(t["z"], t["g0"], t["o0"]) if k1 else t["z"]
    hh = x @ t["w1t"].t() + t["b1"]
    hh = 0.5 * hh * (1.0 + torch.erf(hh * 0.7071067811865476))
    return ln(hh @ t["w2t"].t() + t["b2"] + x, t["gamma"], t["beta"])


_LAUNCHES = ("split_operands", "Epilogue)0", "Epilogue)1", "split_reduce_f32",
             "split_weights_rows", "ffn_rows_f32")


def launch_split(fn) -> dict:
    """Device ms per call of each kernel one call launches (torch.profiler
    over 20 calls); the two GEMMs by their epilogue (0: kGelu, 1:
    kPartial)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        for key in _LAUNCHES:
            if key in ev.key:
                t = getattr(ev, "device_time_total", None) or ev.cuda_time_total
                name = {"Epilogue)0": "gemm_gelu", "Epilogue)1": "gemm_partial"}.get(key, key)
                out[name] = out.get(name, 0.0) + t / 1e3 / 20
    return out


def timeline(lib: ctypes.CDLL, call) -> dict:
    """The stamps of one traced call, in clk from its first stamp."""
    call()
    torch.cuda.synchronize()
    kt = (ctypes.c_longlong * (512 * 4))()
    tile = (ctypes.c_longlong * (64 * 8))()
    n = ctypes.c_int()
    if lib.mrd_probe_trace(kt, tile, ctypes.byref(n)):
        raise RuntimeError("trace read failed")
    kts = [[kt[4 * i + j] for j in range(4)] for i in range(n.value)]
    tiles = [[tile[8 * i + j] for j in range(8)] for i in range(1)]
    t0 = min(v for v in [*(r[0] for r in kts), *(r[0] for r in tiles)] if v)
    rel = lambda rows: [[v - t0 if v else None for v in r] for r in rows]  # noqa: E731
    return {"steps": rel(kts), "tile": rel(tiles)[0]}


def summary(tl: dict, new: bool) -> str:
    """Medians per k-tile (old) or chunk (new) and the tile's steps, clk."""
    def med(v):
        v = sorted(x for x in v if x is not None)
        return v[len(v) // 2] if v else None

    k = [r for r in tl["steps"] if None not in r]
    step = med([k[i + 1][0] - k[i][0] for i in range(len(k) - 1)])
    t = tl["tile"]
    tile = " ".join("-" if v is None else str(v) for v in t)
    if new:
        return (f"per chunk median clk: start to start {step}, stage 1 "
                f"{med([r[1] - r[0] for r in k])}, GELU {med([r[2] - r[1] for r in k])}, "
                f"stage 2 issued {med([r[3] - r[2] for r in k])} ({len(k)} chunks) | tile "
                f"(start, x there, LN0 done, chunks done, y issued): {tile}")
    first_wait = k[0][1] - k[0][0] if k else None
    return (f"per k-tile median clk: start to start {step}, ring wait "
            f"{med([r[1] - r[0] for r in k])}, issue + retire {med([r[3] - r[2] for r in k])} "
            f"({len(k)} k-tiles; the first's wait, the ring's fill, {first_wait}) | tile "
            f"(start, window summed, h stored): {tile}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-dir", type=Path, default=ROOT / "build" / f"old_{OLD_COMMIT}")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "ffn_f32_probe")
    ap.add_argument("--widths", type=int, nargs="*", default=WIDTHS)
    ap.add_argument("--rows", type=int, nargs="*", default=ROWS)
    ap.add_argument("--trap", action="store_true", help="check only, trapping waits")
    ap.add_argument("--build-only", action="store_true")
    args = ap.parse_args()
    if not args.trap and not (args.old_dir / CSRC / "ffn_ln_f32.cu").is_file():
        raise SystemExit(f"{args.old_dir} is missing: mkdir -p {args.old_dir} && git archive "
                         f"{OLD_COMMIT} | tar -x -C {args.old_dir}")
    libs = build({"old": args.old_dir / CSRC, "new": ROOT / CSRC}, args.out, args.trap)
    if args.build_only:
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = {v: bind(p) for v, p in libs.items()}
    cyc = None if args.trap else sleep_cycles_per_ms()
    readings, bad = {}, []
    for h in args.widths:
        f = 4 * h
        for m in args.rows:
            slices = gemm_plan_f32(m, f, n_sm, h)[1]  # the four launches' plan
            t = tensors(h, m, slices, dev)
            for k1 in (True, False):
                key = f"{'K1' if k1 else 'K2'}-f32 H={h} M={m}"
                new = caller(lib["new"], h, t, k1, 0)
                got = new().clone()
                again = new().clone()
                d = (got - plain(t, k1)).abs()
                err = (d.max().item(), d.mean().item())
                ok = torch.equal(got, again) and err[0] <= F32_ATOL and err[1] <= F32_MEAN_ATOL
                readings[f"{key} check"] = dict(err=err, same_bits_twice=torch.equal(got, again))
                print(f"{key}: new vs plain {err[0]:.3e} / {err[1]:.3e}, same bits twice "
                      f"{torch.equal(got, again)} {'ok' if ok else 'OFF'}", flush=True)
                if not ok:
                    bad.append(f"{key} check")
                if args.trap:
                    continue
                old = caller(lib["old"], h, t, k1, slices)
                y_old = old().clone()
                do = (y_old - plain(t, k1)).abs()
                h_old = t["scratch"][2 * m * h + 4 * f * h:][:2 * m * f].clone()
                h_new = torch.full((2 * m * f,), float("nan"), device=dev)
                if lib["new_h"].mrd_probe_set_h(h_new.data_ptr()):
                    raise RuntimeError("mrd_probe_set_h failed")
                caller(lib["new_h"], h, t, k1, 0)()
                torch.cuda.synchronize()
                same_h = torch.equal(h_old, h_new)
                # h = hi + lo: a value on a TF32 rounding boundary may move
                # between the planes
                dh = ((h_old[:m * f] + h_old[m * f:]) - (h_new[:m * f] + h_new[m * f:]))
                dh = dh.abs().max().item()
                apart = (got - y_old).abs()
                readings[f"{key} bits"] = dict(
                    max_new_old=apart.max().item(), mean_new_old=apart.mean().item(),
                    h_equal=same_h, h_max_diff=dh,
                    err_old=(do.max().item(), do.mean().item()))
                print(f"{key}: max / mean |new - old| {apart.max().item():.3e} / "
                      f"{apart.mean().item():.3e} (old vs plain {do.max().item():.3e} / "
                      f"{do.mean().item():.3e}); h's planes equal the old's {same_h} "
                      f"(h = hi + lo: max |new - old| {dh:.3e})", flush=True)
                fns = {"old": old, "old_noh": caller(lib["old_noh"], h, t, k1, slices),
                       "old_gemm2": caller(lib["old_gemm2"], h, t, k1, slices), "new": new,
                       "new_nowt": caller(lib["new_nowt"], h, t, k1, 0)}
                runs = {n: [] for n in fns}
                for n in list(fns) + list(fns)[::-1]:
                    runs[n].append(per_call_ms(fns[n], cyc))
                ms = {n: sum(v) / len(v) for n, v in runs.items()}
                split = {"old": launch_split(old), "new": launch_split(new)}
                readings[f"{key} ms"] = dict(ms=ms, runs=runs, launches=split, slices=slices)
                print(f"{key}: dev ms old {ms['old']:.4f} ({slices} slices), old with no h "
                      f"store {ms['old_noh']:.4f}, old's second GEMM alone "
                      f"{ms['old_gemm2']:.4f}, new {ms['new']:.4f} (new/old "
                      f"{ms['new'] / ms['old']:.4f}), new with no weight stream "
                      f"{ms['new_nowt']:.4f}; per launch old "
                      + ", ".join(f"{k} {v:.4f}" for k, v in split["old"].items()) + "; new "
                      + ", ".join(f"{k} {v:.4f}" for k, v in split["new"].items()), flush=True)
                if m >= 4096 and k1:
                    for v in ("old_trace", "new_trace"):
                        tl = timeline(lib[v], caller(lib[v], h, t, k1,
                                                     0 if v.startswith("new") else slices))
                        readings[f"{key} {v}"] = tl
                        print(f"{key} {v}: {summary(tl, v.startswith('new'))}", flush=True)
    print(json.dumps({"card": card, "readings": readings, "off": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
