#!/usr/bin/env python3
"""The launches and floors of K3-f32 at its narrow widths (H = 128, 256,
384, 512 and 640) on the card: the three-launch form of an earlier tree
(Wo's TF32 planes, the 3xTF32 GEMM into f32 partials, split_reduce_f32's
LayerNorm) beside this tree's pass over whole rows
(csrc/attn_out_rows_f32.cuh).

    mkdir -p build/old_6b702b9                   # the earlier tree, once
    git archive 6b702b9 | tar -x -C build/old_6b702b9
    python3 build/attn_out_f32_probe.py [--old-dir DIR] [--out DIR]
        [--widths H ...] [--rows M ...] [--trap] [--build-only]

It builds `csrc/attn_out_ln_f32.cu` of both trees, as it is and from
copies into which `PATCHES` write the probes under MRD_F32_PROBE (1: the
GEMM stores no partial, 2: clock64 stamps, 3: the pass over whole rows
writes its pre-LayerNorm sums in place of y, 4: the pass with no Wo
stream, 5: with no ctx stream: the producer loads that operand for the
first tile's first stages only, and the products read it stale after;
floors of the k loop, timed only), one small library per tree and
variant, all nvccs at once, into `build/attn_out_f32_probe/` (or
--out). The
package's sources hold none of the probes. With --trap this tree's kernel
is built from a copy whose wait loops trap after 10 s (a deadlock then
fails the launch instead of hanging the card) and only checked.

At each width and M (default 16,384 and 64), with one slice of the k loop
(the plan at the packed batch):
- the pass over whole rows against the plain version with TF32 off (the
  f32 limits 1e-4 max, 1e-5 mean), the same bits on a second launch, and
  its pre-LayerNorm sums against the earlier tree's partials + bo + x
  (equal bit for bit, or the script fails);
- device time per call in turns (old, old with no partial store, new,
  new with no Wo stream, new with no ctx stream, then the same in
  reverse; CUDA events over 20 calls queued behind a
  spinning card), and each launch's device time from torch.profiler
  (split_weight, gemm_tf32x3, split_reduce_f32, attn_out_rows_f32);
- at 16,384 rows a clock64 timeline: the earlier GEMM's row tile 40
  (each k-tile: its wait for the ring, the split of ctx, the issue and
  the retire of the one before; each window's drain; the partial store),
  and the tiles of the pass's first cluster (per k-tile its wait for the
  ring and the issue and retire of its groups, then x there, each
  LayerNorm exchange, y's store issued; its producer's first load and x's
  load per tile);
- the clusters the card holds at once (cudaOccupancyMaxActiveClusters).

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

from attn_out_probe import _TRAP_BODY, _TRAP_WAITS  # noqa: E402
from h768_old_vs_new import per_call_ms, sleep_cycles_per_ms  # noqa: E402
from pair_probe import nvcc  # noqa: E402

OLD_COMMIT = "6b702b9"
WIDTHS = (128, 256, 384, 512, 640)
F32_ATOL, F32_MEAN_ATOL = 1e-4, 1e-5
CSRC = Path("multimodal_rare_disease_tpu_torch") / "csrc"

_PRELUDE = r"""#ifndef MRD_F32_PROBE
#define MRD_F32_PROBE 0
#endif
#if MRD_F32_PROBE == 2
// consumer thread 0 of the traced block: [k-tile][wait starts, stage there,
// split done, group issued and the one before retired]; [tile][step]; the
// producer thread: [tile][first load, x's load]
__device__ long long mrd_kt_trace[512][4];
__device__ long long mrd_tile_trace[64][8];
__device__ long long mrd_prod_trace[64][2];
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
#define MRD_PSTAMP(it, step)                                         \
  do {                                                               \
    if (MRD_TRACED && (it) < 64) mrd_prod_trace[it][step] = clock64(); \
  } while (0)
#else
#define MRD_RESET()
#define MRD_KSTAMP(step)
#define MRD_TSTAMP(it, step)
#define MRD_PSTAMP(it, step)
#endif

"""

# (file, anchor, replacement, times: None = at least once)
PATCHES = (
    ("gemm_tf32x3.cuh", "namespace {\n\nusing mrd::fence_barrier_init;",
     _PRELUDE + "namespace {\n\nusing mrd::fence_barrier_init;", 1),
    ("gemm_tf32x3.cuh",
     "  mbar_wait(base + kBarFull + 8 * ring.slot, ring.phase);\n"
     "  const uint32_t st = opaque(base) + ring.slot * kStageBytes;\n",
     "  MRD_KSTAMP(0);\n  mbar_wait(base + kBarFull + 8 * ring.slot, ring.phase);\n"
     "  MRD_KSTAMP(1);\n  const uint32_t st = opaque(base) + ring.slot * kStageBytes;\n", 1),
    ("gemm_tf32x3.cuh", "  if constexpr (kSplitA) split_a(a_hi, wg);\n",
     "  if constexpr (kSplitA) split_a(a_hi, wg);\n  MRD_KSTAMP(2);\n", 1),
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
     "    if (signal) mbar_arrive(base + kBarEmpty + 8 * prev);\n#pragma unroll\n"
     "    for (int i = 0; i < 64; ++i) total[i] += big[i] + small[i];\n  }\n",
     "    if (signal) mbar_arrive(base + kBarEmpty + 8 * prev);\n#pragma unroll\n"
     "    for (int i = 0; i < 64; ++i) total[i] += big[i] + small[i];\n"
     "    MRD_TSTAMP(0, 1 + t0 / kWindow);\n  }\n", 1),
    ("gemm_tf32x3.cuh",
     "        *reinterpret_cast<float2*>(dst + col) =\n"
     "            make_float2(total[i], total[i + 1]);\n      }\n    }\n  }\n}\n",
     "        if (MRD_F32_PROBE != 1 || N < 0)\n"
     "        *reinterpret_cast<float2*>(dst + col) =\n"
     "            make_float2(total[i], total[i + 1]);\n      }\n    }\n  }\n"
     "  MRD_TSTAMP(0, 7);\n}\n", 1),
)
# the pass over whole rows (this tree's header only)
ROWS_PATCHES = (
    ("attn_out_rows_f32.cuh",
     "  if (threadIdx.x == 0) {\n    for (int s = 0; s < kStages; ++s) {\n",
     "  MRD_RESET();\n  if (threadIdx.x == 0) {\n    for (int s = 0; s < kStages; ++s) {\n", 1),
    ("attn_out_rows_f32.cuh",
     "  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {\n    const int row0 = t * kBM;\n",
     "  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {\n    const int row0 = t * kBM;\n"
     "    MRD_PSTAMP(it, 0);\n", 1),
    ("attn_out_rows_f32.cuh",
     "    mbar_arrive_expect_tx(full, 4 * kTileBytes);\n",
     "    MRD_PSTAMP(it, 1);\n    mbar_arrive_expect_tx(full, 4 * kTileBytes);\n", 1),
    ("attn_out_rows_f32.cuh",
     "  mbar_wait(base + R::kBarFull + 8 * ring.slot, ring.phase);\n"
     "  const uint32_t st = opaque(base) + ring.slot * R::kStage;\n",
     "  MRD_KSTAMP(0);\n  mbar_wait(base + R::kBarFull + 8 * ring.slot, ring.phase);\n"
     "  MRD_KSTAMP(1);\n  MRD_KSTAMP(2);\n"
     "  const uint32_t st = opaque(base) + ring.slot * R::kStage;\n", 1),
    ("attn_out_rows_f32.cuh", "  prev = ring.slot;\n  ring.next<kStages>();\n}\n",
     "  prev = ring.slot;\n  ring.next<kStages>();\n  MRD_KSTAMP(3);\n}\n", 1),
    ("attn_out_rows_f32.cuh",
     "      mbar_arrive_expect_tx(full, R::kStage);\n"
     "      tma_load_2d(dst, ctx, full, k * kBK, row0);\n"
     "      tma_load_2d(dst + kTileBytes, b_hi, full, k * kBK, col0);\n"
     "      tma_load_2d(dst + 2 * kTileBytes, b_lo, full, k * kBK, col0);\n",
     "#if MRD_F32_PROBE == 4 || MRD_F32_PROBE == 5\n"
     "      const bool mrd_first = it == 0 && k < kStages;\n"
     "      const bool mrd_a = MRD_F32_PROBE == 4 || mrd_first;\n"
     "      const bool mrd_b = MRD_F32_PROBE == 5 || mrd_first;\n"
     "      mbar_arrive_expect_tx(full, (mrd_a ? kTileBytes : 0u) + (mrd_b ? 2 * kTileBytes : 0u));\n"
     "      if (mrd_a) tma_load_2d(dst, ctx, full, k * kBK, row0);\n"
     "      if (mrd_b) tma_load_2d(dst + kTileBytes, b_hi, full, k * kBK, col0);\n"
     "      if (mrd_b) tma_load_2d(dst + 2 * kTileBytes, b_lo, full, k * kBK, col0);\n"
     "#else\n"
     "      mbar_arrive_expect_tx(full, R::kStage);\n"
     "      tma_load_2d(dst, ctx, full, k * kBK, row0);\n"
     "      tma_load_2d(dst + kTileBytes, b_hi, full, k * kBK, col0);\n"
     "      tma_load_2d(dst + 2 * kTileBytes, b_lo, full, k * kBK, col0);\n"
     "#endif\n", 1),
    ("attn_out_rows_f32.cuh", "      if (t >= n_tiles) break;\n",
     "      if (t >= n_tiles) break;\n      MRD_TSTAMP(it, 0);\n", 1),
    ("attn_out_rows_f32.cuh",
     "        for (int i = 0; i < 64; ++i) total[i] += big[i] + small[i];\n      }\n",
     "        for (int i = 0; i < 64; ++i) total[i] += big[i] + small[i];\n"
     "        MRD_TSTAMP(it, 1 + t0 / kWindow);\n      }\n", 1),
    ("attn_out_rows_f32.cuh", "      mbar_wait(base + R::kBarXFull, it & 1);\n",
     "      mbar_wait(base + R::kBarXFull, it & 1);\n      MRD_TSTAMP(it, 4);\n", 1),
    ("attn_out_rows_f32.cuh", "      over_cluster(0);\n",
     "      over_cluster(0);\n      MRD_TSTAMP(it, 5);\n", 1),
    ("attn_out_rows_f32.cuh", "      over_cluster(1);\n",
     "      over_cluster(1);\n      MRD_TSTAMP(it, 6);\n", 1),
    ("attn_out_rows_f32.cuh",
     "                         (total[i] - mu[half]) * rstd[half] * g.x + o.x,\n"
     "                         (total[i + 1] - mu[half]) * rstd[half] * g.y + o.y);\n",
     "#if MRD_F32_PROBE == 3\n                         total[i], total[i + 1]);\n#else\n"
     "                         (total[i] - mu[half]) * rstd[half] * g.x + o.x,\n"
     "                         (total[i + 1] - mu[half]) * rstd[half] * g.y + o.y);\n#endif\n",
     1),
    ("attn_out_rows_f32.cuh",
     "        mrd::tma_store_commit();\n      }\n    }\n    if (stores)",
     "        mrd::tma_store_commit();\n      }\n      MRD_TSTAMP(it, 7);\n    }\n    if (stores)", 1),
)

SOURCE = r"""#include "attn_out_ln_f32.cu"
extern "C" {
const char* mrd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
#if MRD_F32_PROBE == 2
int mrd_probe_trace(void* kt, void* tile, void* prod, void* n) {
  cudaError_t e = cudaMemcpyFromSymbol(kt, mrd_kt_trace, sizeof(mrd_kt_trace));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(tile, mrd_tile_trace, sizeof(mrd_tile_trace));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(prod, mrd_prod_trace, sizeof(mrd_prod_trace));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(n, mrd_kt_n, sizeof(int));
  return static_cast<int>(e);
}
#endif
}
"""


def patched(csrc: Path, dst: Path, rows: bool, trap: bool = False) -> Path:
    """A copy of `csrc` in `dst` with the probes (PATCHES; ROWS_PATCHES
    where the pass over whole rows exists) or, with `trap`, only with wait
    loops that trap after 10 s. Raises where an anchor is missing."""
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
    srcs = {"old": trees["old"], "new": trees["new"]}
    srcs["old_probe"] = patched(trees["old"], out / "old_probe", rows=False)
    srcs["new_probe"] = patched(trees["new"], out / "new_probe", rows=True)
    if trap:
        srcs["new"] = patched(trees["new"], out / "new_trap", rows=False, trap=True)
    variants = {"old": ("old", 0), "old_nostore": ("old_probe", 1), "old_trace": ("old_probe", 2),
                "new": ("new", 0), "new_trace": ("new_probe", 2), "new_preln": ("new_probe", 3),
                "new_nowo": ("new_probe", 4), "new_noctx": ("new_probe", 5)}
    if trap:
        variants = {"new": ("new", 0)}
    cmds, libs = [], {}
    for v, (tree, probe) in variants.items():
        src = out / f"{v}.cu"
        src.write_text(SOURCE)
        lib = out / f"lib_{v}.so"
        cmds.append([nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                     "-Xcompiler", "-fPIC", "-shared", "-Xptxas=-v", f"-DMRD_F32_PROBE={probe}",
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
    spills = [ln for ln in log.splitlines() if "spill" in ln and " 0 bytes spill" not in ln]
    warns = [ln for ln in log.splitlines() if "warning" in ln.lower()]
    print(f"ptxas: {len(spills)} lines with spill bytes, {len(warns)} warnings", flush=True)
    for ln in (spills + warns)[:20]:
        print("  " + ln.strip(), flush=True)
    return libs


def bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for h in WIDTHS:
        fn = getattr(lib, f"mrd_attn_out_ln_f32_h{h}")
        fn.argtypes, fn.restype = [p] * 8 + [i, i, f, p], i
        cl = getattr(lib, f"mrd_attn_out_f32_clusters_h{h}", None)
        if cl is not None:
            cl.argtypes, cl.restype = [], i
    if hasattr(lib, "mrd_probe_trace"):
        lib.mrd_probe_trace.argtypes, lib.mrd_probe_trace.restype = [p] * 4, i
    lib.mrd_error_string.argtypes, lib.mrd_error_string.restype = [i], ctypes.c_char_p
    return lib


def tensors(h: int, m: int, dev) -> dict:
    gen = torch.Generator().manual_seed(h + m)

    def rnd(shape, scale, offset=0.0):
        return (torch.randn(shape, generator=gen) * scale + offset).to(dev)

    wo = rnd((h, h), 0.05)  # nn.Linear's [out, in]: the kernel's Wo^T
    return dict(ctx=rnd((m, h), 1.0), x=rnd((m, h), 1.0), wot=wo, bo=rnd((h,), 0.5),
                gamma=rnd((h,), 0.25, 1.0), beta=rnd((h,), 0.5),
                y=torch.empty(m, h, device=dev),
                scratch=torch.empty(2 * h * h + m * h, device=dev))


def caller(lib: ctypes.CDLL, h: int, t: dict, slices: int):
    """A call of `lib`'s entry at width h on `t` with `slices` (1: the
    three launches with the k loop whole; 0, in this tree: the pass over
    whole rows)."""
    fn = getattr(lib, f"mrd_attn_out_ln_f32_h{h}")
    m = t["ctx"].shape[0]

    def call():
        err = fn(*(t[k].data_ptr() for k in ("ctx", "x", "wot", "bo", "gamma", "beta", "y",
                                             "scratch")),
                 m, slices, 1e-12, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"H={h} M={m}: {lib.mrd_error_string(err).decode()}")
        return t["y"]
    return call


def plain(t: dict) -> torch.Tensor:
    z = t["ctx"] @ t["wot"].t() + t["bo"] + t["x"]
    mu = z.mean(1, keepdim=True)
    var = ((z - mu) ** 2).mean(1, keepdim=True)
    return (z - mu) * torch.rsqrt(var + 1e-12) * t["gamma"] + t["beta"]


def launch_split(fn) -> dict:
    """Device ms per call of each kernel one call launches (torch.profiler
    over 20 calls)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        for key in ("split_weight", "gemm_tf32x3", "split_reduce_f32", "attn_out_rows_f32"):
            if key in ev.key:
                t = getattr(ev, "device_time_total", None) or ev.cuda_time_total
                out[key] = out.get(key, 0.0) + t / 1e3 / 20
    return out


def timeline(lib: ctypes.CDLL, call, hz_per_ms: float) -> dict:
    """The stamps of one traced call, in clk from its first stamp."""
    call()
    torch.cuda.synchronize()
    kt = (ctypes.c_longlong * (512 * 4))()
    tile = (ctypes.c_longlong * (64 * 8))()
    prod = (ctypes.c_longlong * (64 * 2))()
    n = ctypes.c_int()
    if lib.mrd_probe_trace(kt, tile, prod, ctypes.byref(n)):
        raise RuntimeError("trace read failed")
    kts = [[kt[4 * i + j] for j in range(4)] for i in range(n.value)]
    tiles = [[tile[8 * i + j] for j in range(8)] for i in range(64)]
    tiles = [r for r in tiles if r[0]]
    prods = [[prod[2 * i + j] for j in range(2)] for i in range(len(tiles))]
    t0 = min(v for v in [*(r[0] for r in kts), *(r[0] for r in tiles), *(p[0] for p in prods)]
             if v)
    rel = lambda rows: [[v - t0 if v else None for v in r] for r in rows]  # noqa: E731
    return {"k_tiles": rel(kts), "tiles": rel(tiles), "producer": rel(prods)}


def summary(tl: dict) -> str:
    """Medians per k-tile (wait for the ring, split, issue + retire) and
    the tile steps, in clk."""
    def med(v):
        v = sorted(x for x in v if x is not None)
        return v[len(v) // 2] if v else None

    k = tl["k_tiles"]
    wait = med([r[1] - r[0] for r in k if None not in r])
    split = med([r[2] - r[1] for r in k if None not in r])
    issue = med([r[3] - r[2] for r in k if None not in r])
    step = med([k[i + 1][0] - k[i][0] for i in range(len(k) - 1)
                if k[i][0] is not None and k[i + 1][0] is not None])
    tiles = "; ".join(f"tile {i}: " + " ".join("-" if v is None else str(v) for v in r)
                      for i, r in enumerate(tl["tiles"][:6]))
    prod = "; ".join(" ".join("-" if v is None else str(v) for v in r)
                     for r in tl["producer"][:6])
    return (f"per k-tile median clk: start to start {step}, ring wait {wait}, split {split}, "
            f"issue + retire {issue} ({len(k)} k-tiles) | tile steps (start, windows 1-3, x, "
            f"sums, squares, y; clk from the first stamp): {tiles} | producer (first load, "
            f"x): {prod}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-dir", type=Path, default=ROOT / "build" / f"old_{OLD_COMMIT}")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "attn_out_f32_probe")
    ap.add_argument("--widths", type=int, nargs="*", default=WIDTHS)
    ap.add_argument("--rows", type=int, nargs="*", default=[16384, 64])
    ap.add_argument("--trap", action="store_true", help="check only, trapping waits")
    ap.add_argument("--build-only", action="store_true")
    args = ap.parse_args()
    if not (args.old_dir / CSRC / "attn_out_ln_f32.cu").is_file():
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
    lib = {v: bind(p) for v, p in libs.items()}
    cyc = sleep_cycles_per_ms()
    readings, bad = {}, []
    for h in args.widths:
        resident = lib["new"][f"mrd_attn_out_f32_clusters_h{h}"]()
        readings[f"H={h} clusters"] = resident
        print(f"H={h}: clusters of {h // 128} resident at once {resident}", flush=True)
        for m in args.rows:
            t = tensors(h, m, dev)
            new = caller(lib["new"], h, t, 0)
            got = new().clone()
            again = new().clone()
            want = plain(t)
            d = (got - want).abs()
            err = (d.max().item(), d.mean().item())
            ok = torch.equal(got, again) and err[0] <= F32_ATOL and err[1] <= F32_MEAN_ATOL
            key = f"H={h} M={m}"
            readings[f"{key} check"] = dict(err=err, same_bits_twice=torch.equal(got, again))
            print(f"{key}: new vs plain {err[0]:.3e} / {err[1]:.3e}, same bits twice "
                  f"{torch.equal(got, again)} {'ok' if ok else 'OFF'}", flush=True)
            if not ok:
                bad.append(f"{key} check")
            if args.trap:
                continue
            old = caller(lib["old"], h, t, 1)
            y_old = old().clone()
            d = (got - y_old).abs().max().item()
            pre = (t["scratch"][2 * h * h:].view(m, h) + t["bo"]) + t["x"]
            pre_new = caller(lib["new_preln"], h, t, 0)().clone()
            same_pre = torch.equal(pre, pre_new)
            readings[f"{key} bits"] = dict(max_new_old=d, pre_ln_equal=same_pre)
            print(f"{key}: max |new - old| {d:.3e}; pre-LN sums equal to the old partials + bo "
                  f"+ x {same_pre}", flush=True)
            if not same_pre:
                bad.append(f"{key} pre-LN")
            fns = {"old": old, "old_nostore": caller(lib["old_nostore"], h, t, 1), "new": new,
                   "new_nowo": caller(lib["new_nowo"], h, t, 0),
                   "new_noctx": caller(lib["new_noctx"], h, t, 0)}
            runs = {n: [] for n in fns}
            for n in list(fns) + list(fns)[::-1]:
                runs[n].append(per_call_ms(fns[n], cyc))
            ms = {n: sum(v) / len(v) for n, v in runs.items()}
            split = {"old": launch_split(old), "new": launch_split(new)}
            readings[f"{key} ms"] = dict(ms=ms, runs=runs, launches=split)
            print(f"{key}: dev ms old {ms['old']:.4f}, old with no partial store "
                  f"{ms['old_nostore']:.4f}, new {ms['new']:.4f} (new/old "
                  f"{ms['new'] / ms['old']:.4f}), new with no Wo stream {ms['new_nowo']:.4f}, "
                  f"with no ctx stream {ms['new_noctx']:.4f}; "
                  f"per launch old "
                  + ", ".join(f"{k} {v:.4f}" for k, v in split["old"].items()) + "; new "
                  + ", ".join(f"{k} {v:.4f}" for k, v in split["new"].items()), flush=True)
            if m >= 4096:
                for v in ("old_trace", "new_trace"):
                    slices = 1 if v.startswith("old") else 0
                    tl = timeline(lib[v], caller(lib[v], h, t, slices), cyc)
                    readings[f"{key} {v}"] = tl
                    print(f"{key} {v}: {summary(tl)}", flush=True)
    print(json.dumps({"card": card, "readings": readings, "off": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
