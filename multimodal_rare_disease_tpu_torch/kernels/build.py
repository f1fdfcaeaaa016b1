"""Build and load the port's hand-written CUDA kernels.

Counterpart of the JAX package's capability probe
(`multimodal_rare_disease_tpu/ops/pallas/capability.py`), with one
difference: there is no fallback. On first use each source under
`csrc/` (`*.cu`) is compiled by its own `nvcc` for Hopper (`sm_90a`),
all of them at once, and the objects are linked into one shared library
with a plain C interface. The library is keyed by a hash of the sources,
the headers they include (`csrc/*.cuh`) and the flags, lives under the
repository's `build/kernels/` (ignored by git), and is loaded with
`ctypes`. A failed build, a missing `nvcc` or a device that is not
compute capability 9.0 raises `KernelBuildError`.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine with no `nvcc` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
LIB_NAME = "libmrd_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas=-v")
REQUIRED_CAPABILITY = (9, 0)
# the hidden widths the row kernels (K1-K3, bf16 and f32) are instantiated
# for: csrc's MRD_*_WIDTH entries and 768; kernels/ffn.py::KERNEL_WIDTHS
ROW_WIDTHS = (128, 256, 384, 512, 640, 768, 896, 1024, 1152, 1280, 1408,
              1536)

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
# devices check_device has passed: the check costs the host 5-17 us per
# call on the H100's host, about as much as the K3 wrapper's C entry
# (PERF.md)
_CHECKED: set = set()
# seconds this process spent in nvcc (0.0 when it reused a built
# library); read by chip_smoke.py
last_build_seconds = 0.0


class KernelBuildError(RuntimeError):
    """The kernels cannot be built or cannot run on this device."""


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cuh"))


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        return "/usr/local/cuda/bin/nvcc"
    raise KernelBuildError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels are built from csrc/ on first use")


def library_path() -> Path:
    """Where the library for the current sources, headers and flags
    lives."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in (*sources(), *headers()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / LIB_NAME


def _run(cmds: list[list[str]]) -> list[str]:
    """Run the commands at once, wait for all of them, and return their
    output; raise KernelBuildError if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")
    return outs


def build() -> Path:
    """Compile csrc/*.cu (one nvcc per source, in parallel) and link the
    shared library, unless it already exists. The compilers' resource
    report (-Xptxas=-v) is kept beside it as ptxas.log."""
    global last_build_seconds
    out = library_path()
    if out.is_file():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [out.parent / f".{src.stem}.{tag}.o" for src in sources()]
    tmp = out.with_name(f".{LIB_NAME}.{tag}")
    t0 = time.perf_counter()
    logs = _run([[nvcc, *COMPILE_FLAGS, "-c", "-o", str(o), str(src)]
                 for src, o in zip(sources(), objs)])
    _run([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
           *map(str, objs)]])
    last_build_seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink()
    (out.parent / "ptxas.log").write_text("".join(logs))
    os.replace(tmp, out)  # atomic: concurrent builds race harmlessly
    return out


def check_device(device: torch.device) -> None:
    if device.type != "cuda":
        raise KernelBuildError(
            f"the kernels run on CUDA devices, not {device}")
    if not torch.cuda.is_available():
        raise KernelBuildError("no CUDA device is available")
    cap = torch.cuda.get_device_capability(device)
    if tuple(cap) != REQUIRED_CAPABILITY:
        raise KernelBuildError(
            f"{torch.cuda.get_device_name(device)} has compute capability "
            f"{cap}; the kernels are built for sm_90a (Hopper, capability "
            f"{REQUIRED_CAPABILITY})")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    f3 = ctypes.POINTER(ctypes.c_float)
    # the row kernels' entries at H = 768, each with a twin at every other
    # built width (name + "_h<width>", the same arguments)
    rows = {
        "mrd_ffn_pre_ln_bf16": [p] * 11 + [i, i, i, f, i, p],
        "mrd_ffn_ln_bf16": [p] * 9 + [i, i, i, f, p],
        "mrd_attn_out_ln_bf16": [p] * 8 + [i, i, f, p],
        "mrd_ffn_pre_ln_f32": [p] * 11 + [i, i, i, f, p],
        "mrd_ffn_ln_f32": [p] * 9 + [i, i, i, f, p],
        "mrd_attn_out_ln_f32": [p] * 8 + [i, i, f, p],
        "mrd_ffn_smem_bytes": [],
        "mrd_ffn_max_clusters": [],
        "mrd_attn_out_smem_bytes": [],
    }
    sigs = {
        **rows,
        **{f"{name}_h{width}": argtypes for name, argtypes in rows.items()
           for width in ROW_WIDTHS if width != 768},
        "mrd_normalize_u8": [p, p, ctypes.c_longlong, f3, f3, i, i, p],
        "mrd_error_string": [i],
        "mrd_ffn_f32_smem_bytes": [],
        "mrd_attn_out_f32_smem_bytes": [],
        # K3-f32's pass over whole rows (attn_out.ROWS_F32_WIDTHS)
        **{f"mrd_attn_out_f32_clusters_h{width}": []
           for width in ROW_WIDTHS if width <= 640},
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i
    lib.mrd_error_string.restype = ctypes.c_char_p
    return lib


def load_library(device: torch.device) -> ctypes.CDLL:
    """Check the device (once per device), build on first use, load once
    per process."""
    global _LIB
    if device not in _CHECKED:
        check_device(device)
        _CHECKED.add(device)
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(str(build())))
        return _LIB


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.mrd_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
