"""Build and load the port's hand-written CUDA kernels.

Counterpart of the JAX package's capability probe
(`multimodal_rare_disease_tpu/ops/pallas/capability.py`), with one
difference: there is no fallback. On first use the sources under
`csrc/` are compiled by `nvcc` for Hopper (`sm_90a`) into a shared
library with a plain C interface, keyed by a hash of the sources and
flags, under the repository's `build/kernels/` (ignored by git), and
loaded with `ctypes`. A failed build, a missing `nvcc` or a device that
is not compute capability 9.0 raises `KernelBuildError`.

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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
REQUIRED_CAPABILITY = (9, 0)

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
# seconds this process spent in nvcc (0.0 when it reused a built
# library); read by chip_smoke.py
last_build_seconds = 0.0


class KernelBuildError(RuntimeError):
    """The kernels cannot be built or cannot run on this device."""


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


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
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it already exists.
    The compiler's resource report (-Xptxas=-v) is kept beside it as
    ptxas.log."""
    global last_build_seconds
    out = library_path()
    if out.is_file():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{LIB_NAME}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    last_build_seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    (out.parent / "ptxas.log").write_text(proc.stdout + proc.stderr)
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
    lib.mrd_ffn_pre_ln_bf16.argtypes = [p] * 10 + [i, i, f, i, p]
    lib.mrd_ffn_pre_ln_bf16.restype = i
    lib.mrd_error_string.argtypes = [i]
    lib.mrd_error_string.restype = ctypes.c_char_p
    lib.mrd_ffn_smem_bytes.argtypes = []
    lib.mrd_ffn_smem_bytes.restype = i
    return lib


def load_library(device: torch.device) -> ctypes.CDLL:
    """Check the device, build on first use, load once per process."""
    global _LIB
    check_device(device)
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(str(build())))
        return _LIB


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.mrd_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
