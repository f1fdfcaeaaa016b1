"""Native (C++) host-side code of the torch package, loaded with ctypes.

`wordpiece.cpp` is the tokenizer's fast path (a copy of the JAX
package's). On first use it is compiled with g++ into the repository's
git-ignored `build/native/<hash>/`, keyed by a hash of the source and
flags, never into the package directory. Without a compiler
`wordpiece_lib()` returns None and the tokenizer takes its pure-Python
path, which is the reference semantics.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

log = logging.getLogger(__name__)

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent.parent / "build" / "native"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_LOCK = threading.Lock()
_LIBS = {}


def library_path(name: str) -> Path:
    src = _DIR / f"{name}.cpp"
    h = hashlib.sha256(" ".join(_FLAGS).encode() + src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / f"lib{name}.so"


def build_and_load(name: str) -> Optional[ctypes.CDLL]:
    """Compile native/<name>.cpp (once per source) and dlopen it; None
    when no compiler is available (callers take the Python path)."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        so = library_path(name)
        try:
            if not so.is_file():
                so.parent.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
                subprocess.run(["g++", *_FLAGS, "-o", str(tmp),
                                str(_DIR / f"{name}.cpp")],
                               check=True, capture_output=True)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
        except (OSError, subprocess.CalledProcessError) as e:
            log.warning("native %s unavailable (%s); using the Python path",
                        name, e)
            lib = None
        _LIBS[name] = lib
        return lib


def wordpiece_lib() -> Optional[ctypes.CDLL]:
    lib = build_and_load("wordpiece")
    if lib is not None and lib.wp_create.restype is not ctypes.c_void_p:
        lib.wp_create.restype = ctypes.c_void_p
        lib.wp_create.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.wp_destroy.argtypes = [ctypes.c_void_p]
        lib.wp_encode_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32)]
    return lib
