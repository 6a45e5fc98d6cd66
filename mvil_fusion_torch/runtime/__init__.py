"""Native runtime: C++ bounded channels with ctypes bindings.

Counterpart of ``mvil_fusion_tpu/runtime/__init__.py``, with its own copy
of ``channel.cpp``.  The library is built with g++ at first use into
``build/runtime/`` at the repository root, named by the hash of its source
and flags (an edited source builds anew), never beside the source.
Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "channel.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "runtime"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
_LOCK = threading.Lock()
_LIB = None


def library_path() -> Path:
    """Where the build of ``channel.cpp`` lives for its current source."""
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libmvil_runtime-{digest[:16]}.so"


def _build(path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC),
                           "-lpthread"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on runtime/channel.cpp (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)


def load_library() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.ch_create.restype = ctypes.c_void_p
        lib.ch_create.argtypes = [ctypes.c_uint32, ctypes.c_uint32,
                                  ctypes.c_int]
        lib.ch_destroy.argtypes = [ctypes.c_void_p]
        lib.ch_close.argtypes = [ctypes.c_void_p]
        lib.ch_push.restype = ctypes.c_int
        lib.ch_push.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_uint8),
                                ctypes.c_uint32]
        lib.ch_pop.restype = ctypes.c_int
        lib.ch_pop.argtypes = [ctypes.c_void_p,
                               ctypes.POINTER(ctypes.c_uint8),
                               ctypes.c_uint32, ctypes.c_int64]
        lib.ch_size.restype = ctypes.c_uint32
        lib.ch_size.argtypes = [ctypes.c_void_p]
        lib.ch_dropped.restype = ctypes.c_uint64
        lib.ch_dropped.argtypes = [ctypes.c_void_p]
        lib.ch_pushed.restype = ctypes.c_uint64
        lib.ch_pushed.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib
