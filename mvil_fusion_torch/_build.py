"""Build and load the port's hand-written CUDA kernels at first use.

Each kernel is one ``csrc/<name>.cu`` with a plain C entry point.  It is
compiled with nvcc for Hopper (``sm_90a``) into a shared library under
``build/kernels/`` at the repository root, named by the hash of its source
and flags (an edited source builds anew), and loaded with ctypes.  Nothing
is built when a module is imported; a machine without nvcc fails here,
at the first launch on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lives for its current source."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its hash has no library yet, then load
    it (once per process).  Raises RuntimeError with nvcc's output if the
    build fails."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = library_path(name)
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    _loaded[name] = lib
    return lib


def resource_usage(name: str) -> str:
    """What ``nvcc -Xptxas -v`` says of ``csrc/<name>.cu``: registers,
    shared memory and spills of every kernel in it.  Compiles to nowhere;
    the library that ``load_library`` builds is not touched."""
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    cmd = [_nvcc(), *flags, "-Xptxas", "-v", "-c", "-o", os.devnull,
           str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    return proc.stderr
