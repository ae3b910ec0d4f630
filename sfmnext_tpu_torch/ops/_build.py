"""Build the port's CUDA kernels at first use and load them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` of this package into one shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), ``_build/libsql_kernels.so`` beside the sources. The library is
rebuilt when the hash of the sources and flags changes. Only the sources
in the package are used.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "libsql_kernels.so"
LOG_PATH = BUILD_DIR / "build.log"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise FileNotFoundError("nvcc not found (set CUDA_HOME or put it on PATH)")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile the kernels unless an up-to-date library exists; its path."""
    digest = _digest()
    stamp = BUILD_DIR / "libsql_kernels.sha256"
    if LIB_PATH.exists() and stamp.exists() and stamp.read_text() == digest:
        return LIB_PATH
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = BUILD_DIR / f"libsql_kernels.{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    LOG_PATH.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    stamp.write_text(digest)
    return LIB_PATH


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernels, with every C signature declared."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sql_summary_fwd.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    lib.sql_summary_fwd.restype = i32
    lib.sql_depth_fwd.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    lib.sql_depth_fwd.restype = i32
    lib.sql_kernel_error_string.argtypes = [i32]
    lib.sql_kernel_error_string.restype = ctypes.c_char_p
    return lib
