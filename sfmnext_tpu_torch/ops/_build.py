"""Build the port's CUDA kernels at first use and load them with ctypes,
and the checks every kernel wrapper shares.

``nvcc`` compiles each ``csrc/*.cu`` of this package into an object, all
sources at once in parallel, and links them into one shared library with
a plain C interface (no PyTorch headers, so a build takes seconds),
``_build/libsql_kernels.so`` beside the sources. The library is rebuilt
when the hash of the sources and flags changes. Only the sources in the
package are used.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "libsql_kernels.so"
LOG_PATH = BUILD_DIR / "build.log"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    nvcc, pid = _nvcc(), os.getpid()
    objs, procs, log = [], [], []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{pid}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)))
        objs.append(obj)
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{err}")
    tmp = BUILD_DIR / f"libsql_kernels.{pid}.so"
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{proc.stderr}")
    LOG_PATH.write_text("\n".join(log))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, LIB_PATH)
    stamp.write_text(digest)
    return LIB_PATH


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernels, with every C signature declared."""
    lib = ctypes.CDLL(str(build()))
    i32 = ctypes.c_int
    codes = {
        "a": ctypes.POINTER(ctypes.c_void_p),  # an array of device pointers
        "p": ctypes.c_void_p,
        "i": i32,
        "f": ctypes.c_float,  # passed as an int, a float arrives as garbage
    }
    signatures = {
        # arrays and pointers, then ints, then floats; the stream follows
        "sql_summary_fwd": "p" * 8 + "i" * 5,
        "sql_depth_fwd": "p" * 6 + "i" * 5,
        "sql_summary_bwd": "p" * 9 + "i" * 5,
        "sql_depth_bwd": "p" * 15 + "i" * 6,
        "warp_fwd": "p" * 4 + "i" * 7,
        "warp_bwd": "p" * 6 + "i" * 7,
        "warp_bwd_img": "p" * 4 + "i" * 7,
        "ssim_fwd": "app" + "i" * 5 + "f",
        "ssim_ident_min": "appppp" + "i" * 6 + "f",
        "ssim_bwd": "aappp" + "i" * 5 + "f",
        "color_jitter": "p" * 5 + "i" * 5,
    }
    for name, sig in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = [codes[k] for k in sig] + [ctypes.c_void_p]
        fn.restype = i32
    lib.sql_bwd_blocks_per_sm.argtypes = [i32, i32, i32]
    lib.sql_bwd_blocks_per_sm.restype = i32
    lib.sql_kernel_error_string.argtypes = [i32]
    lib.sql_kernel_error_string.restype = ctypes.c_char_p
    return lib


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_tensor(name: str, t: torch.Tensor, dtype, shape) -> None:
    """dtype, shape, contiguity and 16-byte alignment, as the kernels take them."""
    require(t.dtype == dtype, f"{name}: dtype {t.dtype}, expected {dtype}")
    require(tuple(t.shape) == tuple(shape),
            f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    require(t.is_contiguous(), f"{name} must be contiguous")
    require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")


def kernel_device(*tensors) -> torch.device:
    """The tensors' common device; the CPU or a CUDA card, nothing else."""
    dev = tensors[0].device
    require(all(t.device == dev for t in tensors), "inputs lie on different devices")
    require(dev.type in ("cpu", "cuda"), f"no kernel for device {dev}")
    return dev


def stream(dev: torch.device) -> int:
    """The current CUDA stream of ``dev``, as the kernels take it."""
    return torch.cuda.current_stream(dev).cuda_stream


def pointer_array(tensors) -> ctypes.Array:
    """The tensors' device addresses as a C array (an ``"a"`` argument)."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def check_error(lib, err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.sql_kernel_error_string(err).decode()
        raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")
