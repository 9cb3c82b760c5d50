"""Build and load the CUDA kernels at first use.

The sources under ``csrc/`` are compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, placed in ``build/kernels/`` at the
root of the checkout, and loaded with ``ctypes``: pointers and the stream go
in as ``c_void_p``, sizes as ``c_int``.  The library's name carries a hash
of its source and flags, so an edited source is rebuilt and a stale build is
never loaded.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "walk_kernels.cu",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_PI = ctypes.POINTER(ctypes.c_int)  # a host array: the step's ladder
_PU = ctypes.POINTER(ctypes.c_uint32)  # a host array: key words
_SIGNATURES = {
    # ..., key words by value (or null), a device key table (or null), its row width,
    # the entries' depths and instances (or null), stream
    "reject_step_launch": [_P, _P, _P, _P, _P, _P, _I, _PI, _PU, _P, _I, _P, _P, _P],
    "alias_step_launch": [_P, _P, _P, _P, _P, _P, _I, _PI, _PU, _P, _I, _P, _P, _P],
    "walk_step_launch": [_P, _P, _P, _P, _P, _I, _I, _PI, _PU, _P, _I, _P, _P, _P],
    "walk_step_window_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    "its_select_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "its_select_wide_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "hash_uniform_launch": [_P, _P, _P, _I, _I, _P],
    "derive_keys_launch": [_P, _P, _I, _I, _PI, _PU, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: compiler output of the last build (ptxas register and shared-memory use)
build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")
    return str(path)


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources into ``build/kernels/`` (once per source hash)."""
    global build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"walk_kernels_{_digest()}.so"
    if lib_path.exists():
        return lib_path
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, lib_path)
    return lib_path


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _I
            lib.its_select_wide_scratch_words.argtypes = [_I, _I, _I]
            lib.its_select_wide_scratch_words.restype = ctypes.c_longlong
            lib.walk_kernels_error_string.argtypes = [_I]
            lib.walk_kernels_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch entry point returned a CUDA error."""
    if code != 0:
        msg = lib.walk_kernels_error_string(code).decode()
        raise RuntimeError(f"{what} kernel failed to launch: CUDA error {code} ({msg})")


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, walkers: tuple, tables: tuple, others: tuple = ()) -> None:
    """Check the operands a kernel reads through raw pointers.

    ``walkers``, ``tables`` and ``others`` hold ``(tensor, dtype)`` pairs:
    per-walker arrays (leading dimension W), CSR-aligned arrays (one length
    E) and arrays of other lengths.  All must lie on one CUDA device, have
    the named dtype and be contiguous.
    """
    dev = walkers[0][0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: operands on {dev}, expected a CUDA device")
    for t, dt in (*walkers, *tables, *others):
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if len({t.shape[0] for t, _ in walkers}) != 1:
        raise ValueError(f"{name}: per-walker operands of different lengths")
    if tables and (len({t.dim() for t, _ in tables} | {1}) != 1
                   or len({t.shape[0] for t, _ in tables}) != 1):
        raise ValueError(f"{name}: CSR-aligned operands must be 1-D of one length")
