"""Build and load the CUDA kernels of gaustudio_torch/csrc (counterpart of
gaustudio_tpu/utils/native.py).

The sources compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ``ctypes``: one ``nvcc`` per source,
all started together, then one link. The build runs at first use into
``gaustudio_torch/build/``; the library's file name carries a hash
of the sources and flags, so an edited source is rebuilt and a stale
library is never loaded. Every entry point returns ``cudaGetLastError()``;
:func:`check` raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "gs_count_entries": [_I, _P, _P, _P, _P, _P, _P, _I, _P, _P],
    "gs_write_entries": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P],
    "gs_identify_tile_ranges": [_I, _I, _P, _P, _P],
    "gs_render_tiles": [_I, _I, _I, _I] + [_P] * 15,
    "gs_render_tiles_backward": [_I, _I, _I, _I] + [_P] * 16,
    "gs_render_surfel_tiles": [_I, _I, _I, _I] + [_P] * 18,
    "gs_render_surfel_tiles_backward": [_I, _I, _I, _I] + [_P] * 18,
}

_lib = None
build_seconds = None  # wall time of the build this process ran (None: loaded)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libgaustudio_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless it exists; returns its path. Each source
    compiles in an nvcc of its own, all at once; ptxas's report of every
    kernel (registers, shared memory, spills) goes to build/nvcc.log."""
    global build_seconds
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    cu = [p for p in _sources() if p.endswith(".cu")]
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    t0 = time.perf_counter()
    jobs = []
    for src in cu:
        cmd = [nvcc] + NVCC_FLAGS + ["-c", src, "-o",
                                     os.path.join(work, os.path.basename(src) + ".o")]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, proc in jobs:
        text = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + text)
        if proc.returncode != 0:
            failed.append(f"{cmd[-3]} ({proc.returncode}):\n{text[-4000:]}")
    tmp = os.path.join(work, "lib.so")
    if not failed:
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", tmp] + [
            c[-1] for c, _ in jobs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{proc.stderr[-4000:]}")
    build_seconds = time.perf_counter() - t0
    with open(os.path.join(BUILD_DIR, "nvcc.log"), "w") as f:
        f.write("\n".join(log))
    if not failed:
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    shutil.rmtree(work, ignore_errors=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} ({torch.cuda.get_device_name()})")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on the current
    device, where the kernels launch."""
    dev = torch.device("cuda", torch.cuda.current_device())
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: inputs must be on the current device {dev}, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
