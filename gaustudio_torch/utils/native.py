"""ctypes bindings of the native COLMAP readers in gaustudio_torch/native/gsio.cpp
(port of gaustudio_tpu/utils/native.py).

The library builds at first use with ``g++`` into ``gaustudio_torch/build/``,
under a file name that carries a hash of the source and the flags, so an
edited source is rebuilt and a stale library is never loaded. Where no
compiler or no build is possible, the readers return None, as the JAX
package's do, and the callers (datasets/utils.py) use their Python readers,
which give the same arrays; ``build_error`` then holds the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "gsio.cpp")
BUILD_DIR = os.path.join(_PKG, "build")
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lib = None
_tried = False
build_error: Optional[str] = None  # why the library is not available
build_seconds: Optional[float] = None  # wall time of the build this process ran (None: loaded)


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libgsio_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless it exists; returns its path and raises
    RuntimeError with the compiler's output when the build fails."""
    global build_seconds
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: set CXX or put g++ on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    t0 = time.perf_counter()
    try:
        tmp = os.path.join(work, "lib.so")
        proc = subprocess.run([cxx] + CXX_FLAGS + ["-o", tmp, SOURCE], capture_output=True,
                              text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        build_seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, build_error
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(build())
    except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
        build_error = str(e)
        return None

    lib.gsio_points3d_count.restype = ctypes.c_longlong
    lib.gsio_points3d_count.argtypes = [ctypes.c_char_p]
    lib.gsio_read_points3d.restype = ctypes.c_int
    lib.gsio_read_points3d.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.float64), np.ctypeslib.ndpointer(np.uint8),
        np.ctypeslib.ndpointer(np.float64), ctypes.c_longlong,
    ]
    lib.gsio_images_counts.restype = ctypes.c_int
    lib.gsio_images_counts.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.gsio_read_images.restype = ctypes.c_int
    lib.gsio_read_images.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.float64),
        np.ctypeslib.ndpointer(np.float64), np.ctypeslib.ndpointer(np.int32),
        ctypes.c_char_p, ctypes.c_longlong,
        np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.float64),
        np.ctypeslib.ndpointer(np.int64),
        ctypes.c_longlong, ctypes.c_longlong,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def read_points3d_binary(path: str) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """points3D.bin -> (xyz [N, 3] float64, rgb [N, 3] int64, error [N, 1]
    float64); None if the library is not available. The colours are int64,
    as the port's Python reader returns them (the JAX native reader returns
    float64 and its Python reader int64)."""
    lib = _load()
    if lib is None:
        return None
    n = lib.gsio_points3d_count(str(path).encode())
    if n < 0:
        raise IOError(f"failed to read {path}")
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty((n,), np.float64)
    rc = lib.gsio_read_points3d(str(path).encode(), xyz.reshape(-1), rgb.reshape(-1), err, n)
    if rc < 0:
        raise IOError(f"native points3D parse error {rc} for {path}")
    return xyz, rgb.astype(np.int64), err.reshape(-1, 1)


def read_images_binary(path: str):
    """images.bin -> {id: (qvec, tvec, camera_id, name, xys, point3D_ids)};
    None if the library is not available."""
    lib = _load()
    if lib is None:
        return None
    n_img = ctypes.c_longlong()
    t2d = ctypes.c_longlong()
    nb = ctypes.c_longlong()
    rc = lib.gsio_images_counts(str(path).encode(), ctypes.byref(n_img), ctypes.byref(t2d),
                                ctypes.byref(nb))
    if rc < 0:
        raise IOError(f"failed to read {path}")
    n, t, b = n_img.value, t2d.value, nb.value
    ids = np.empty(n, np.int32)
    qvec = np.empty((n, 4), np.float64)
    tvec = np.empty((n, 3), np.float64)
    cam_ids = np.empty(n, np.int32)
    names_buf = ctypes.create_string_buffer(b + 1)
    n2d = np.empty(n, np.int64)
    xys = np.empty((t, 2), np.float64)
    p3d = np.empty(t, np.int64)
    rc = lib.gsio_read_images(str(path).encode(), ids, qvec.reshape(-1), tvec.reshape(-1),
                              cam_ids, names_buf, b + 1, n2d, xys.reshape(-1), p3d, n, t)
    if rc < 0:
        raise IOError(f"native images parse error {rc} for {path}")
    names = names_buf.value.decode("utf-8").split("\n")[:n]
    out = {}
    off = 0
    for i in range(n):
        k = int(n2d[i])
        out[int(ids[i])] = (qvec[i], tvec[i], int(cam_ids[i]), names[i],
                            xys[off:off + k], p3d[off:off + k])
        off += k
    return out
