"""ctypes binding of the native host runtime ``native/voxelhash.cpp`` (the
port's own binding; the JAX package has its own in
``situation3d_tpu/ops/native.py``).

The C++ library carries the host side of the data pipeline: voxel dedup,
kernel-map construction (MinkowskiEngine's CoordinateManager role) and the
FPS / ball-query oracles. ``ensure_built`` compiles it at first use with

    g++ -O3 -march=native -fPIC -std=c++17 -fopenmp -shared

into ``situation3d_tpu_torch/_build/native-<hash of source and flags>/``
(nothing is written under ``native/``, and importing this module builds
nothing). Every entry point falls back to numpy when the library is not
available; the fallback ``kernel_map`` is a Python loop, so a full-size plan
without the library takes minutes: callers that need the speed check
``ensure_built()``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from situation3d_tpu_torch.ops.voxelize import sparse_quantize_np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG.parent / "native" / "voxelhash.cpp"
BUILD_ROOT = _PKG / "_build"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-fopenmp", "-shared"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()           # one build even when sample threads ask at once
_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)


def _lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / "libs3dnative.so"


def ensure_built() -> bool:
    """Build (once) and load the library. Returns whether it is available."""
    with _lock:
        if _lib is not None:
            return True
        if not SOURCE.exists():
            return False
        path = _lib_path()
        if not path.exists():
            path.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
            os.close(fd)
            try:
                subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                               check=True, capture_output=True)
                os.replace(tmp, path)      # atomic: concurrent processes agree
            except (subprocess.CalledProcessError, FileNotFoundError):
                return False
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        return _load(path)


def _load(path: Path) -> bool:
    global _lib
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return False
    i32p, f32p = _I32P, _F32P
    lib.s3d_sparse_quantize.restype = ctypes.c_int64
    lib.s3d_sparse_quantize.argtypes = [i32p, ctypes.c_int64, i32p, i32p]
    lib.s3d_kernel_map.restype = None
    lib.s3d_kernel_map.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32,
                                   i32p, ctypes.c_int64, i32p, ctypes.c_int32,
                                   ctypes.c_int32, i32p]
    lib.s3d_downsample.restype = ctypes.c_int64
    lib.s3d_downsample.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32, i32p]
    lib.s3d_fps.restype = None
    lib.s3d_fps.argtypes = [f32p, ctypes.c_int64, ctypes.c_int32, i32p]
    lib.s3d_ball_query.restype = None
    lib.s3d_ball_query.argtypes = [f32p, ctypes.c_int64, f32p, ctypes.c_int64,
                                   ctypes.c_float, ctypes.c_int32, i32p]
    _lib = lib
    return True


def available() -> bool:
    """Whether the library is loaded (``ensure_built`` loads it)."""
    return _lib is not None


def _i32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.int32)


def sparse_quantize(coords: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """First-occurrence dedup; returns (first_index, inverse)."""
    n = len(coords)
    if available():
        c = _i32(coords)
        first = np.empty(n, np.int32)
        inv = np.empty(n, np.int32)
        nu = _lib.s3d_sparse_quantize(c.ctypes.data_as(_I32P), n,
                                      first.ctypes.data_as(_I32P),
                                      inv.ctypes.data_as(_I32P))
        return first[:nu].astype(np.int64), inv.astype(np.int64)
    return sparse_quantize_np(coords)


def kernel_map(in_coords: np.ndarray, in_stride: int, out_coords: np.ndarray,
               offsets: np.ndarray, offset_stride: int) -> np.ndarray:
    """Neighbour map [n_out, k]: row j, column o holds the input row at
    ``out_coords[j] + offsets[o] * offset_stride`` (a cell of ``in_stride``);
    a miss holds ``n_in``."""
    n_in, n_out, k = len(in_coords), len(out_coords), len(offsets)
    if available():
        ic, oc, of = _i32(in_coords), _i32(out_coords), _i32(offsets)
        out = np.empty((n_out, k), np.int32)
        _lib.s3d_kernel_map(ic.ctypes.data_as(_I32P), n_in, in_stride,
                            oc.ctypes.data_as(_I32P), n_out,
                            of.ctypes.data_as(_I32P), k, offset_stride,
                            out.ctypes.data_as(_I32P))
        return out
    table = {tuple(c // in_stride): i for i, c in enumerate(np.asarray(in_coords))}
    out = np.full((n_out, k), n_in, np.int32)
    for j, c in enumerate(np.asarray(out_coords)):
        for o in range(k):
            q = c + offsets[o] * offset_stride
            if (q % in_stride == 0).all() and (q >= 0).all():
                out[j, o] = table.get(tuple(q // in_stride), n_in)
    return out


def downsample(coords: np.ndarray, new_stride: int) -> np.ndarray:
    """Unique stride-reduced coords, first-occurrence order."""
    n = len(coords)
    if available():
        c = _i32(coords)
        out = np.empty((n, 3), np.int32)
        nu = _lib.s3d_downsample(c.ctypes.data_as(_I32P), n, new_stride,
                                 out.ctypes.data_as(_I32P))
        return out[:nu].copy()
    down = (np.asarray(coords) // new_stride) * new_stride
    first, _ = sparse_quantize_np(down)
    return down[first]


def fps(xyz: np.ndarray, m: int) -> np.ndarray:
    """Farthest point sampling of one cloud [n, 3] -> [m] indices."""
    n = len(xyz)
    if available():
        x = np.ascontiguousarray(xyz, np.float32)
        out = np.empty(m, np.int32)
        _lib.s3d_fps(x.ctypes.data_as(_F32P), n, m, out.ctypes.data_as(_I32P))
        return out
    temp = np.full(n, 1e10)
    mag = (xyz ** 2).sum(-1)
    out = np.zeros(m, np.int32)
    old = 0
    for j in range(1, m):
        d = ((xyz - xyz[old]) ** 2).sum(-1)
        temp = np.minimum(temp, d)
        old = int(np.argmax(np.where(mag > 1e-3, temp, -1.0)))
        out[j] = old
    return out


def ball_query(xyz: np.ndarray, centers: np.ndarray, radius: float,
               nsample: int) -> np.ndarray:
    """Radius query of one cloud: [len(centers), nsample] indices. Library
    only (the port's ``ops/pointnet2.py:ball_query`` is the tensor version)."""
    if not available():
        raise NotImplementedError("numpy fallback: use ops.pointnet2.ball_query")
    x = np.ascontiguousarray(xyz, np.float32)
    c = np.ascontiguousarray(centers, np.float32)
    out = np.empty((len(centers), nsample), np.int32)
    _lib.s3d_ball_query(x.ctypes.data_as(_F32P), len(x), c.ctypes.data_as(_F32P),
                        len(c), radius, nsample, out.ctypes.data_as(_I32P))
    return out
