"""Build-at-first-use loader for the port's CUDA kernels.

The sources under ``situation3d_tpu_torch/csrc/*.cu`` have a plain C
interface. On first use they are compiled with ``nvcc`` for ``sm_90a`` (one
``nvcc -c`` per source, all started together, then one link) into ONE shared
library under ``situation3d_tpu_torch/_build/<hash of sources and flags>/``
and loaded with ``ctypes``. Nothing but the sources in the package goes into
the build. A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libs3d_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None
build_seconds: float = 0.0   # wall time of the compile this process ran (0 = cached)
build_log: str = ""          # nvcc/ptxas output (registers, shared memory, spills)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # name: argtypes (every pointer and the stream is a c_void_p)
    "s3d_k3_map_lookup": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "s3d_k3_map_lookup_bits": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "s3d_fused_sparse_conv": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "s3d_gather_rows": [_P, _P, _P, _I, _I, _I, _I, _P],
    "s3d_scatter_add_rows": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "s3d_fps": [_P, _P, _P, _P, _I, _I, _I, _P],
}


def _find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built on this machine")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _source_hash(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _compile(srcs, out_dir: Path) -> None:
    global build_seconds, build_log
    nvcc = _find_nvcc()
    t0 = time.time()
    BUILD_ROOT.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    try:
        procs = []
        for s in srcs:
            obj = tmp / (s.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(obj)]
            procs.append((s, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for s, obj, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {s.name}\n{out}")
            if p.returncode != 0:
                failed.append(s.name)
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp / LIB_NAME),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
        (tmp / "build.log").write_text(build_log)
        try:
            os.replace(tmp, out_dir)         # atomic: a racing process loses
        except OSError:
            if not (out_dir / LIB_NAME).exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    build_seconds = time.time() - t0


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built from the package's sources on the
    first call in a fresh checkout."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    srcs = _sources()
    out_dir = BUILD_ROOT / _source_hash(srcs)
    if not (out_dir / LIB_NAME).exists():
        _compile(srcs, out_dir)
    elif not build_log and (out_dir / "build.log").exists():
        build_log = (out_dir / "build.log").read_text()
    lib = ctypes.CDLL(str(out_dir / LIB_NAME))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check_launch(code: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launcher."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {code}")
