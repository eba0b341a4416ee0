"""ctypes bindings of the native host library ``csrc/rehrseg_host.cpp``
(``rehrseg_tpu.native`` in the port).

The library is host code (zlib inflate / deflate, B-spline prefilter,
blur, resize and z-score loops); it runs on no device. It is built at its
first use with ``g++ -O3 -march=native -shared -fPIC ... -lz`` from the
checkout's ``csrc/`` into the kernels' build directory
(:data:`rehrseg_tpu_torch.kernels.BUILD_DIR`, ``build/rehrseg_tpu_torch/``
in a checkout), under a name that hashes the source and the flags; the
compiler writes a temporary file that is renamed into place, so processes
that build it at once do not read a half-written library.

Every entry point keeps its numpy / zlib form, which runs when the library
is not there (no compiler, or an installed copy of the package without the
checkout's ``csrc/``). :func:`available` says which path is active and
:func:`build_error` why the library is missing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from . import kernels

SOURCE = kernels.PACKAGE_DIR.parent / "csrc" / "rehrseg_host.cpp"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_LIB = None
_TRIED = False
_ERROR: str | None = None
_LOCK = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return kernels.BUILD_DIR / f"librehrseg_host-{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE),
                               "-lz"], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(lib):
    i64, vp = ctypes.c_int64, ctypes.c_void_p
    lib.rh_gunzip.restype = i64
    lib.rh_gunzip.argtypes = [vp, i64, vp, i64]
    lib.rh_gzip.restype = i64
    lib.rh_gzip.argtypes = [vp, i64, vp, i64, ctypes.c_int]
    lib.rh_spline_filter_axis.restype = None
    lib.rh_spline_filter_axis.argtypes = [vp, i64, i64, i64]
    lib.rh_blur_axis.restype = None
    lib.rh_blur_axis.argtypes = [vp, vp, vp, i64, i64, i64, i64]
    lib.rh_resize_axis.restype = None
    lib.rh_resize_axis.argtypes = [vp, vp, vp, i64, i64, i64, i64]
    lib.rh_zscore.restype = None
    lib.rh_zscore.argtypes = [vp, i64]
    return lib


def _load():
    """The bound library, built first if needed; None when it cannot be
    built or loaded (the reason kept for :func:`build_error`)."""
    global _LIB, _TRIED, _ERROR
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        try:
            if not SOURCE.is_file():
                raise FileNotFoundError(
                    f"{SOURCE} not found (an installed copy of the package "
                    f"carries no csrc/)")
            path = library_path()
            if not path.exists():
                _compile(path)
            _LIB = _bind(ctypes.CDLL(str(path)))
        except Exception as e:       # noqa: BLE001 - kept for build_error()
            _ERROR = f"{type(e).__name__}: {e}"
            _LIB = None
        return _LIB


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    """Why the library is not available (the compiler's text), else None."""
    _load()
    return _ERROR


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def gunzip(data: bytes, hint_size: int | None = None) -> bytes:
    """Inflate a gzip stream natively; the gzip module without the library,
    beyond zlib's 32-bit single shot and on a truncated stream (where it
    raises)."""
    import gzip

    lib = _load()
    if lib is None:
        return gzip.decompress(data)
    inp = np.frombuffer(data, dtype=np.uint8)
    cap = max(hint_size or 0, len(data) * 4, 1 << 16)
    while cap <= (1 << 32) - 1:
        out = np.empty(cap, dtype=np.uint8)
        n = lib.rh_gunzip(_ptr(inp), len(inp), _ptr(out), cap)
        if n == -2:           # the buffer was too small
            cap = min(cap * 4, (1 << 32) - 1) if cap < (1 << 32) - 1 \
                else (1 << 32)
            continue
        if n < 0:             # a corrupt or truncated stream
            break
        return out[:n].tobytes()
    return gzip.decompress(data)


def gzip_compress(data: bytes, level: int = 6) -> bytes:
    import gzip

    lib = _load()
    if lib is None:
        return gzip.compress(data, compresslevel=level)
    inp = np.frombuffer(data, dtype=np.uint8)
    cap = len(data) + (len(data) >> 1) + 256
    out = np.empty(cap, dtype=np.uint8)
    n = lib.rh_gzip(_ptr(inp), len(inp), _ptr(out), cap, level)
    if n < 0:
        return gzip.compress(data, compresslevel=level)
    return out[:n].tobytes()


def _axis_view(x: np.ndarray, axis: int):
    """(outer, n, inner) factorization of a contiguous array around axis."""
    axis = axis % x.ndim
    outer = int(np.prod(x.shape[:axis], dtype=np.int64))
    inner = int(np.prod(x.shape[axis + 1:], dtype=np.int64))
    return outer, x.shape[axis], inner


def spline_filter_axis(x: np.ndarray, axis: int) -> np.ndarray:
    """Cubic B-spline prefilter along ``axis`` (scipy's spline_filter1d,
    order 3, mode 'mirror')."""
    lib = _load()
    if lib is None:
        from scipy.ndimage import spline_filter1d
        return spline_filter1d(x.astype(np.float32), order=3, axis=axis,
                               mode="mirror", output=np.float32)
    out = np.ascontiguousarray(x, dtype=np.float32).copy()
    outer, n, inner = _axis_view(out, axis)
    lib.rh_spline_filter_axis(_ptr(out), outer, n, inner)
    return out


def blur_axis(x: np.ndarray, kernel: np.ndarray, axis: int) -> np.ndarray:
    """'same' zero-padded cross-correlation along ``axis``."""
    lib = _load()
    if lib is None:
        from .ops.blur import blur_axis_np
        return blur_axis_np(x, kernel, axis)
    xin = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty_like(xin)
    k = np.ascontiguousarray(kernel, dtype=np.float32)
    outer, n, inner = _axis_view(xin, axis)
    lib.rh_blur_axis(_ptr(xin), _ptr(out), _ptr(k), len(k), outer, n, inner)
    return out


def resize_axis_matrix(x: np.ndarray, M: np.ndarray, axis: int) -> np.ndarray:
    """out = M @ x along ``axis`` (the rational B-spline resize's apply)."""
    lib = _load()
    if lib is None:
        return np.moveaxis(np.tensordot(M.astype(np.float64),
                                        np.moveaxis(x, axis, 0), axes=(1, 0)),
                           0, axis).astype(np.float32)
    xin = np.ascontiguousarray(x, dtype=np.float32)
    axis = axis % x.ndim
    m, n = M.shape
    if n != xin.shape[axis]:
        raise ValueError(f"resize matrix {M.shape} against axis {axis} of "
                         f"{xin.shape}")
    out_shape = list(xin.shape)
    out_shape[axis] = m
    out = np.empty(out_shape, dtype=np.float32)
    mc = np.ascontiguousarray(M, dtype=np.float32)
    outer, _, inner = _axis_view(xin, axis)
    lib.rh_resize_axis(_ptr(xin), _ptr(out), _ptr(mc), m, n, outer, inner)
    return out


def zscore_inplace(x: np.ndarray) -> np.ndarray:
    """Z-score a contiguous fp32 array in place (returns it); the numpy
    form returns a new array."""
    lib = _load()
    if lib is None:
        from .data.normalize import zscore_normalization
        return zscore_normalization(x)
    if x.dtype != np.float32 or not x.flags.c_contiguous:
        raise ValueError(f"zscore_inplace takes a C-contiguous float32 "
                         f"array, not {x.dtype} (contiguous: "
                         f"{x.flags.c_contiguous})")
    lib.rh_zscore(_ptr(x), x.size)
    return x
