"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library under
:data:`BUILD_DIR` (see :func:`default_build_dir`), then loaded with
``ctypes``. A library's file name carries a hash of its source, of
every ``csrc/*.cuh`` header and of the flags, so an edited source or header
is rebuilt at its next use and an unchanged one is loaded as built. Nothing
here runs at import time.

The C functions take device pointers and PyTorch's current stream, launch,
and return ``cudaGetLastError()``; they never synchronize or allocate.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

SOURCES = {
    "accumulate_tta_tile": "accumulate_tta_tile.cu",
    "pconv3_valid_sm90": "pconv3_valid_sm90.cu",
    "pconv_pad11_cat_sm90": "pconv_pad11_cat_sm90.cu",
    "pconv2d_sm90": "pconv2d_sm90.cu",
    "norm_act": "norm_act.cu",
}
# measuring probes: built on request (``build(["l2_feed_probe"])``), on no
# path of the port
PROBES = {
    "l2_feed_probe": "l2_feed_probe.cu",
}
PACKAGE_DIR = Path(__file__).resolve().parent
CSRC = PACKAGE_DIR / "csrc"


def default_build_dir(package_dir: Path = PACKAGE_DIR) -> Path:
    """Where the kernel libraries go: ``$REHRSEG_TORCH_BUILD_DIR`` when it
    is set; ``build/rehrseg_tpu_torch/`` at the root of a checkout (the
    package's parent holds ``pyproject.toml``; git-ignored); else, for an
    installed package, the user's cache directory
    (``$XDG_CACHE_HOME/rehrseg_tpu_torch``, default ``~/.cache``), never
    site-packages."""
    override = os.environ.get("REHRSEG_TORCH_BUILD_DIR")
    if override:
        return Path(override)
    root = Path(package_dir).parent
    if (root / "pyproject.toml").is_file():
        return root / "build" / "rehrseg_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return Path(cache) / "rehrseg_tpu_torch"


BUILD_DIR = default_build_dir()
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-ldl"]

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "source on a machine with the CUDA toolkit")


def _source(name: str) -> Path:
    return CSRC / (SOURCES.get(name) or PROBES[name])


def library_path(name: str) -> Path:
    h = hashlib.sha256(_source(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _nvcc_cmd(name: str, out: str) -> list:
    return [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", out,
            str(_source(name))]


def build(names=None) -> dict:
    """Compile every named kernel whose library is missing, one ``nvcc``
    process per source, all started together. Returns {name: compiler
    output} for the sources it compiled; raises if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        procs[name] = (subprocess.Popen(
            _nvcc_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, lib)
    logs, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode == 0:
            os.replace(tmp, lib)
        else:
            os.unlink(tmp)
            failed.append(f"{name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C launcher reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
