"""Build the port's CUDA kernels with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` has a plain C entry point and is compiled for
``sm_90a`` into ``csrc/build/lib<name>-<hash>.so`` (the hash is of the
source, every ``csrc/*.cuh`` header and the flags, so an edited source or
header is rebuilt), then loaded with ``ctypes``. Only sources in the
checkout are used; nothing is fetched. The libraries link no ``-lcuda``:
a driver call a kernel needs (``cuTensorMapEncodeTiled``) is fetched at
run time through ``cudaGetDriverEntryPoint``. A machine with CUDA but no
``nvcc`` raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Tuple

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}  # name -> nvcc output (ptxas register use)


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the port's CUDA kernels are "
                       "built from csrc/ at first use and need it")


def library_path(name: str) -> Tuple[str, str]:
    """-> (source path, versioned .so path) for ``csrc/<name>.cu``."""
    src = os.path.join(CSRC, f"{name}.cu")
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its current build exists; -> .so
    path. Safe to call from several threads or processes at once: each
    compiles into its own temporary file and renames it into place."""
    src, out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        BUILD_LOGS[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{BUILD_LOGS[name]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build if needed and load ``lib<name>``; cached per process."""
    with _LOCK:
        if name not in _LOADED:
            _LOADED[name] = ctypes.CDLL(build(name))
        return _LOADED[name]
