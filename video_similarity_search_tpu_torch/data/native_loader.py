"""ctypes binding for the native C++ batched JPEG clip decoder (port of the
JAX package's ``data/native_loader.py``).

The port keeps its own copy of the decoder source, ``native/vss_loader.cpp``
(identical to the JAX package's). It is compiled with ``g++`` at first use
into the git-ignored ``native/build/libvss_loader-<hash>.so`` (the hash is
of the source and the flags, so an edited source is rebuilt) and needs
libjpeg's header and library. The build is portable (no ``-march``), so a
library carried to another host with a copy of the checkout still runs
there. Nothing else is ever loaded: not the JAX package's library, not a
prebuilt one. :func:`available` says whether the build succeeded;
``ClipReader`` asks it once, when the reader is built, to choose its decode
backend.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import List, Optional

import numpy as np

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
SRC = os.path.join(NATIVE_DIR, "vss_loader.cpp")
BUILD_DIR = os.path.join(NATIVE_DIR, "build")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_LIBS = ("-ljpeg", "-lpthread")

_ABI_VERSION = 4  # must match vss_loader_version() in vss_loader.cpp

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
BUILD_LOG = ""  # compiler output of the last failed attempt
LIB_PATH: Optional[str] = None  # the .so that was loaded


def library_path() -> str:
    digest = hashlib.sha1(" ".join(_FLAGS + _LIBS).encode())
    with open(SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libvss_loader-{digest.hexdigest()[:12]}.so")


def _build() -> Optional[str]:
    """Compile ``SRC`` unless a current build exists; -> .so path, or None
    when the toolchain or libjpeg is missing. The compile writes a
    temporary file and renames it into place, so concurrent builds never
    leave a half-written library."""
    global BUILD_LOG
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *_FLAGS, "-o", tmp, SRC, *_LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=180)
        BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode == 0:
            os.replace(tmp, out)
            return out
    except (OSError, subprocess.TimeoutExpired) as e:
        BUILD_LOG = repr(e)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return None


def _bind(lib: ctypes.CDLL) -> Optional[ctypes.CDLL]:
    """Resolve and type the C entry points; None on an ABI mismatch."""
    try:
        if lib.vss_loader_version() != _ABI_VERSION:
            return None
        lib.vss_decode_frames.restype = ctypes.c_int
        lib.vss_decode_frames.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
        ]
        lib.vss_decode_frames_rrc.restype = ctypes.c_int
        lib.vss_decode_frames_rrc.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
        ]
    except AttributeError:
        return None
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, LIB_PATH, BUILD_LOG
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is not None:
            try:
                _lib = _bind(ctypes.CDLL(path))
            except OSError as e:
                BUILD_LOG = repr(e)
                _lib = None
            LIB_PATH = path if _lib is not None else None
        return _lib


def available() -> bool:
    return _load() is not None


def _decoder() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native loader unavailable: " + BUILD_LOG[-500:])
    return lib


def decode_frames(paths: List[str], out_size: int, eval_mode: bool,
                  n_threads: int = 4) -> np.ndarray:
    """Decode JPEG ``paths`` -> (T, out_size, out_size, 3) uint8.

    Raises ``RuntimeError`` on any decode failure."""
    lib = _decoder()
    n = len(paths)
    out = np.empty((n, out_size, out_size, 3), np.uint8)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.vss_decode_frames(
        c_paths, n, out_size, int(eval_mode),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), n_threads)
    if rc != 0:
        raise RuntimeError(f"native decode failed for {paths[-rc - 1]!r}")
    return out


def decode_frames_rrc(paths: List[str], top: float, left: float,
                      crop_h: float, crop_w: float, out_size: int,
                      box_h: float = -1.0, box_w: float = -1.0,
                      n_threads: int = 4) -> np.ndarray:
    """Decode JPEG ``paths`` with a clip-consistent RandomResizedCrop
    window -> (T, out_size, out_size, 3) uint8.

    The window coordinates live in the ``(box_h, box_w)`` frame the box
    was sampled from (pass -1 when they are already in each frame's own
    pixel coordinates); the decoder rescales the box per frame. One
    GIL-free C call per clip, with the crop and resize inside the decode."""
    lib = _decoder()
    n = len(paths)
    out = np.empty((n, out_size, out_size, 3), np.uint8)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.vss_decode_frames_rrc(
        c_paths, n, float(top), float(left), float(crop_h), float(crop_w),
        float(box_h), float(box_w), out_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), n_threads)
    if rc != 0:
        raise RuntimeError(f"native rrc decode failed for {paths[-rc - 1]!r}")
    return out
