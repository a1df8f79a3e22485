"""Loader for the port's host library, marching and rasterizer
(counterpart of ``nphm_tpu/ops/native.py``).

``csrc/host/marching.cpp`` and ``csrc/host/rasterizer.cpp`` are compiled
together at first use with the system C++ compiler, with the flags of the
JAX package's ``csrc/Makefile``, into ``nphm_tpu_torch/_build/libnphm_host.so``
(git-ignored), and again whenever either source is newer than the library.
Entry points are plain C, loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_SRCS = [os.path.join(_PKG, "csrc", "host", name)
             for name in ("marching.cpp", "rasterizer.cpp")]
LIB_PATH = os.path.join(_PKG, "_build", "libnphm_host.so")
# -ffp-contract=off: float expressions round like numpy's float32 ops (the
# face-normal cross products of degenerate faces cancel to exactly 0)
CXX_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-fPIC", "-std=c++17",
             "-pthread", "-shared"]

_LOCK = threading.Lock()
_LIB = None


def build():
    """Compile the host library; raises with the compiler's output on failure."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler found: the host library cannot be built")
    os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, *HOST_SRCS],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"host library build failed:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, LIB_PATH)


def get_lib() -> ctypes.CDLL:
    """The loaded host library, built first if missing or stale."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if not os.path.exists(LIB_PATH) or (
            max(map(os.path.getmtime, HOST_SRCS)) > os.path.getmtime(LIB_PATH)
        ):
            build()
        lib = ctypes.CDLL(LIB_PATH)
        lib.nphm_marching_tets.restype = ctypes.c_int
        lib.nphm_marching_tets.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_float,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.nphm_marching_tets_window.restype = ctypes.c_int
        lib.nphm_marching_tets_window.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_float,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.nphm_marching_tets_blocks.restype = ctypes.c_int
        lib.nphm_marching_tets_blocks.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_float,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.nphm_free.restype = None
        lib.nphm_free.argtypes = [ctypes.c_void_p]

        f32p = ctypes.POINTER(ctypes.c_float)
        lib.nphm_rasterize.restype = ctypes.c_int
        lib.nphm_rasterize.argtypes = [
            f32p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            f32p,  # face normals (or None: computed natively)
            f32p, f32p,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float,
            f32p, f32p, f32p,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.nphm_face_normals.restype = ctypes.c_int
        lib.nphm_face_normals.argtypes = [
            f32p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            f32p,
        ]
        lib.nphm_render_visible.restype = ctypes.c_int
        lib.nphm_render_visible.argtypes = [
            f32p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            f32p,  # face normals (or None: computed natively)
            f32p, f32p,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float,
            ctypes.c_float,  # backface cos threshold
            f32p, f32p,
            ctypes.POINTER(ctypes.c_int64),
        ]
        _LIB = lib
        return _LIB
