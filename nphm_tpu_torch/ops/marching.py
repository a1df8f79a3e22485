"""Marching-tetrahedra surface extraction on the host (counterpart of
``nphm_tpu/ops/marching.py``): ``mesh_from_logits`` negates the SDF logits,
extracts the 0-level set with ``csrc/host/marching.cpp`` and rescales the
vertices from grid-index to world coordinates.
"""

from __future__ import annotations

import ctypes

import numpy as np

from nphm_tpu_torch.ops.native import get_lib
from nphm_tpu_torch.utils.mesh_io import Mesh


def marching_tets(grid: np.ndarray, iso: float = 0.0):
    """Boundary of {grid > iso}.

    grid: [rx, ry, rz] float32.  Returns (vertices [V, 3] float32 in
    grid-index coordinates, faces [F, 3] int32).
    """
    grid = np.ascontiguousarray(grid, np.float32)
    if grid.ndim != 3:
        raise ValueError(f"grid must be 3-D, got {grid.shape}")
    lib = get_lib()
    vp = ctypes.POINTER(ctypes.c_float)()
    fp = ctypes.POINTER(ctypes.c_int32)()
    nv = ctypes.c_int64()
    nf = ctypes.c_int64()
    rc = lib.nphm_marching_tets(
        grid.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        grid.shape[0], grid.shape[1], grid.shape[2], ctypes.c_float(iso),
        ctypes.byref(vp), ctypes.byref(nv), ctypes.byref(fp), ctypes.byref(nf),
    )
    if rc != 0:
        raise RuntimeError(f"marching_tets failed with code {rc}")
    try:
        verts = (np.ctypeslib.as_array(vp, shape=(nv.value, 3)).copy() if nv.value
                 else np.zeros((0, 3), np.float32))
        faces = (np.ctypeslib.as_array(fp, shape=(nf.value, 3)).copy() if nf.value
                 else np.zeros((0, 3), np.int32))
    finally:
        lib.nphm_free(vp)
        lib.nphm_free(fp)
    return verts, faces


def mesh_from_logits(logits: np.ndarray, mini, maxi, resolution: int) -> Mesh:
    """SDF logits (flattened res^3, negative inside) -> world-space mesh."""
    logits = np.reshape(np.asarray(logits, np.float32), (resolution,) * 3)
    verts, faces = marching_tets(-logits, 0.0)
    step = (np.asarray(maxi, np.float32) - np.asarray(mini, np.float32)) / (
        resolution - 1
    )
    verts = verts * step[None, :] + np.asarray(mini, np.float32)[None, :]
    return Mesh(verts, faces.astype(np.int64))
