"""Marching-tetrahedra surface extraction on the host (counterpart of
``nphm_tpu/ops/marching.py``): ``mesh_from_logits`` negates the SDF logits,
extracts the 0-level set with ``csrc/host/marching.cpp`` and rescales the
vertices from grid-index to world coordinates.  ``marching_tets_window`` and
``marching_tets_blocks`` march a window or aligned blocks of a larger
lattice with global edge keys; all three entries emit the same vertices
bit for bit (up to order), run to run and on any core count.
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
    verts, faces, _ = _take(lib, vp, fp, nv, nf)
    return verts, faces


def _take(lib, vp, fp, nv, nf, kp=None):
    """Copy the library's output arrays and free them."""
    try:
        verts = (np.ctypeslib.as_array(vp, shape=(nv.value, 3)).copy() if nv.value
                 else np.zeros((0, 3), np.float32))
        faces = (np.ctypeslib.as_array(fp, shape=(nf.value, 3)).copy() if nf.value
                 else np.zeros((0, 3), np.int32))
        keys = None
        if kp is not None:
            keys = (np.ctypeslib.as_array(kp, shape=(nv.value,)).copy() if nv.value
                    else np.zeros((0,), np.int64))
    finally:
        lib.nphm_free(vp)
        lib.nphm_free(fp)
        if kp is not None:
            lib.nphm_free(kp)
    return verts, faces, keys


def marching_tets_window(grid: np.ndarray, offset, global_dims, iso: float = 0.0):
    """Dense marching over a window of a larger lattice.

    grid: [lx, ly, lz] float32 whose local (0, 0, 0) sits at global voxel
    ``offset``; cells clamp at ``global_dims``.  Coordinates and edge keys
    are global, so disjoint windows sharing one halo plane weld into the
    full dense mesh.  Returns (vertices [V, 3] float32 in global grid-index
    coordinates, keys [V] int64, faces [F, 3] int32).
    """
    grid = np.ascontiguousarray(grid, np.float32)
    if grid.ndim != 3:
        raise ValueError(f"grid must be 3-D, got {grid.shape}")
    lib = get_lib()
    vp = ctypes.POINTER(ctypes.c_float)()
    kp = ctypes.POINTER(ctypes.c_int64)()
    fp = ctypes.POINTER(ctypes.c_int32)()
    nv = ctypes.c_int64()
    nf = ctypes.c_int64()
    rc = lib.nphm_marching_tets_window(
        grid.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        grid.shape[0], grid.shape[1], grid.shape[2],
        *(ctypes.c_int64(int(v)) for v in (*offset, *global_dims)), ctypes.c_float(iso),
        ctypes.byref(vp), ctypes.byref(kp), ctypes.byref(nv), ctypes.byref(fp),
        ctypes.byref(nf),
    )
    if rc != 0:
        raise RuntimeError(f"marching_tets_window failed with code {rc}")
    verts, faces, keys = _take(lib, vp, fp, nv, nf, kp)
    return verts, keys, faces


def marching_tets_blocks(blocks: np.ndarray, offsets: np.ndarray, global_dims,
                         iso: float = 0.0):
    """Boundary of {field > iso} over aligned blocks of a larger lattice.

    blocks: [K, bsx+1, bsy+1, bsz+1] float32, each block's owned voxels and
    one halo plane per axis; offsets: [K, 3] int32 global voxel origins;
    global_dims: (rx, ry, rz) of the lattice (edge keys are global, so block
    seams weld exactly).  Returns (vertices [V, 3] float32 in global
    grid-index coordinates, faces [F, 3] int32).
    """
    blocks = np.ascontiguousarray(blocks, np.float32)
    offsets = np.ascontiguousarray(offsets, np.int32)
    if blocks.ndim != 4 or offsets.shape != (blocks.shape[0], 3):
        raise ValueError(f"bad shapes: {blocks.shape}, {offsets.shape}")
    lib = get_lib()
    vp = ctypes.POINTER(ctypes.c_float)()
    fp = ctypes.POINTER(ctypes.c_int32)()
    nv = ctypes.c_int64()
    nf = ctypes.c_int64()
    rc = lib.nphm_marching_tets_blocks(
        blocks.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        blocks.shape[0], blocks.shape[1] - 1, blocks.shape[2] - 1, blocks.shape[3] - 1,
        *(int(v) for v in global_dims), ctypes.c_float(iso),
        ctypes.byref(vp), ctypes.byref(nv), ctypes.byref(fp), ctypes.byref(nf),
    )
    if rc != 0:
        raise RuntimeError(f"marching_tets_blocks failed with code {rc}")
    verts, faces, _ = _take(lib, vp, fp, nv, nf)
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
