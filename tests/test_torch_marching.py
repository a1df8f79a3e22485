"""The port's host marching library (``nphm_tpu_torch/csrc/host/marching.cpp``):
its dense, window and sparse-block entries give bit-identical vertices, run
after run.

The field is the analytic sphere of ``tests/test_sparse_extract.py``'s
block test (res 48, 8 x 8 x 16 blocks).  Every shared tet edge's crossing
is interpolated from its endpoint with the lower global key, the dense and
window entries march a fixed number of z-bands, and the blocks entry gives
each block its own buffer, merged in block order; so each entry's output is
the same array on every run, and the three agree exactly up to vertex
order.  The JAX package's marching, interpolating from the tet's separated
corner, agrees to the last bits.
"""

import numpy as np
import pytest

from nphm_tpu.ops.marching import marching_tets as jax_marching_tets
from nphm_tpu_torch.ops.marching import (
    marching_tets,
    marching_tets_blocks,
    marching_tets_window,
)

RES = 48
BLOCK = (8, 8, 16)
REPEATS = 24


def sphere():
    ax = np.linspace(-1, 1, RES, dtype=np.float32)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    return 0.6 - np.sqrt(X**2 + Y**2 + Z**2)


def blocks_of(field):
    blocks, offs = [], []
    for i in range(RES // BLOCK[0]):
        for j in range(RES // BLOCK[1]):
            for k in range(RES // BLOCK[2]):
                o = (i * BLOCK[0], j * BLOCK[1], k * BLOCK[2])
                blk = np.full(tuple(b + 1 for b in BLOCK), -1e9, np.float32)
                ext = [min(b + 1, RES - x) for b, x in zip(BLOCK, o)]
                blk[:ext[0], :ext[1], :ext[2]] = field[o[0]:o[0] + ext[0],
                                                       o[1]:o[1] + ext[1],
                                                       o[2]:o[2] + ext[2]]
                blocks.append(blk)
                offs.append(o)
    return np.stack(blocks), np.asarray(offs, np.int32)


def slabs(field, width=8):
    """x-slabs of ``width`` cells with one +x halo plane, welded on the
    returned global edge keys."""
    verts, keys = [], []
    for x0 in range(0, RES - 1, width):
        v, k, _ = marching_tets_window(field[x0:x0 + width + 1], (x0, 0, 0), (RES,) * 3)
        verts.append(v)
        keys.append(k)
    keys = np.concatenate(keys)
    _, first = np.unique(keys, return_index=True)
    return np.concatenate(verts)[np.sort(first)]


def _sorted(v):
    return v[np.lexsort(v.T)]


def test_entries_are_deterministic_and_agree_exactly():
    field = sphere()
    blocks, offs = blocks_of(field)
    v_d, f_d = marching_tets(field, 0.0)
    assert len(v_d) > 1000
    runs = {"dense": [], "window": [], "slabs": [], "blocks": []}
    for _ in range(REPEATS):
        runs["dense"].append(marching_tets(field, 0.0))
        v_w, _, f_w = marching_tets_window(field, (0, 0, 0), (RES,) * 3)
        runs["window"].append((v_w, f_w))
        runs["slabs"].append((slabs(field), None))
        runs["blocks"].append(marching_tets_blocks(blocks, offs, (RES,) * 3, 0.0))
    for name, outs in runs.items():
        v0, f0 = outs[0]
        for v, f in outs[1:]:  # run to run: the same arrays, in the same order
            assert np.array_equal(v, v0), name
            assert f is None or np.array_equal(f, f0), name
        # across entries: the same vertices, bit for bit
        assert v0.shape == v_d.shape, name
        assert np.array_equal(_sorted(v0), _sorted(v_d)), name
    # the full window is the dense pass itself
    assert np.array_equal(runs["window"][0][0], v_d)
    assert np.array_equal(runs["window"][0][1], f_d)
    # blocks: watertight, every edge shared by exactly two triangles
    f_s = runs["blocks"][0][1]
    assert len(f_s) == len(f_d)
    e = np.concatenate([f_s[:, [0, 1]], f_s[:, [1, 2]], f_s[:, [2, 0]]])
    _, cnt = np.unique(np.sort(e, axis=1), axis=0, return_counts=True)
    assert (cnt == 2).all()


@pytest.mark.parametrize("iso", [0.0, 0.25])
def test_dense_matches_jax_marching_to_last_bits(iso):
    """The port's dense vertices against the JAX package's host marching:
    the same vertex and face counts, and each vertex within 1e-5 grid units
    of its nearest JAX vertex and back."""
    from scipy.spatial import cKDTree

    field = sphere()
    v, f = marching_tets(field, iso)
    jv, jf = jax_marching_tets(field, iso)
    assert v.shape == jv.shape and f.shape == jf.shape
    assert cKDTree(jv).query(v)[0].max() <= 1e-5
    assert cKDTree(v).query(jv)[0].max() <= 1e-5
