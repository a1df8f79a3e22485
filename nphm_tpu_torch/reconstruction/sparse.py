"""Sparse two-pass mesh extraction, O(surface) instead of O(volume)
(counterpart of ``nphm_tpu/reconstruction/sparse.py``).

The iso-surface crosses a small share of the res^3 lattice.  With the
field's Lipschitz constant bounded by ``lip`` (an eikonal-trained SDF has
|grad f| ~ 1), three phases do work in proportion to the surface:

1. **Coarse pass** (device): a 4x-strided lattice, grouped so that each
   fine (8, 8, 16) block owns 2 x 2 x 4 samples, reduced to per-block
   (min, max).  A block can matter to the surface only if ``min |f| <
   lip * (r_cov + ||h||)``: ``r_cov`` is the cover radius of its samples,
   ``||h||`` one cell diagonal (the corners it lends to cells owned by its
   minus-side neighbours).  Every other block is sign-constant and
   seam-irrelevant for any field within ``lip``.
2. **Fine pass** (device): only the candidate blocks, each exactly one
   1024-point cull tile of K1 (the tile of the dense grid at tile 1024, so
   the values are the dense grid's bit for bit); per-block (min, max) on
   the device, the block data stays there.
3. **Sparse transfer and marching** (host): only blocks whose
   neighbourhood (the block and its 7 "+"-side neighbours) straddles the
   iso level are copied, assembled with one halo plane per axis, and
   marched by ``ops.marching.marching_tets_blocks``, whose global edge
   keys weld the block seams exactly.

NPHM decoders run K1 (``ops.ensemble.nphm_sdf``), NPM decoders K7
(``ops.trunk.npm_sdf``), both their plain versions on the CPU.  Two
details of the JAX package are dropped: its ``_bucket`` padding of the
candidate and transfer counts exists only to reuse compiled programs, so
the port launches exactly the candidate blocks; and its ``_gather`` is a
tensor index on the device followed by one copy.

With a ``device_mesh`` (a ``parallel.DataMesh`` of more than one rank, the
JAX package's ``device_mesh=``) the coarse lattice is split over the ranks
in groups of 64 blocks (one cull tile of coarse samples) and the candidate
blocks, padded to a multiple of the rank count with repeats of the first,
in equal shares: one K1 (or K7) launch per rank and pass, each gathered on
every rank, so every rank selects the same blocks.  Rank 0 assembles and
marches, and every rank returns its mesh.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from nphm_tpu_torch.ops.ensemble import CULL_EPS, grid_axes, nphm_sdf, prepare_ensemble_operands
from nphm_tpu_torch.ops.marching import marching_tets_blocks
from nphm_tpu_torch.ops.trunk import npm_sdf
from nphm_tpu_torch.parallel.mesh import (
    data_parallel,
    device_of,
    gather_rows,
    is_main,
    shard_rows,
)
from nphm_tpu_torch.reconstruction.extract import (
    _as_lat,
    extract_mesh,
    share_mesh,
    torch_dtype,
)
from nphm_tpu_torch.utils.mesh_io import Mesh as TriMesh
from nphm_tpu_torch.utils.params import tree_to

BLOCK = (8, 8, 16)  # fine voxels per block == one 1024-point cull tile
COARSE = (4, 4, 4)  # coarse sample stride (per block: 2 x 2 x 4 samples)
_TILE = BLOCK[0] * BLOCK[1] * BLOCK[2]


def _block_grid(res):
    return (res // BLOCK[0], res // BLOCK[1], res // BLOCK[2])


def _block_points(axes, block_ids, nb, local_off):
    """Lattice points of each block at the given local offsets.

    block_ids: [K] int64 linear ids b = (bi * nby + bj) * nbz + bk;
    local_off: [3, n_local] int64.  Returns [K * n_local, 3], block-major.
    """
    _nbx, nby, nbz = nb
    bi = block_ids // (nby * nbz)
    bj = (block_ids // nbz) % nby
    bk = block_ids % nbz
    base = torch.stack([bi * BLOCK[0], bj * BLOCK[1], bk * BLOCK[2]], dim=-1)  # [K, 3]
    idx = base[:, None, :] + local_off.T[None, :, :]  # [K, L, 3]
    pts = torch.stack([axes[d][idx[..., d]] for d in range(3)], dim=-1)
    return pts.reshape(-1, 3)


def _fine_offsets(device):
    """Local (x, y, z) offsets of a block's voxels, z fastest (the brick
    order of a 1024-point cull tile)."""
    lx = torch.arange(_TILE, dtype=torch.int64, device=device)
    return torch.stack([lx // (BLOCK[1] * BLOCK[2]), (lx // BLOCK[2]) % BLOCK[1],
                        lx % BLOCK[2]])  # [3, 1024]


def _coarse_offsets(device):
    """Local offsets of a block's coarse samples (2 x 2 x 4 at stride 4,
    centred: they cover the block and its halo within ||2h||)."""
    g = [np.arange(2, BLOCK[d], COARSE[d]) for d in range(3)]
    X, Y, Z = np.meshgrid(*g, indexing="ij")
    return torch.tensor(np.stack([X.ravel(), Y.ravel(), Z.ravel()]), dtype=torch.int64,
                        device=device)  # [3, 16]


def _sdf(decoder, params, pts, lat, operands, cull_eps):
    """The field at pts: K1 at the 1024-point tile (NPHM) or K7 (NPM)."""
    if decoder.kind == "nphm":
        return nphm_sdf(params, decoder.cfg, pts, lat, tile=_TILE, cull_eps=cull_eps,
                        operands=operands)
    return npm_sdf(params, decoder.cfg, pts, lat)


@torch.no_grad()
def coarse_pass(decoder, params, lat, axes, res, *, operands=None, cull_eps=CULL_EPS,
                device_mesh=None):
    """Per-block (min, max) over each block's coarse samples: [n_blocks, 2]
    on the device (64 blocks' samples fill one 1024-point tile)."""
    nb = _block_grid(res)
    n = nb[0] * nb[1] * nb[2]
    dev = axes[0].device
    off = _coarse_offsets(dev)
    per_tile = _TILE // off.shape[1]
    own = shard_rows(n, device_mesh, granule=per_tile)
    ids = torch.arange(own.start, own.stop, dtype=torch.int64, device=dev)
    sdf = _sdf(decoder, params, _block_points(axes, ids, nb, off), lat, operands,
               cull_eps).reshape(len(ids), off.shape[1])
    mm = torch.stack([sdf.amin(dim=1), sdf.amax(dim=1)], dim=-1)
    if data_parallel(device_mesh) is not None:
        mm = gather_rows(mm, n, device_mesh, granule=per_tile)
    return mm


@torch.no_grad()
def fine_pass(decoder, params, lat, axes, res, block_ids, *, operands=None,
              cull_eps=CULL_EPS, device_mesh=None):
    """Fine field of blocks ``block_ids`` [K] (int64, device): (sdf [K,
    1024] in block order, minmax [K, 2]), both on the device."""
    nb = _block_grid(res)
    mesh = data_parallel(device_mesh)
    k = len(block_ids)
    if mesh is not None:
        k_pad = -(-k // mesh.size) * mesh.size
        block_ids = torch.cat([block_ids, block_ids[:1].expand(k_pad - k)])
        block_ids = block_ids[shard_rows(k_pad, mesh)]
    sdf = _sdf(decoder, params, _block_points(axes, block_ids, nb,
                                              _fine_offsets(block_ids.device)),
               lat, operands, cull_eps).reshape(-1, _TILE)
    if mesh is not None:
        sdf = gather_rows(sdf, k_pad, mesh)[:k]
    return sdf, torch.stack([sdf.amin(dim=1), sdf.amax(dim=1)], dim=-1)


def _assemble(sel_ids, data, fill_of, nb, res):
    """[K, 9, 9, 17] blocks with +1 halo planes: real data where the
    neighbor block was transferred, sign-correct fill elsewhere.

    sel_ids: [K] linear ids of transferred blocks; data: [K, 8, 8, 16] f32;
    fill_of: [n_blocks] f32 sign-correct fill value per block (clamped
    lookups beyond the lattice return +inf-like outside values).
    """
    nbx, nby, nbz = nb
    K = len(sel_ids)
    bx, by, bz = BLOCK
    idx_map = np.full((nbx + 1, nby + 1, nbz + 1), -1, np.int64)
    bi = sel_ids // (nby * nbz)
    bj = (sel_ids // nbz) % nby
    bk = sel_ids % nbz
    idx_map[bi, bj, bk] = np.arange(K)

    fill = np.full((nbx + 1, nby + 1, nbz + 1), 1e9, np.float32)
    fill[:nbx, :nby, :nbz] = fill_of.reshape(nbx, nby, nbz)

    full = np.empty((K, bx + 1, by + 1, bz + 1), np.float32)
    full[:, :bx, :by, :bz] = data

    # (di, dj, dk, destination slices, source slices of the neighbor block)
    sides = [
        ((1, 0, 0), np.s_[bx, :by, :bz], np.s_[0, :, :]),
        ((0, 1, 0), np.s_[:bx, by, :bz], np.s_[:, 0, :]),
        ((0, 0, 1), np.s_[:bx, :by, bz], np.s_[:, :, 0]),
        ((1, 1, 0), np.s_[bx, by, :bz], np.s_[0, 0, :]),
        ((1, 0, 1), np.s_[bx, :by, bz], np.s_[0, :, 0]),
        ((0, 1, 1), np.s_[:bx, by, bz], np.s_[:, 0, 0]),
        ((1, 1, 1), np.s_[bx, by, bz], np.s_[0, 0, 0]),
    ]
    for (di, dj, dk), dst, src in sides:
        ni, nj, nk = bi + di, bj + dj, bk + dk
        n_idx = idx_map[ni, nj, nk]
        have = n_idx >= 0
        # default: neighbor's fill value (sign-only role; those cells are
        # provably crossing-free)
        full[(slice(None),) + (dst if isinstance(dst, tuple) else (dst,))] = (
            fill[ni, nj, nk].reshape((K,) + (1,) * (full[(0,) + dst].ndim))
        )
        if have.any():
            ks = np.nonzero(have)[0]
            full[(ks,) + dst] = data[(n_idx[have],) + src]
    return full, np.stack([bi * bx, bj * by, bk * bz], axis=-1).astype(np.int32)


@torch.no_grad()
def probe_lip(decoder, params, lat, mini, maxi, device, *, operands=None,
              cull_eps=CULL_EPS, res: int = 64, device_mesh=None) -> float:
    """Finite-difference Euclidean gradient bound from a dense res-64 probe
    (every block of the res-64 lattice through the fine pass's launch):
    sup ||grad f||^2 <= sum_d sup |df/dx_d|^2 over the lattice."""
    nb = _block_grid(res)
    ids = torch.arange(nb[0] * nb[1] * nb[2], dtype=torch.int64, device=device)
    sdf, _ = fine_pass(decoder, params, lat, grid_axes(mini, maxi, res, device), res, ids,
                       operands=operands, cull_eps=cull_eps, device_mesh=device_mesh)
    bx, by, bz = BLOCK
    field = (sdf.cpu().numpy().reshape(nb[0], nb[1], nb[2], bx, by, bz)
             .transpose(0, 3, 1, 4, 2, 5).reshape(res, res, res))
    h = (np.asarray(maxi) - np.asarray(mini)) / (res - 1)
    return float(np.sqrt(sum((np.abs(np.diff(field, axis=d)).max() / h[d]) ** 2
                             for d in range(3))))


def candidates(cmm, lip, h):
    """Ids of the blocks whose coarse (min, max) [n_blocks, 2] comes within
    the margin of the iso level, for a field within ``lip`` on a lattice of
    spacing ``h`` [3]."""
    r_cov = float(np.linalg.norm(np.asarray(COARSE) / 2.0 * h))
    # the margin covers zeros inside a block (within r_cov of its nearest
    # coarse sample) and the corners a block lends to cells owned by its
    # minus-side neighbours (within one cell diagonal of their crossing)
    margin = float(lip) * (r_cov + float(np.linalg.norm(h)))
    min_abs = np.where((cmm[:, 0] <= 0.0) & (cmm[:, 1] >= 0.0), 0.0,
                       np.minimum(np.abs(cmm[:, 0]), np.abs(cmm[:, 1])))
    return np.nonzero(min_abs < margin)[0].astype(np.int64)


def _empty():
    return TriMesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64))


def extract_mesh_sparse(decoder, params, encoding, mini=(-0.55, -0.5, -0.95),
                        maxi=(0.55, 0.75, 0.4), resolution: int = 256, lip=2.0,
                        transfer_dtype=None, stats=None, cull_eps: float = CULL_EPS,
                        device=None, device_mesh=None) -> TriMesh:
    """Sparse two-pass extraction (NPHM and NPM decoders, res % 16 == 0).

    lip: Lipschitz bound of the field used for the coarse pass's margin.
    The default 2.0 doubles an eikonal field's |grad f| ~ 1.  A larger lip
    enlarges the candidate set (slower, safer); one below the field's true
    constant can miss surface in blocks whose coarse samples all read far.
    The candidate blocks' fine variation is checked against it at no cost,
    with a ``RuntimeWarning`` (and ``stats["lip_observed"]``) when violated.
    ``lip="auto"`` probes a res-64 lattice and uses twice the measured
    finite-difference bound; ``lip=inf`` evaluates every block.

    transfer_dtype: e.g. ``np.float16`` halves the (already sparse) copy.
    stats: optional dict that receives n_blocks, n_candidates,
    n_transferred, lip_observed (and lip_auto).
    Falls back to ``extract_mesh`` (float32, as the JAX package does) for
    other decoders and for resolutions not divisible by 16 or below 32.
    device_mesh: the passes split over its ranks (module docstring); every
    rank returns the mesh, and rank 0 alone warns.
    """
    dev = device_of(device, device_mesh)
    device_mesh = data_parallel(device_mesh)
    res = int(resolution)
    if decoder.kind not in ("nphm", "npm") or res % 16 or res < 32:
        return extract_mesh(decoder, params, encoding, mini, maxi, res, device=dev,
                            device_mesh=device_mesh)
    params = tree_to(params, dev)
    lat = _as_lat(encoding, dev)[0]
    mini = tuple(float(x) for x in mini)
    maxi = tuple(float(x) for x in maxi)
    nb = _block_grid(res)
    n_blocks = nb[0] * nb[1] * nb[2]
    axes = grid_axes(mini, maxi, res, dev)
    kw = dict(cull_eps=cull_eps, device_mesh=device_mesh)
    if decoder.kind == "nphm":
        with torch.no_grad():
            kw["operands"] = prepare_ensemble_operands(params, decoder.cfg, lat)

    if lip == "auto":
        lip = 2.0 * probe_lip(decoder, params, lat, mini, maxi, dev, **kw)
        if stats is not None:
            stats["lip_auto"] = float(lip)

    # --- phase 1: coarse pass and margin selection
    cmm = coarse_pass(decoder, params, lat, axes, res, **kw).cpu().numpy()  # [n_blocks, 2]
    h = (np.asarray(maxi) - np.asarray(mini)) / (res - 1)
    cand = candidates(cmm, lip, h)
    if len(cand) == 0:
        return _empty()

    # --- phase 2: fine pass over exactly the candidate blocks
    sdf, fmm_dev = fine_pass(decoder, params, lat, axes, res,
                             torch.as_tensor(cand, device=dev), **kw)
    data_dev = sdf.reshape(-1, *BLOCK)
    if transfer_dtype is not None:
        data_dev = data_dev.to(torch_dtype(transfer_dtype))
    fmm = fmm_dev.cpu().numpy()

    # --- the Lipschitz assumption, checked at no extra evaluation: a
    # candidate block's fine (max - min) is at most lip * its diameter for
    # any field within lip; a violation means blocks outside the candidate
    # set may hold surface the coarse margin skipped
    block_diag = float(np.linalg.norm(np.asarray(BLOCK) * h))
    lip_observed = float((fmm[:, 1] - fmm[:, 0]).max() / block_diag)
    if stats is not None:
        stats["lip_observed"] = lip_observed
    if lip_observed > float(lip) and is_main(device_mesh):
        warnings.warn(
            f"extract_mesh_sparse: observed in-block field variation implies "
            f"Lipschitz constant >= {lip_observed:.2f} > assumed lip={float(lip):.2f}; "
            f"the coarse pass may have skipped blocks containing surface.  Pass "
            f"lip={lip_observed * 2:.1f} or lip='auto' (or use the dense path) for a "
            f"sound extraction.", RuntimeWarning, stacklevel=2)

    # --- phase 3: straddle test over each block and its 7 "+"-side neighbours
    nbx, nby, nbz = nb
    mn = np.full((nbx + 1, nby + 1, nbz + 1), np.float32(np.inf))
    mx = np.full((nbx + 1, nby + 1, nbz + 1), np.float32(-np.inf))
    ci, cj, ck = cand // (nby * nbz), (cand // nbz) % nby, cand % nbz
    mn[ci, cj, ck] = fmm[:, 0]
    mx[ci, cj, ck] = fmm[:, 1]
    u_mn = np.full((nbx, nby, nbz), np.float32(np.inf))
    u_mx = np.full((nbx, nby, nbz), np.float32(-np.inf))
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                np.minimum(u_mn, mn[di : di + nbx, dj : dj + nby, dk : dk + nbz], out=u_mn)
                np.maximum(u_mx, mx[di : di + nbx, dj : dj + nby, dk : dk + nbz], out=u_mx)
    # straddle_own[m]: a cell owned by m may cross.  A block's data is needed
    # if it or a minus-side neighbour owns such a cell (its halo corners
    # must be real, not the sign-only fill); crossing corners always lie in
    # candidate blocks, so needed blocks are candidates
    straddle_own = (u_mn <= 0.0) & (u_mx >= 0.0)
    need = np.zeros_like(straddle_own)
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                need[di:, dj:, dk:] |= straddle_own[: nbx - di or None, : nby - dj or None,
                                                    : nbz - dk or None]
    sel_mask = np.zeros(n_blocks, bool)
    sel_mask[cand] = need.reshape(-1)[cand]
    sel = np.nonzero(sel_mask)[0]
    if stats is not None:
        stats.update(n_blocks=n_blocks, n_candidates=int(len(cand)),
                     n_transferred=int(len(sel)))
    if len(sel) == 0:
        return _empty()
    if not is_main(device_mesh):
        return share_mesh(None, device_mesh)

    # copy only the straddling blocks
    rows = torch.as_tensor(np.searchsorted(cand, sel), device=dev)
    data = data_dev[rows].cpu().numpy().astype(np.float32)

    # sign-correct fill per block: fine (min + max) / 2 for candidates,
    # the coarse midpoint for the rest (both crossing-free where used)
    fill_of = ((cmm[:, 0] + cmm[:, 1]) * 0.5).astype(np.float32)
    fill_of[cand] = (fmm[:, 0] + fmm[:, 1]) * 0.5

    full, offsets = _assemble(sel, data, fill_of, nb, res)
    verts, faces = marching_tets_blocks(-full, offsets, (res, res, res), 0.0)
    step = (np.asarray(maxi, np.float32) - np.asarray(mini, np.float32)) / (res - 1)
    verts = verts * step[None, :] + np.asarray(mini, np.float32)[None, :]
    return share_mesh(TriMesh(verts.astype(np.float32), faces.astype(np.int64)), device_mesh)
