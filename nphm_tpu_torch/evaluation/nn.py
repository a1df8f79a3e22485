"""Nearest neighbours for point-cloud metrics (counterpart of
``nphm_tpu/evaluation/nn.py``): a chunked brute force on the card, scipy's
cKDTree on the host.

The reference keeps the queries on the host (scipy cKDTree,
``src/NPHM/evaluation/metrics.py:2,180``).  On the card the same query is a
product: ``|r|^2 - 2 q.r^T`` ranks the reference points of each query row
(``|q|^2`` is constant along the row).  The expansion form is
ill-conditioned for points much closer than the cloud radius, so both clouds
are shifted by the reference centroid and the 3-wide product runs in
float64 (no TF32, whatever ``torch.backends.cuda.matmul.allow_tf32`` says;
the caller's flag is neither read nor set): the key is then exact to ~1e-16
of the radius squared.  Reference rows are padded to whole 256-row blocks
with points at a far sentinel.  The candidates are the nearest point of each
of the 8 blocks whose nearest point is nearest (one min pass over the tile,
then ``torch.topk`` over the per-block minima): they hold the key's argmin,
and a whole-row top-k of the float64 tile cost 5x as much on the card
(PERF.md, section 6).  The winner is re-ranked among them on difference-based
float32 distances, which give the returned distance.

Query rows go through in chunks sized from the device's free memory: a
chunk's float64 distance tile and the reduction's workspace take at most a
quarter of it.  A query holds a process-wide lock while it runs: each sizes
its chunks from the memory free when it starts, so concurrent callers (the
evaluation CLI's thread pool) would together overcommit the card, which
runs them one after another anyway.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

_K = 8  # re-rank candidates: the nearest point of each of the 8 nearest blocks
_SENTINEL = 1.0e6  # padded reference points land here: never a candidate
_REF_TILE = 256
# bytes a query row costs per reference point: the float64 tile, and as much
# again for the reduction's workspace
_BYTES_PER_PAIR = 16
_MAX_CHUNK = 65536
_LOCK = threading.Lock()  # one query on the device at a time

# ``backend="auto"`` takes the card from this many query x reference pairs
# on: 25k x 25k, the smallest size ``python -m nphm_tpu_torch.profile_nn``
# measures, where the card already beat scipy's cKDTree 4x (PERF.md,
# section 5); the process's first call also pays CUDA's start, ~0.7 s.
AUTO_DEVICE_PAIRS = 25_000 * 25_000


def _chunk_rows(n_ref: int, device: torch.device) -> int:
    if device.type != "cuda":
        return 2048
    free, _total = torch.cuda.mem_get_info(device)
    free += torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    rows = (free // 4) // (_BYTES_PER_PAIR * n_ref)
    return int(max(256, min(_MAX_CHUNK, rows)))


def brute_force_directed(query: np.ndarray, ref: np.ndarray, device="cuda"):
    """Nearest neighbour in ``ref`` of each ``query`` point by brute force on
    ``device``.  Returns float64 ``dist`` [N] and int64 ``idx`` [N], shaped as
    ``scipy.spatial.cKDTree.query`` returns them."""
    device = torch.device(device)
    query = np.ascontiguousarray(query, np.float32)
    ref = np.ascontiguousarray(ref, np.float32)
    if len(ref) == 0:
        raise ValueError("nearest neighbours: the reference cloud is empty")
    if len(query) == 0:
        return np.zeros(0, np.float64), np.zeros(0, np.int64)
    with _LOCK:
        shift = ref.mean(axis=0, keepdims=True)  # conditioning: shrink |coords|
        m_pad = -(-len(ref) // _REF_TILE) * _REF_TILE
        r = torch.full((m_pad, 3), _SENTINEL, dtype=torch.float32, device=device)
        r[: len(ref)] = torch.from_numpy(ref - shift).to(device)
        q = torch.from_numpy(query - shift).to(device)
        r64 = r.double()
        rt64 = r64.t().contiguous()
        rn64 = (r64 * r64).sum(dim=1)
        n_blocks = m_pad // _REF_TILE
        k = min(_K, n_blocks)
        chunk = _chunk_rows(m_pad, device)
        dist = torch.empty(len(q), dtype=torch.float32, device=device)
        idx = torch.empty(len(q), dtype=torch.int64, device=device)
        for s in range(0, len(q), chunk):
            qc = q[s : s + chunk]
            # rank key |r|^2 - 2 q.r in float64: exact enough to keep every true
            # neighbour among the candidates, and untouched by the TF32 flag
            key = torch.addmm(rn64, qc.double(), rt64, beta=1.0, alpha=-2.0)
            bmin, barg = key.view(len(qc), n_blocks, _REF_TILE).min(dim=2)
            del key
            top = torch.topk(bmin, k, dim=1, largest=False, sorted=False).indices
            cand = top * _REF_TILE + barg.gather(1, top)
            diff = qc[:, None, :] - r[cand]  # [chunk, K, 3], exact re-rank
            d2 = (diff * diff).sum(dim=-1)
            best, j = d2.min(dim=1)
            dist[s : s + chunk] = best.sqrt()
            idx[s : s + chunk] = cand.gather(1, j[:, None])[:, 0]
        return dist.cpu().numpy().astype(np.float64), idx.cpu().numpy()


def use_device(n_query: int, n_ref: int) -> bool:
    """``backend="auto"``: the card when one is attached and the problem is
    past the measured cross-over, else scipy."""
    return n_query * n_ref >= AUTO_DEVICE_PAIRS and torch.cuda.is_available()


def nearest_neighbors(query: np.ndarray, ref: np.ndarray, backend: str = "auto"):
    """Nearest neighbour of each ``query`` point in ``ref``.

    backend: ``"auto"`` (the card for large problems when one is attached,
    else scipy), ``"device"`` (the card; raises without CUDA, never gives
    way to scipy) or ``"scipy"``.  Returns (dist [N] float64, idx [N] int64)
    as ``scipy.spatial.cKDTree.query`` does.
    """
    if backend not in ("auto", "device", "scipy"):
        raise ValueError(f"unknown nearest-neighbour backend {backend!r}")
    query = np.asarray(query)
    ref = np.asarray(ref)
    if backend == "device":
        if not torch.cuda.is_available():
            raise RuntimeError('nearest_neighbors(backend="device") needs a CUDA device')
        return brute_force_directed(query, ref, "cuda")
    if backend == "auto" and use_device(len(query), len(ref)):
        return brute_force_directed(query, ref, "cuda")
    from scipy.spatial import cKDTree

    return cKDTree(ref).query(query)
