"""Grid logits, mesh extraction and mesh deformation (counterpart of
``nphm_tpu/reconstruction/extract.py``).

Grid logits come from K1's brick-ordered dense-grid evaluation for the NPHM
ensemble (``ops.ensemble.nphm_grid_sdf``) and from K7 for the NPM family's
DeepSDF (``ops.trunk.npm_grid_sdf``); marching runs on the host through the
port's C++ ``ops.marching.mesh_from_logits``.  Deformation pushes mesh
vertices through the deformation trunk: K7 on the GPU (``ops.trunk``) for
every field whose conditioning is row-constant, the decoder's plain chunked
``apply`` on the CPU and for an ``interpolate`` field on any device.

Also here, as in the JAX package:

- chunked point evaluators (``make_point_evaluator`` and the SDF,
  backward-warp and deformation evaluators built on it, ``get_logits``,
  ``get_logits_backward``): plain functions on tensors of one device; an
  NPHM decoder's SDF runs through ``nphm_sdf`` (K1 on the GPU), an NPM
  decoder's through ``npm_sdf`` (K7), offsets through ``deformation`` /
  ``deepsdf_trunk`` (K7), each its plain version on the CPU;
- ``backward_grid_logits``: brick-ordered grid points warped in chunks
  through the expression field (K7), then K1 at the grid's tile;
- ``extract_mesh_streamed``: K1 over x-slabs, every slab queued on the
  stream up front, each slab's logits copied into pinned host memory
  behind a CUDA event, and slab k-1 marched in worker threads while the
  card computes slab k; the seams weld on global edge keys.

Multi-device arguments (``mesh``, ``device_mesh``) are left out.
"""

from __future__ import annotations

import concurrent.futures as cf
import time

import numpy as np
import torch

from nphm_tpu_torch.ops.ensemble import (
    CULL_EPS,
    DEFAULT_TILE,
    _brick_points,
    _unbrick_gather,
    grid_axes,
    grid_tile,
    nphm_grid_sdf,
    nphm_sdf,
    prepare_ensemble_operands,
)
from nphm_tpu_torch.ops.marching import marching_tets_window, mesh_from_logits
from nphm_tpu_torch.ops.trunk import deepsdf_trunk, deformation, npm_grid_sdf, npm_sdf
from nphm_tpu_torch.utils.mesh_io import Mesh as TriMesh
from nphm_tpu_torch.utils.params import default_device, tree_device, tree_to

DEFAULT_CHUNK = 1 << 16


def _as_lat(encoding, device):
    return torch.tensor(np.asarray(encoding, np.float32), device=device).reshape(1, -1)


def _device(device):
    return default_device() if device is None else torch.device(device)


def _anchors(anchors, device):
    return None if anchors is None else torch.tensor(
        np.asarray(anchors, np.float32), device=device).reshape(-1, 3)


def torch_dtype(dtype):
    """The torch dtype of a numpy dtype (``np.float16`` -> ``torch.float16``)."""
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


# ---------------------------------------------------------------------------
# Chunked point evaluators
# ---------------------------------------------------------------------------


def make_point_evaluator(point_fn, chunk_size: int = DEFAULT_CHUNK, out_dim: int = 1,
                         device=None):
    """A chunked evaluator of a per-point function.

    point_fn: (ctx, pts [c, 3]) -> [c, out_dim] tensor, with c <=
    ``chunk_size``; ``ctx`` holds tensors on ``device`` (default
    ``default_device()``).  Returns ``evaluate(ctx, points [M, 3]) ->
    np.ndarray [M, out_dim]``: the points go to the device once, the
    result comes back in one copy.
    """
    dev = _device(device)

    @torch.no_grad()
    def evaluate(ctx, points) -> np.ndarray:
        pts = torch.as_tensor(np.asarray(points, np.float32).reshape(-1, 3), device=dev)
        out = torch.empty((pts.shape[0], out_dim), device=dev)
        for s in range(0, pts.shape[0], chunk_size):
            out[s : s + chunk_size] = point_fn(ctx, pts[s : s + chunk_size]).reshape(
                -1, out_dim)
        return out.cpu().numpy()

    return evaluate


def eval_sdf(decoder, params, pts, lat):
    """Eval-mode SDF [N] of an identity decoder at pts [N, 3] for one latent
    [lat_dim]: K1 (NPHM) or K7 (NPM) for CUDA tensors, their plain versions
    otherwise."""
    if decoder.kind == "nphm":
        return nphm_sdf(params, decoder.cfg, pts, lat)
    if decoder.kind == "npm":
        return npm_sdf(params, decoder.cfg, pts, lat)
    raise NotImplementedError(f"no SDF evaluation for decoder kind {decoder.kind!r}")


def per_point_conditioning(deformer) -> bool:
    """Is this an ``interpolate`` deformation field?  Its conditioning is per
    point, while K7 folds a row-constant one into biases, so its offsets go
    through the decoder's plain ``apply`` on every device (the JAX
    package's route for it too).  Decided from the config, before any
    launch."""
    return deformer.kind == "deformation" and deformer.cfg.per_point


def eval_offsets(deformer, params, pts, lat, anchors=None):
    """Eval-mode offsets [N, 3] of a deformation decoder at pts [N, 3] for
    one latent [D] (anchors [K, 3] for the compress, GNN and interpolate
    modes): K7 for CUDA tensors, its plain version otherwise; an
    ``interpolate`` field through its plain ``apply``."""
    if per_point_conditioning(deformer):
        anc = None if anchors is None else anchors.reshape(1, -1, 3)
        return deformer.apply(params, pts[None], lat.reshape(1, -1), anc)[0][0]
    if deformer.kind == "deformation":
        return deformation(params, deformer.cfg, pts, lat, anchors)
    if deformer.kind == "deformation_npm":
        return deepsdf_trunk(params, deformer.cfg, pts, lat.reshape(-1))[:, :3]
    raise NotImplementedError(f"no offsets for decoder kind {deformer.kind!r}")


def make_sdf_evaluator(decoder, chunk_size: int = DEFAULT_CHUNK, device=None):
    """Evaluator of an identity decoder's SDF; ctx {"params", "lat" [L]}."""

    def point_fn(ctx, pts):
        return eval_sdf(decoder, ctx["params"], pts, ctx["lat"])

    return make_point_evaluator(point_fn, chunk_size, 1, device)


def get_logits(decoder, params, encoding, grid_points, chunk_size: int = DEFAULT_CHUNK,
               evaluator=None, device=None) -> np.ndarray:
    """Chunked SDF of arbitrary points [M, 3] -> [M] (reference
    reconstruction.py:6-25)."""
    dev = _device(device)
    if evaluator is None:
        evaluator = make_sdf_evaluator(decoder, chunk_size, dev)
    ctx = {"params": tree_to(params, dev), "lat": _as_lat(encoding, dev)[0]}
    return evaluator(ctx, grid_points)[:, 0]


def make_backward_sdf_evaluator(decoder_shape, decoder_expr, chunk_size: int = DEFAULT_CHUNK,
                                device=None):
    """Backward-warp evaluator: points deformed by the expression field, then
    the identity SDF there (reference reconstruction.py:28-56).  ctx
    {"params_shape", "params_expr", "lat_shape" [L], "lat_expr" [D] or
    None, "anchors" [K, 3] or None}."""

    def point_fn(ctx, pts):
        if ctx.get("lat_expr") is not None:
            pts = pts + eval_offsets(decoder_expr, ctx["params_expr"], pts, ctx["lat_expr"],
                                     ctx.get("anchors"))
        return eval_sdf(decoder_shape, ctx["params_shape"], pts, ctx["lat_shape"])

    return make_point_evaluator(point_fn, chunk_size, 1, device)


def get_logits_backward(decoder_shape, decoder_expr, params_shape, params_expr,
                        encoding_shape, encoding_expr, grid_points, anchors=None,
                        chunk_size: int = DEFAULT_CHUNK, evaluator=None,
                        device=None) -> np.ndarray:
    """Backward-warp SDF of arbitrary points [M, 3] -> [M]."""
    dev = _device(device)
    if evaluator is None:
        evaluator = make_backward_sdf_evaluator(decoder_shape, decoder_expr, chunk_size, dev)
    ctx = {
        "params_shape": tree_to(params_shape, dev),
        "params_expr": None if params_expr is None else tree_to(params_expr, dev),
        "lat_shape": _as_lat(encoding_shape, dev)[0],
        "lat_expr": None if encoding_expr is None else _as_lat(encoding_expr, dev)[0],
        "anchors": _anchors(anchors, dev),
    }
    return evaluator(ctx, grid_points)[:, 0]


def make_deform_evaluator(deformer, chunk_size: int = DEFAULT_CHUNK, device=None):
    """Evaluator of a deformation field's offsets; ctx {"params", "lat" [D],
    "anchors" [K, 3] or None}."""

    def point_fn(ctx, pts):
        return eval_offsets(deformer, ctx["params"], pts, ctx["lat"], ctx.get("anchors"))

    return make_point_evaluator(point_fn, chunk_size, 3, device)


@torch.no_grad()
def backward_grid_logits(decoder_shape, decoder_expr, params_shape, params_expr,
                         encoding_shape, encoding_expr, mini, maxi, resolution: int,
                         anchors=None, chunk_size: int = DEFAULT_CHUNK,
                         tile: int = DEFAULT_TILE, cull_eps: float = CULL_EPS,
                         device=None) -> np.ndarray:
    """Backward-warp grid logits [res^3] (natural order) of an NPHM identity
    decoder (counterpart of ``pallas_backward_grid_logits``): grid points
    generated in brick order on the device, warped ``chunk_size`` at a time
    through the expression field (K7 on the GPU), then K1 over all of them
    at the grid's tile.  Warps are small and smooth, so warped bricks stay
    compact and culling keeps firing."""
    if decoder_shape.kind != "nphm":
        raise NotImplementedError("backward_grid_logits evaluates an NPHM ensemble")
    dev = _device(device)
    params_shape = tree_to(params_shape, dev)
    res = int(resolution)
    tile, brick = grid_tile(res, tile)
    n = res**3
    pts = _brick_points(grid_axes(mini, maxi, res, dev),
                        torch.arange(n, dtype=torch.int64, device=dev), res, brick, tile)
    if encoding_expr is not None:
        params_expr = tree_to(params_expr, dev)
        lat_e = _as_lat(encoding_expr, dev)[0]
        anc = _anchors(anchors, dev)
        for s in range(0, n, chunk_size):
            chunk = pts[s : s + chunk_size]
            pts[s : s + chunk_size] = chunk + eval_offsets(decoder_expr, params_expr, chunk,
                                                           lat_e, anc)
    sdf = nphm_sdf(params_shape, decoder_shape.cfg, pts, _as_lat(encoding_shape, dev)[0],
                   tile=tile, cull_eps=cull_eps)
    return sdf[_unbrick_gather(res, brick, tile, dev)].cpu().numpy()


def grid_logits(decoder, params, encoding, mini, maxi, resolution: int):
    """Dense-grid logits [res^3] (natural x-major order) as float32 numpy."""
    lat = _as_lat(encoding, tree_device(params))[0]
    if decoder.kind == "nphm":
        out = nphm_grid_sdf(params, decoder.cfg, lat, mini, maxi, int(resolution))
    elif decoder.kind == "npm":
        out = npm_grid_sdf(params, decoder.cfg, lat, mini, maxi, int(resolution))
    else:
        raise NotImplementedError(f"no grid logits for decoder kind {decoder.kind!r}")
    return out.cpu().numpy()


def extract_mesh(decoder, params, encoding, mini=(-0.55, -0.5, -0.95),
                 maxi=(0.55, 0.75, 0.4), resolution: int = 256, device=None,
                 return_timing: bool = False):
    """Grid-evaluate through K1 or K7 (their plain versions on the CPU), then
    march.

    The parameters move to ``device`` first (default ``default_device()``).
    With ``return_timing`` also returns {"grid_s", "march_s"}: the grid
    evaluation including its device->host copy, and host marching.
    """
    dev = default_device() if device is None else torch.device(device)
    params = tree_to(params, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    logits = grid_logits(decoder, params, encoding, mini, maxi, resolution)
    t1 = time.perf_counter()
    mesh = mesh_from_logits(logits, mini, maxi, resolution)
    t2 = time.perf_counter()
    if return_timing:
        return mesh, {"grid_s": t1 - t0, "march_s": t2 - t1}
    return mesh


# ---------------------------------------------------------------------------
# Streamed extraction
# ---------------------------------------------------------------------------


def _pick_n_slabs(res: int, bx: int, wanted: int) -> int:
    """Largest slab count <= wanted that splits res into whole x-brick rows."""
    blocks = res // bx
    best = 1
    for s in range(1, min(wanted, blocks) + 1):
        if blocks % s == 0:
            best = s
    return best


@torch.no_grad()
def slab_logits(params, cfg, lat, axes, res: int, n_slabs: int, brick, tile: int, k: int,
                *, cull_eps: float = CULL_EPS, operands=None):
    """Logits [res / n_slabs, res, res] of x-slab k in natural order, on the
    axes' device: one ``nphm_sdf`` call (K1 for CUDA tensors) over the slab's
    range of the brick order, which holds whole cull tiles, so each point
    is evaluated with the same tile as on the dense grid."""
    per = res**3 // n_slabs
    dev = axes[0].device
    lin = torch.arange(per, dtype=torch.int64, device=dev) + k * per
    pts = _brick_points(axes, lin, res, brick, tile)
    sdf = nphm_sdf(params, cfg, pts, lat, tile=tile, cull_eps=cull_eps, operands=operands)
    return sdf[_unbrick_gather(res, brick, tile, dev, n=per)].reshape(res // n_slabs, res, res)


def extract_mesh_streamed(decoder, params, encoding, mini=(-0.55, -0.5, -0.95),
                          maxi=(0.55, 0.75, 0.4), resolution: int = 256, n_slabs=None,
                          transfer_dtype=None, mc_workers: int = 3,
                          tile: int = DEFAULT_TILE, cull_eps: float = CULL_EPS,
                          device=None) -> TriMesh:
    """Overlapped extraction over x-slabs: the card evaluates slab k while
    slab k-1's logits cross to the host and earlier slabs are marched in
    ``mc_workers`` threads.

    On CUDA every slab's K1 launch is queued up front; each slab's logits
    are cast to ``transfer_dtype`` on the card (e.g. ``np.float16`` halves
    the copy; marching tolerates the rounding), copied into one pinned host
    buffer with ``non_blocking=True``, and a CUDA event recorded behind the
    copy; the host reads slab k only after its event.  Slab k-1 is marched
    with the first plane of slab k as a window of the global lattice, so
    cells on a seam are triangulated once and the slabs weld exactly on
    global edge keys.  On the CPU the slabs are evaluated one by one.

    Falls back to ``extract_mesh`` (float32, as the JAX package does) for a
    decoder other than NPHM, a resolution with no brick, or a single slab.
    """
    dev = _device(device)
    params = tree_to(params, dev)
    res = int(resolution)
    tile, brick = grid_tile(res, tile)
    n_slabs = 1 if brick is None else _pick_n_slabs(res, brick[0], n_slabs or 8)
    if decoder.kind != "nphm" or n_slabs <= 1:
        return extract_mesh(decoder, params, encoding, mini, maxi, res, device=dev)

    lat = _as_lat(encoding, dev)[0]
    h = res // n_slabs
    axes = grid_axes(mini, maxi, res, dev)
    tdt = None if transfer_dtype is None else torch_dtype(transfer_dtype)
    with torch.no_grad():
        operands = prepare_ensemble_operands(params, decoder.cfg, lat)

    def logits(k):
        out = slab_logits(params, decoder.cfg, lat, axes, res, n_slabs, brick, tile, k,
                          cull_eps=cull_eps, operands=operands)
        return out if tdt is None else out.to(tdt)

    if dev.type == "cuda":
        host = torch.empty((n_slabs, h, res, res), dtype=tdt or torch.float32,
                           pin_memory=True)
        events = []
        for k in range(n_slabs):
            host[k].copy_(logits(k), non_blocking=True)
            events.append(torch.cuda.Event())
            events[k].record(torch.cuda.current_stream(dev))

        def fetch(k):
            events[k].synchronize()
            return host[k].numpy()
    else:
        def fetch(k):
            return logits(k).numpy()

    def mc_slab(k: int, grid: np.ndarray):
        # global cell coordinates and edge keys: interpolation rounds as in
        # the dense pass, and the slab meshes weld on keys
        return marching_tets_window(-grid.astype(np.float32), (k * h, 0, 0),
                                    (res, res, res), 0.0)

    slabs: list = [None] * n_slabs
    jobs = []
    with cf.ThreadPoolExecutor(max_workers=mc_workers) as ex:
        for k in range(n_slabs):
            slabs[k] = fetch(k)
            if k > 0:
                # slab k-1 + the first plane of slab k: cells on the boundary
                # layer are triangulated by slab k-1 only
                grid = np.concatenate([slabs[k - 1], slabs[k][:1]], axis=0)
                jobs.append(ex.submit(mc_slab, k - 1, grid))
        jobs.append(ex.submit(mc_slab, n_slabs - 1, slabs[n_slabs - 1]))
        parts = [j.result() for j in jobs]

    # weld the seams on global edge keys (a duplicate key carries a
    # bit-identical position, so the first occurrence is exact)
    all_faces = []
    offset = 0
    for verts, _, faces in parts:
        all_faces.append(faces.astype(np.int64) + offset)
        offset += len(verts)
    verts = np.concatenate([v for v, _, _ in parts], axis=0)
    keys = np.concatenate([k_ for _, k_, _ in parts], axis=0)
    faces = np.concatenate(all_faces, axis=0)
    _, first, inverse = np.unique(keys, return_index=True, return_inverse=True)
    faces = inverse.reshape(-1)[faces]
    step = (np.asarray(maxi, np.float32) - np.asarray(mini, np.float32)) / (res - 1)
    uniq = verts[first] * step[None, :] + np.asarray(mini, np.float32)[None, :]
    return TriMesh(uniq.astype(np.float32), faces)


@torch.no_grad()
def _deltas(deformer, params, verts, lats, anchors, chunk_size):
    """Deformation offsets [E, M, 3] of vertices [M, 3] under lats [E, 1, L]
    and anchors [1, K, 3] or None: K7 for CUDA tensors (it chunks the points
    itself), the decoder's plain ``apply`` in chunks otherwise and for an
    ``interpolate`` field (``per_point_conditioning``)."""
    out = torch.empty((lats.shape[0],) + verts.shape, device=verts.device)
    if verts.is_cuda and not per_point_conditioning(deformer):
        for e in range(lats.shape[0]):
            out[e] = eval_offsets(deformer, params, verts, lats[e, 0], anchors)
        return out
    for e in range(lats.shape[0]):
        for s in range(0, verts.shape[0], chunk_size):
            delta, _ = deformer.apply(params, verts[None, s : s + chunk_size],
                                      lats[e], anchors)
            out[e, s : s + chunk_size] = delta[0]
    return out


def deform_mesh_batch(mesh: TriMesh, deformer, params, lat_exprs, anchors=None,
                      lat_shape=None, chunk_size: int = DEFAULT_CHUNK,
                      device=None) -> list:
    """Forward-warp mesh vertices through the deformation field for each of
    E expression latents (identity latent prepended when given).  The
    parameters move to ``device`` first (default ``default_device()``).
    ``chunk_size`` is the plain path's chunk of vertices (CPU); K7 sizes
    its own chunks."""
    dev = default_device() if device is None else torch.device(device)
    params = tree_to(params, dev)
    lats = torch.stack([_as_lat(le, dev) for le in lat_exprs])  # [E, 1, L]
    if lat_shape is not None:
        ls = _as_lat(lat_shape, dev)
        lats = torch.cat([ls.expand(lats.shape[0], 1, -1), lats], dim=-1)
    anc = None if anchors is None else torch.tensor(
        np.asarray(anchors, np.float32), device=dev
    ).reshape(1, -1, 3)
    verts = torch.tensor(np.asarray(mesh.vertices, np.float32), device=dev)
    deltas = _deltas(deformer, params, verts, lats, anc, chunk_size).cpu().numpy()
    return [TriMesh(mesh.vertices + d, mesh.faces.copy()) for d in deltas]


def deform_mesh(mesh: TriMesh, deformer, params, lat_expr, anchors=None,
                lat_shape=None, chunk_size: int = DEFAULT_CHUNK,
                device=None) -> TriMesh:
    """Forward-warp mesh vertices through the deformation field."""
    return deform_mesh_batch(mesh, deformer, params, [lat_expr], anchors, lat_shape,
                             chunk_size, device)[0]
