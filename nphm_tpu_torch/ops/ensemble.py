"""Eval-mode NPHM ensemble SDF: kernel K1 (``csrc/ensemble_sdf.cu``) and its
plain PyTorch version (counterpart of ``nphm_tpu/ops/pallas_ensemble.py``).

Every query point goes through the 39 anchored member MLPs and the member
SDFs are blended with a Gaussian kernel on point-to-anchor distance; the
background member is pinned to SDF 1 (its weight is the blend's initial
value).  Outside the kernel, in torch, as the JAX package does it:

- ``prepare_ensemble_operands`` folds the latent conditioning into
  per-member biases, expands the symmetric weight sharing and folds the
  x-mirror into the sign of the point-facing weight columns;
- ``cull_mask`` marks, per (cull tile, member), whether the member's anchor
  is within ``sqrt(ln(1/eps) * var)`` of the tile's bounding box; a culled
  member contributes nothing to that tile;
- ``nphm_grid_sdf`` generates dense-grid points in spatially compact bricks
  (so culling fires) and gathers the logits back to natural order.

K1 walks, for each 64-point block, the live members of its cull tile from
a compacted work list (``work_list``: the live (tile, member) pairs,
tile-major, members ascending) and blends them in that fixed order; its
member MLPs run on the tensor cores as 3xTF32 (``ops/tf32.py``) over
K-major weights.  ``nphm_sdf_work_list_plain`` is that schedule in plain
PyTorch.

``nphm_sdf`` launches K1 for a CUDA tensor and runs ``nphm_sdf_plain`` for
a CPU tensor; ``nphm_sdf.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from nphm_tpu_torch.models.ensemble import NPHMConfig, _split_cond, predict_anchors
from nphm_tpu_torch.models.mlp import softplus_beta
from nphm_tpu_torch.ops import _build
from nphm_tpu_torch.ops.fit_fields import check_widths
from nphm_tpu_torch.parallel.mesh import data_parallel, gather_rows, shard_rows

DEFAULT_TILE = 2048  # cull-tile size: points sharing one member predicate
CULL_EPS = 1e-10
PLAIN_CHUNK_CPU = 1 << 16  # points of one member's CPU pass in nphm_sdf_plain
SQRT2 = 1.4142135623730951
POINTS = 64  # points per K1 block: csrc/tc_tile.cuh kRows


def prepare_ensemble_operands(params, cfg: NPHMConfig, lat):
    """Per-member operands for the 39 anchored members, conditioning folded.

    lat: [lat_dim] or [1, lat_dim].  Returns (layers, anchors [K, 3]) where
    layers[i] is a dict: layer 0 {"wp" [K,H,3], "b" [K,H]}; hidden layers
    {"w" [K,out,in], "b" [K,out]}; the skip layer additionally {"wp"
    [K,out,3]} with 1/sqrt(2) folded in; the last layer {"w" [K,out,in],
    "b" [K,out]}.
    """
    lat = lat.reshape(1, cfg.lat_dim)
    shapes, skip_in = cfg.layer_shapes
    K, ds = cfg.n_loc, cfg.input_dim
    anchors = predict_anchors(params, cfg, lat)[0]
    cond = _split_cond(cfg, lat)[0][:K]  # [K, G+L]
    idx = torch.as_tensor(cfg.member_map[:K], device=lat.device)
    sign = torch.as_tensor(cfg.mirror_sign[:K], device=lat.device)
    col = torch.cat([sign[:, None], torch.ones((K, ds - 1), device=lat.device)], 1)

    layers = []
    for i in range(len(shapes)):
        w = params["ensemble"][i]["w"][idx]  # [K, out, in]
        b = params["ensemble"][i]["b"][idx]
        if i == 0:
            layers.append({
                "wp": w[:, :, :ds] * col[:, None, :],
                "b": torch.einsum("kc,koc->ko", cond, w[:, :, ds:]) + b,
            })
        elif i == skip_in:
            h = w.shape[2] - cfg.d_in
            layers.append({
                "w": w[:, :, :h] / SQRT2,
                "wp": w[:, :, h : h + ds] * col[:, None, :] / SQRT2,
                "b": torch.einsum("kc,koc->ko", cond, w[:, :, h + ds :]) / SQRT2 + b,
            })
        else:
            layers.append({"w": w, "b": b})
    return layers, anchors


def cull_mask(points, centers, var: float, tile: int, cull_eps: float):
    """int32 [n_tiles, K]: 1 where member k may touch a point of the tile.

    points: [n_tiles * tile, 3]; centers: [K, 3].  The box-to-anchor
    distance lower-bounds every point-to-anchor distance, so this is a
    conservative superset of the exact per-point cull.
    """
    n_t = points.shape[0] // tile
    if cull_eps <= 0:
        return torch.ones((n_t, centers.shape[0]), dtype=torch.int32,
                          device=points.device)
    r2 = float(np.log(1.0 / cull_eps) * var)
    pts = points.reshape(n_t, tile, 3)
    lo = pts.amin(dim=1)[:, None, :]
    hi = pts.amax(dim=1)[:, None, :]
    clipped = torch.maximum(torch.minimum(centers[None], hi), lo)
    d2 = torch.sum((centers[None] - clipped) ** 2, dim=-1)
    return (d2 < r2).to(torch.int32)


def _pad_points(xyz, tile):
    """Pad [N, 3] to a tile multiple with the last point (never un-culls)."""
    pad = (-xyz.shape[0]) % tile
    if pad:
        xyz = torch.cat([xyz, xyz[-1:].expand(pad, 3)], dim=0)
    return xyz.contiguous()


def _prepare(params, cfg, xyz, lat, tile, cull_eps, operands=None):
    xyz = _pad_points(xyz.to(torch.float32), tile)
    layers, anchors = (prepare_ensemble_operands(params, cfg, lat) if operands is None
                       else operands)
    active = cull_mask(xyz, anchors, cfg.blend_var, tile, cull_eps)
    return xyz, layers, anchors, active


def _blend_weight(raw, inv_var):
    dd = torch.sqrt(torch.sum(raw * raw, dim=-1) + 1e-20)
    return torch.exp(-((dd + 1e-5) ** 2) * inv_var)


@torch.no_grad()
def nphm_sdf_plain(params, cfg: NPHMConfig, xyz, lat, *, tile: int = DEFAULT_TILE,
                   cull_eps: float = CULL_EPS, operands=None):
    """Plain PyTorch version of K1: same folding, cull mask, pad and order.

    On the card every member runs on every point and a dead one adds 0.0.
    On the CPU a member runs, as in K1, only on the cull tiles where it is
    live, in chunks of ``PLAIN_CHUNK_CPU`` points whose activations stay in
    cache; the sums are the same bit for bit.
    """
    n = xyz.shape[0]
    xyz, layers, anchors, active = _prepare(params, cfg, xyz, lat, tile, cull_eps, operands)
    _shapes, skip_in = cfg.layer_shapes
    L = len(layers)
    inv_var = 1.0 / cfg.blend_var
    bg_w = float(np.exp(cfg.blend_background_dist / cfg.blend_var))
    dev = xyz.device

    def member(k, raw):
        h = None
        for i in range(L):
            lay = layers[i]
            if i == 0:
                z = raw @ lay["wp"][k].T + lay["b"][k]
            elif i == skip_in:
                z = h @ lay["w"][k].T + raw @ lay["wp"][k].T + lay["b"][k]
            else:
                z = h @ lay["w"][k].T + lay["b"][k]
            if i < L - 1:
                h = softplus_beta(z, cfg.beta)
        return z[:, 0], _blend_weight(raw, inv_var)

    num = torch.full((xyz.shape[0],), bg_w, device=dev)
    den = torch.full((xyz.shape[0],), bg_w, device=dev)
    if dev.type != "cpu":
        live = active.repeat_interleave(tile, dim=0).bool()  # [Np, K]
        for k in range(cfg.n_loc):
            z, w = member(k, xyz - anchors[k])
            num = num + torch.where(live[:, k], w * z, 0.0)
            den = den + torch.where(live[:, k], w, 0.0)
        return (num / (den + 1e-6))[:n]
    live = active.bool().numpy()  # [n_tiles, K]
    chunk = max(1, PLAIN_CHUNK_CPU // tile)
    offs = torch.arange(tile)
    for k in range(cfg.n_loc):
        tiles = np.flatnonzero(live[:, k])
        for c in range(0, len(tiles), chunk):
            rows = (torch.as_tensor(tiles[c : c + chunk])[:, None] * tile + offs).reshape(-1)
            z, w = member(k, xyz[rows] - anchors[k])
            num[rows] += w * z
            den[rows] += w
    return (num / (den + 1e-6))[:n]


def _work_list_padded(active):
    """``work_list`` without a host sync: the same offsets, and the members
    in a buffer of n_tiles * K + 1 entries whose first n_live are
    ``work_list``'s (K1 reads no entry past them).  Each live pair goes to
    its rank among the live pairs, tile-major; the rest to the last slot."""
    n_t, K = active.shape
    flat = active.reshape(-1).to(torch.int64)
    rank = torch.cumsum(flat, 0) - 1
    dump = n_t * K
    members = torch.zeros(dump + 1, dtype=torch.int32, device=active.device)
    ids = torch.arange(K, dtype=torch.int32, device=active.device).repeat(n_t)
    members.scatter_(0, torch.where(flat > 0, rank, dump), ids)
    offsets = torch.zeros(n_t + 1, dtype=torch.int64, device=active.device)
    offsets[1:] = torch.cumsum(flat.reshape(n_t, K).sum(dim=1), 0)
    return offsets.to(torch.int32), members


def work_list(active):
    """K1's compacted schedule of a cull mask [n_tiles, K]: (offsets int32
    [n_tiles + 1], members int32 [n_live]); tile t's live members, in
    ascending order, are members[offsets[t]:offsets[t + 1]]."""
    offsets, members = _work_list_padded(active)
    return offsets, members[: int(offsets[-1])].contiguous()


@torch.no_grad()
def nphm_sdf_work_list_plain(params, cfg: NPHMConfig, xyz, lat, *, tile: int = DEFAULT_TILE,
                             cull_eps: float = CULL_EPS):
    """K1's schedule in plain PyTorch: each live (tile, member) pair of
    ``work_list`` runs the member's MLP over the tile's points, and every
    tile blends its live members in the list's order, starting from the
    background member's pinned term."""
    n = xyz.shape[0]
    xyz, layers, anchors, active = _prepare(params, cfg, xyz, lat, tile, cull_eps)
    _shapes, skip_in = cfg.layer_shapes
    L = len(layers)
    inv_var = 1.0 / cfg.blend_var
    bg_w = float(np.exp(cfg.blend_background_dist / cfg.blend_var))
    offsets, members = work_list(active)
    counts = (offsets[1:] - offsets[:-1]).long()
    pair_tile = torch.repeat_interleave(torch.arange(active.shape[0], device=xyz.device),
                                        counts)
    m = members.long()
    raw = xyz.reshape(-1, tile, 3)[pair_tile] - anchors[m][:, None, :]  # [P, tile, 3]
    h = None
    for i, lay in enumerate(layers):
        if i == 0:
            z = raw @ lay["wp"][m].transpose(1, 2) + lay["b"][m][:, None, :]
        elif i == skip_in:
            z = (h @ lay["w"][m].transpose(1, 2) + raw @ lay["wp"][m].transpose(1, 2)
                 + lay["b"][m][:, None, :])
        else:
            z = h @ lay["w"][m].transpose(1, 2) + lay["b"][m][:, None, :]
        if i < L - 1:
            h = softplus_beta(z, cfg.beta)
    wz = _blend_weight(raw, inv_var) * z[..., 0]  # [P, tile]
    w = _blend_weight(raw, inv_var)
    num = torch.full((active.shape[0], tile), bg_w, device=xyz.device)
    den = torch.full((active.shape[0], tile), bg_w, device=xyz.device)
    for r in range(int(counts.max()) if counts.numel() else 0):
        tiles = torch.nonzero(counts > r)[:, 0]  # the tiles with an r-th live member
        pair = offsets[tiles].long() + r
        num[tiles] = num[tiles] + wz[pair]
        den[tiles] = den[tiles] + w[pair]
    return (num / (den + 1e-6)).reshape(-1)[:n]


def _ensemble_trunk(layers, cfg: NPHMConfig):
    """Kernel-layout tensors and the ``Trunk`` descriptor for K1: hidden
    layers K-major (``wt`` [K, out, ldwt], ldwt = in rounded up to the
    MMA's K step of 8, zero columns past it), the head [K, in]."""
    _shapes, skip_in = cfg.layer_shapes
    L = len(layers)
    keep = []
    specs = []
    wp_skip = None
    for i, lay in enumerate(layers):
        b = lay["b"].contiguous()
        K, n_out = b.shape
        if i == 0:
            w = lay["wp"].contiguous()
            spec = dict(n_in=3, n_out=n_out, w=w, ldw=3, w_ms=n_out * 3)
        elif i == L - 1:
            if n_out != 1:
                raise ValueError("K1 blends a single SDF channel")
            w = lay["w"][:, 0, :].contiguous()  # [K, in]
            spec = dict(n_in=w.shape[1], n_out=1, w=w, ldw=1, w_ms=w.shape[1])
        else:
            n_in = lay["w"].shape[2]
            ldwt = _build.round_up(n_in, 8)
            w = _build.padded(lay["w"], ldwt)  # [K, out, ldwt]
            spec = dict(n_in=n_in, n_out=n_out, w=w, ldw=ldwt, w_ms=n_out * ldwt, wt=w,
                        ldwt=ldwt, wt_ms=n_out * ldwt)
            if i == skip_in:
                wp_skip = lay["wp"].contiguous()
        spec.update(b=b, b_ms=n_out, b_rs=0)
        specs.append(spec)
        keep += [w, b]
    tr = _build.make_trunk(
        n_layers=L, skip=skip_in, row_len=1, beta=cfg.beta, layers=specs,
        wp=wp_skip, wp_ms=wp_skip.shape[1] * 3,
    )
    keep.append(wp_skip)
    return tr, keep


def _launch_ensemble(cfg, xyz, layers, anchors, active, tile):
    lib = _build.lib()
    if lib.nphm_ensemble_points_per_block() != POINTS:
        raise RuntimeError("K1's block size disagrees with ops.ensemble.POINTS")
    if tile % POINTS:
        raise ValueError(f"tile must be a multiple of {POINTS}")
    check_widths(layers)
    tr, keep = _ensemble_trunk(layers, cfg)
    centers = anchors.contiguous()
    _build.require_cuda_f32(xyz, centers, *keep)
    _build.require_mask(active, (xyz.shape[0] // tile, cfg.n_loc), xyz.device)
    offsets, members = _work_list_padded(active)  # no host sync: launches queue up
    out = torch.empty(xyz.shape[0], device=xyz.device, dtype=torch.float32)
    rc = lib.nphm_ensemble_sdf(
        ctypes.byref(tr), xyz.data_ptr(), centers.data_ptr(), offsets.data_ptr(),
        members.data_ptr(), out.data_ptr(), xyz.shape[0], cfg.n_loc, tile,
        1.0 / cfg.blend_var, float(np.exp(cfg.blend_background_dist / cfg.blend_var)),
        _build.stream_ptr(xyz.device),
    )
    _build.check(rc, "nphm_ensemble_sdf")
    nphm_sdf.launches += 1
    return out


@torch.no_grad()
def nphm_sdf(params, cfg: NPHMConfig, xyz, lat, *, tile: int = DEFAULT_TILE,
             cull_eps: float = CULL_EPS, operands=None):
    """Eval-mode NPHM SDF at xyz [N, 3] for one latent -> sdf [N].

    Matches ``apply_nphm(..., training=False)`` up to summation order plus a
    blend-weight truncation bounded by ``n_loc * cull_eps``
    (``cull_eps=0`` disables culling).  ``operands``: the latent's
    ``prepare_ensemble_operands``, when the caller evaluates one latent
    over several point sets (their host-to-device constants synchronise
    the stream, so a pipeline prepares them once, before its launches).
    """
    if not xyz.is_cuda:
        return nphm_sdf_plain(params, cfg, xyz, lat, tile=tile, cull_eps=cull_eps,
                              operands=operands)
    n = xyz.shape[0]
    xyz, layers, anchors, active = _prepare(params, cfg, xyz, lat, tile, cull_eps, operands)
    return _launch_ensemble(cfg, xyz, layers, anchors, active, tile)[:n]


nphm_sdf.launches = 0


# ---------------------------------------------------------------------------
# Brick-ordered dense-grid evaluation
# ---------------------------------------------------------------------------


def _brick_shape(res: int, tile: int):
    """A (bx, by, bz) brick with bx*by*bz == tile that divides res^3, or None."""
    best = None
    b = 2
    while b * b * b <= tile:
        if tile % (b * b) == 0:
            bz = tile // (b * b)
            if res % b == 0 and res % bz == 0 and bz <= res:
                best = (b, b, bz)
        b *= 2
    return best


def _brick_points(axes, lin, res: int, brick, tile: int):
    """Grid coordinates of brick-order linear indices ``lin``."""
    if brick is None:
        ix = lin // (res * res)
        iy = (lin // res) % res
        iz = lin % res
    else:
        bx, by, bz = brick
        nby, nbz = res // by, res // bz
        b, i = lin // tile, lin % tile
        ix = (b // (nby * nbz)) * bx + i // (by * bz)
        iy = ((b // nbz) % nby) * by + (i // bz) % by
        iz = (b % nbz) * bz + i % bz
    return torch.stack([axes[0][ix], axes[1][iy], axes[2][iz]], dim=-1)


def _unbrick_gather(res: int, brick, tile: int, device, n=None):
    """Natural (x-major) index -> brick-order position, as a gather map of
    the first ``n`` (default res^3) natural indices.  A brick's x extent
    divides a slab of whole brick rows, so the map of a slab's first
    ``n`` indices is also every such slab's map into its own range."""
    lin = torch.arange(res**3 if n is None else n, dtype=torch.int64, device=device)
    if brick is None:
        return lin
    bx, by, bz = brick
    nby, nbz = res // by, res // bz
    jx = lin // (res * res)
    jy = (lin // res) % res
    jz = lin % res
    return (
        ((jx // bx) * nby * nbz + (jy // by) * nbz + jz // bz) * tile
        + (jx % bx) * (by * bz)
        + (jy % by) * bz
        + (jz % bz)
    )


def grid_tile(res: int, tile: int = DEFAULT_TILE):
    """(tile, brick) ``nphm_grid_sdf`` uses at this resolution.

    Brick compactness (member culling) is worth more than a larger tile: a
    resolution without a brick at ``tile`` falls back to a 1024-point brick.
    """
    brick = _brick_shape(res, tile)
    if brick is None and tile > 1024:
        smaller = _brick_shape(res, 1024)
        if smaller is not None:
            return 1024, smaller
    return tile, brick


def grid_axes(mini, maxi, res: int, device):
    """The lattice's three axes.  Every extraction path (dense, slab,
    sparse, backward warp) builds them with this call on the evaluation
    device, so equal indices give bit-equal points."""
    return [torch.linspace(float(mini[i]), float(maxi[i]), res, dtype=torch.float32,
                           device=device) for i in range(3)]


@torch.no_grad()
def nphm_grid_sdf(params, cfg: NPHMConfig, lat, mini, maxi, res: int, *,
                  tile: int = DEFAULT_TILE, cull_eps: float = CULL_EPS,
                  sdf_fn=nphm_sdf, device_mesh=None):
    """Dense-grid SDF [res^3] in natural (x-major, z fastest) order.

    Points are generated on the latent's device in brick order so every
    cull tile is a compact brick; ``sdf_fn`` (``nphm_sdf`` or
    ``nphm_sdf_plain``) evaluates them.  With a ``device_mesh`` (the JAX
    package's ``device_mesh=``) each rank evaluates its block of whole
    tiles of the brick order, one K1 launch, and every rank returns the
    gathered grid.
    """
    device = lat.device
    tile, brick = grid_tile(res, tile)
    axes = grid_axes(mini, maxi, res, device)
    n = res * res * res
    own = shard_rows(n, device_mesh, granule=tile)
    lin = torch.arange(own.start, own.stop, dtype=torch.int64, device=device)
    pts = _brick_points(axes, lin, res, brick, tile)
    sdf = sdf_fn(params, cfg, pts, lat, tile=tile, cull_eps=cull_eps)
    if data_parallel(device_mesh) is not None:
        sdf = gather_rows(sdf, n, device_mesh, granule=tile)
    return sdf[_unbrick_gather(res, brick, tile, device)]
