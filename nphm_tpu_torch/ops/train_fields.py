"""Training NPHM field: kernels K5/K6 (``csrc/train_fields.cu``) and their
plain PyTorch versions (counterpart of the training half of
``nphm_tpu/ops/pallas_train.py``).

The identity loss reads the blended SDF and its spatial gradient, and its
gradient must flow through both (the eikonal double backprop).  The
differentiation boundary is the per-member field: the raw SDF ``F`` [A, M]
and its coordinate gradient ``G = dF/dcoords`` [A, 3, M] at member-local
coordinates [A, 3, M], with the latent folded into per-(member, row)
biases (``fit_fields.prepare_train_operands``):

- K5 (forward) runs the primal sweep and one reverse sweep seeded by the
  head weights, giving F and G: one block per (member, 64-point tile), its
  products on the tensor cores (K4's body, ``csrc/field_tile.cuh``);
- K6 (backward, the custom VJP) takes the cotangents (dF, dG), recomputes
  the primal, runs the tangent forward seeded by dG and the dual reverse
  sweep with the softplus'' cross terms, and returns d(coords) and the
  gradient of every per-member operand: two passes over 64-point tiles on
  K5's tensor-core parts, then a 3xTF32 tensor-core contraction of the
  per-lane cotangents and inputs over the lanes, split in a fixed order,
  for the hidden weight gradients.

Every tensor-core product runs at ``precision.current()`` (3xTF32 at F32,
one pass on TF32-rounded operands at TF32, bf16 MMAs at BF16); K6 runs at
its forward's precision, over its forward's trunk, and the plain versions
round their hidden products alike (``fit_fields.member_f_plain``).  At
BF16 (``fit_fields.ROUTES``) K5 and K6 read hidden weights rounded to bf16
once per call, their products and K6's lane contraction run bf16 MMAs, and
K6's scratch holds the contraction-only rows [zbar | pbar] in bf16.

Symmetric sharing, mirroring, the head bias and the Gaussian blend stay in
torch, where autograd provides every derivative around the boundary.

``member_fields`` runs K5/K6 through a ``torch.autograd.Function`` for
CUDA tensors and ``member_fields_plain`` (differentiated by autograd with
``create_graph``) for CPU tensors; ``member_fields.launches`` and
``member_fields.bwd_launches`` count kernel launches,
``member_fields.launches_at`` and ``member_fields.bwd_launches_at`` the
launches of each precision's instantiation.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from nphm_tpu_torch.models.ensemble import NPHMConfig, blend_weights, mirror_scale, predict_anchors
from nphm_tpu_torch.ops import _build, precision
from nphm_tpu_torch.ops.fit_fields import (
    CULL_EPS_TRAIN,
    DEFAULT_TILE,
    ROUTES,
    Route,
    _fit_trunk,
    active_mask,
    check_widths,
    member_f_plain,
    morton_codes,
    prepare_train_operands,
    require_operands,
)

# K6's per-lane scratch (activations, tangents and cotangents of every
# hidden layer, ~0.63 GB per member at the production batch) is processed
# in member chunks that fit this budget.
SCRATCH_BYTES = 4 << 30
FWD_LANES = 64  # points per K5 block: csrc/tc_tile.cuh kRows
BWD_LANES = 64  # points per block of K6's two passes: csrc/tc_tile.cuh kRows


def _flat(cfg: NPHMConfig, layers):
    """Layer dicts -> flat operand list: layer 0 (wp, b); skip (w, wp, b);
    other hidden (w, b); head (w)."""
    _, skip_in = cfg.layer_shapes
    L = len(layers)
    out = []
    for i, lay in enumerate(layers):
        if i == 0:
            out += [lay["wp"], lay["b"]]
        elif i == skip_in:
            out += [lay["w"], lay["wp"], lay["b"]]
        elif i == L - 1:
            out += [lay["w"]]
        else:
            out += [lay["w"], lay["b"]]
    return out


def _unflat(cfg: NPHMConfig, flat):
    shapes, skip_in = cfg.layer_shapes
    L = len(shapes)
    it = iter(flat)
    layers = []
    for i in range(L):
        if i == 0:
            layers.append({"wp": next(it), "b": next(it)})
        elif i == skip_in:
            layers.append({"w": next(it), "wp": next(it), "b": next(it)})
        elif i == L - 1:
            layers.append({"w": next(it)})
        else:
            layers.append({"w": next(it), "b": next(it)})
    return layers


def member_fields_plain(cfg: NPHMConfig, layers, coords, active, tile: int, n_rows: int):
    """Plain PyTorch (F [A, M], G [A, 3, M]); culled (tile, member) pairs are 0.

    G is ``dF/dcoords`` taken with ``create_graph``, so autograd
    differentiates both outputs (the double backprop).
    """
    with torch.enable_grad():
        x = coords if coords.requires_grad else coords.detach().requires_grad_(True)
        F = member_f_plain(cfg, layers, x, active, tile, n_rows)
        (G,) = torch.autograd.grad(F.sum(), x, create_graph=True)
    return F, G


class _Grads(ctypes.Structure):
    """Host mirror of ``TrainGrads`` (csrc/train_fields.cu)."""

    _fields_ = [
        ("dw", ctypes.c_void_p * _build.MAX_LAYERS),
        ("db", ctypes.c_void_p * _build.MAX_LAYERS),
        ("dwp0", ctypes.c_void_p),
        ("dwps", ctypes.c_void_p),
        ("dwlast", ctypes.c_void_p),
    ]


class _MemberFields(torch.autograd.Function):
    """(F, G) = K5(coords); backward K6 -> d(every operand), d(coords)."""

    @staticmethod
    def forward(ctx, cfg, active, tile, n_rows, coords, *flat):
        lib = _build.lib()
        prec = precision.current()
        A, _, M = coords.shape
        layers = _unflat(cfg, [t.detach() for t in flat])
        route = ROUTES["train_fwd"][prec]
        tr, keep, _hmax, hsum = _fit_trunk(cfg, layers, n_rows, M // n_rows, route)
        coords_c = coords.detach().contiguous()
        _build.require_cuda_f32(coords_c)
        require_operands(coords_c, *keep)
        _build.require_mask(active, (M // tile, A), coords.device)
        F = torch.empty((A, M), device=coords.device)
        G = torch.empty((A, 3, M), device=coords.device)
        rc = lib.nphm_train_fwd(
            ctypes.byref(tr), coords_c.data_ptr(), active.data_ptr(), F.data_ptr(),
            G.data_ptr(), M, A, tile, int(route), _build.stream_ptr(coords.device),
        )
        _build.check(rc, "nphm_train_fwd")
        member_fields.launches += 1
        member_fields.launches_at[prec] += 1
        ctx.save_for_backward(coords_c)
        ctx.train = (cfg, tr, keep, active, tile, n_rows, hsum,
                     [tuple(t.shape) for t in flat], prec)
        return F, G

    @staticmethod
    @once_differentiable
    def backward(ctx, dF, dG):
        (coords,) = ctx.saved_tensors
        cfg, tr, keep, active, tile, n_rows, hsum, flat_shapes, prec = ctx.train
        lib = _build.lib()
        dev = coords.device
        A, _, M = coords.shape
        L, skip = tr.n_layers, tr.skip
        dF = torch.zeros((A, M), device=dev) if dF is None else dF.float().contiguous()
        dG = torch.zeros((A, 3, M), device=dev) if dG is None else dG.float().contiguous()
        _build.require_cuda_f32(dF, dG)
        require_operands(dF, *keep)

        n_out = [tr.n_out[i] for i in range(L)]
        n_in = [tr.n_in[i] for i in range(L)]
        n_blk = M // BWD_LANES
        split = lib.nphm_train_split_k()
        n_part = hsum + 3 * n_out[0] + 3 * n_out[skip] + n_out[L - 2]
        scr_rows = n_out[L - 2] + sum(n_out[i] + n_in[i] for i in range(1, L - 1))
        widest = max(max(n_out[: L - 1]), 3 * n_out[0], 3 * n_out[skip])
        gmax = max(split * max(n_out[i] * n_in[i] for i in range(1, L - 1)),
                   n_rows * widest)
        per_member = 4 * (scr_rows * 2 * M + n_blk * n_part + gmax)
        chunk = max(1, min(A, SCRATCH_BYTES // per_member))
        part = torch.empty((chunk * n_blk * n_part,), device=dev)
        scr = torch.empty((chunk * scr_rows * 2 * M,), device=dev)
        gsp = torch.empty((chunk * gmax,), device=dev)

        dcoords = torch.empty((A, 3, M), device=dev)
        grads = [torch.empty(s, device=dev) for s in flat_shapes]
        by_layer = _unflat(cfg, grads)
        g = _Grads()
        for i, lay in enumerate(by_layer):
            if i == 0:
                g.dwp0, g.db[0] = lay["wp"].data_ptr(), lay["b"].data_ptr()
            elif i == L - 1:
                g.dwlast = lay["w"].data_ptr()
            else:
                g.dw[i], g.db[i] = lay["w"].data_ptr(), lay["b"].data_ptr()
                if i == skip:
                    g.dwps = lay["wp"].data_ptr()
        stream = _build.stream_ptr(dev)
        for m0 in range(0, A, chunk):
            rc = lib.nphm_train_bwd(
                ctypes.byref(tr), ctypes.byref(g), coords.data_ptr(), dF.data_ptr(),
                dG.data_ptr(), active.data_ptr(), dcoords.data_ptr(), part.data_ptr(),
                scr.data_ptr(), gsp.data_ptr(), M, A, n_rows, tile, hsum, m0,
                min(chunk, A - m0), int(ROUTES["train_bwd"][prec]), stream,
            )
            _build.check(rc, "nphm_train_bwd")
        member_fields.bwd_launches += 1
        member_fields.bwd_launches_at[prec] += 1
        return (None, None, None, None, dcoords, *grads)


def member_fields(cfg: NPHMConfig, layers, coords, active, tile: int, n_rows: int):
    """(F [A, M], G [A, 3, M]) per-member raw SDF and its coordinate
    gradient, differentiable twice (K5/K6 on CUDA tensors)."""
    if not coords.is_cuda:
        return member_fields_plain(cfg, layers, coords, active, tile, n_rows)
    if tile % FWD_LANES or tile % BWD_LANES:
        raise ValueError(f"tile must be a multiple of K5's {FWD_LANES} and K6's {BWD_LANES} "
                         "points a block")
    check_widths(layers)
    lib = _build.lib()
    if (lib.nphm_train_fwd_lanes_per_block(), lib.nphm_train_lanes_per_block()) != (
            FWD_LANES, BWD_LANES):
        raise RuntimeError("K5/K6's block sizes disagree with ops.train_fields")
    return _MemberFields.apply(cfg, active.contiguous(), tile, n_rows, coords,
                               *_flat(cfg, layers))


member_fields.launches = 0
member_fields.bwd_launches = 0
member_fields.launches_at = precision.counters()
member_fields.bwd_launches_at = precision.counters()

def scratch_traffic(cfg: NPHMConfig, M: int, prec: precision.Precision) -> int:
    """Bytes K6's scratch moves for one member over M lanes at ``prec``'s
    route: its first pass writes the [h | q] rows of every hidden layer, the
    second reads them and writes the [zbar | pbar] rows of every hidden
    product, the lane contraction reads those and the [h | q] rows again.
    Each row holds 2M values: fp32, or bf16 for [zbar | pbar] at BF16_MMA
    (the only rows that nothing but the contraction reads)."""
    shapes, _ = cfg.layer_shapes
    outs = [n_out for _, n_out in shapes[:-1]]
    hq, zp = sum(outs), sum(outs[1:])
    zp_bytes = 2 if ROUTES["train_bwd"][prec] == Route.BF16_MMA else 4
    return 2 * M * (4 * 3 * hq + zp_bytes * 2 * zp)


# occupancy's kernels: (entry point, its `which` argument, ROUTES key)
_OCCUPANCY = {"fit_fwd": ("nphm_fit_occupancy", 0, "fit_fwd"),
              "fit_bwd": ("nphm_fit_occupancy", 1, "fit_bwd"),
              "train_fwd": ("nphm_train_occupancy", 0, "train_fwd"),
              "train_bwd_fwd": ("nphm_train_occupancy", 1, "train_bwd"),
              "train_bwd_rev": ("nphm_train_occupancy", 2, "train_bwd"),
              "lane_contract": ("nphm_train_occupancy", 3, "train_bwd")}


def occupancy(kernel: str, cfg: NPHMConfig, layers, n_rows: int, row_len: int,
              prec: precision.Precision) -> dict:
    """Registers and local (stack) bytes a thread, dynamic shared memory and
    resident blocks per SM of ``kernel`` (a key of ``_OCCUPANCY``: K3, K4,
    K5 or one of K6's three product kernels) at its route for ``prec``, as it
    launches over these operands (CUDA tensors)."""
    entry, which, key = _OCCUPANCY[kernel]
    route = ROUTES[key][prec]
    tr, _keep, _hmax, _hsum = _fit_trunk(cfg, layers, n_rows, row_len, route)
    out = (ctypes.c_int * 4)()
    rc = getattr(_build.lib(), entry)(ctypes.byref(tr), cfg.n_members, which, int(route), out)
    _build.check(rc, entry)
    return {"route": route.name, "registers": out[0], "local_bytes": out[1],
            "smem_bytes": out[2], "blocks_per_sm": out[3]}


def apply_nphm_train(params, cfg: NPHMConfig, xyz, lat, *, tile: int = DEFAULT_TILE,
                     cull_eps: float = CULL_EPS_TRAIN, sort: bool | None = None,
                     member_fn=member_fields):
    """Training-mode NPHM field: (sdf [B, N, 1], grads [B, N, 3], anchors).

    Counterpart of ``apply_nphm_train_pallas``: differentiable w.r.t.
    params, lat and xyz, including through the spatial gradient.  sort:
    Morton-order points per row so member culling fires (None = only when
    cull_eps > 0).
    """
    if sort is None:
        sort = cull_eps > 0
    B, N, _ = xyz.shape
    A = cfg.n_members
    anchors = predict_anchors(params, cfg, lat)

    if sort:
        perm = torch.argsort(morton_codes(xyz.detach()), dim=1, stable=True)
        xyz_s = torch.gather(xyz, 1, perm[..., None].expand(B, N, 3))
    else:
        perm = None
        xyz_s = xyz

    Np = -(-N // tile) * tile
    if Np != N:
        xyz_s = torch.cat([xyz_s, xyz_s[:, -1:].expand(B, Np - N, 3)], dim=1)

    sign = mirror_scale(cfg, xyz.device)  # [A, 3]
    centers = torch.cat([anchors, torch.zeros_like(anchors[:, :1, :])], dim=1)
    coords = (xyz_s[:, :, None, :] - centers[:, None, :, :]) * sign
    coords_t = coords.permute(2, 3, 0, 1).reshape(A, 3, B * Np)

    layers, last_b = prepare_train_operands(params, cfg, lat)
    active = active_mask(cfg, coords_t, tile, cull_eps)
    F, G = member_fn(cfg, layers, coords_t, active, tile, B)

    Fm = F.reshape(A, B, Np).permute(1, 2, 0) + last_b[:, 0]  # [B, Np, A]
    Gm = G.reshape(A, 3, B, Np).permute(2, 3, 0, 1) * sign  # [B, Np, A, 3]
    wn = blend_weights(xyz_s, anchors, cfg.blend_var, cfg.blend_background_dist)
    sdf = torch.sum(wn * Fm, dim=-1)
    # spatial gradient: blend-weight part (autograd w.r.t. the points with
    # F held fixed, Fm not detached) + member-field part (G)
    with torch.enable_grad():
        q = xyz_s.clone() if xyz_s.requires_grad else xyz_s.detach().requires_grad_(True)
        wsum = torch.sum(
            blend_weights(q, anchors, cfg.blend_var, cfg.blend_background_dist) * Fm
        )
        (g_wpart,) = torch.autograd.grad(wsum, q, create_graph=True)
    grads = g_wpart + torch.einsum("bna,bnac->bnc", wn, Gm)

    sdf = sdf[:, :N]
    grads = grads[:, :N]
    if perm is not None:
        inv = torch.argsort(perm, dim=1)
        sdf = torch.gather(sdf, 1, inv)
        grads = torch.gather(grads, 1, inv[..., None].expand(B, N, 3))
    return sdf[..., None], grads, anchors
