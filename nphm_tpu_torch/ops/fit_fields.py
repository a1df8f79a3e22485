"""Fit-specialised NPHM field: kernels K3/K4 (``csrc/fit_fields.cu``) and their
plain PyTorch version (counterpart of the fit half of
``nphm_tpu/ops/pallas_train.py``).

The joint fit needs only the training-mode SDF at the Broyden roots and its
gradient with respect to the latent and the points; the decoder is frozen.
So the differentiation boundary is the per-member raw SDF ``F`` [A, M] at
member-local coordinates [A, 3, M]:

- K3 computes ``F`` with the latent folded into per-(member, row) biases;
- K4 takes F's cotangent and returns d(coords) and the per-(member, row)
  cotangents of the two folded biases; weight cotangents are ``None``.
Both run one block per (member, 64-point tile), their products on the
tensor cores in 3xTF32 (``ops/tf32.py``) over the K-major weights below,
staged in K slices through shared memory (``csrc/field_tile.cuh``).

Symmetric sharing and the mirror sign are expanded outside (torch autograd
maps the bias and coordinate cotangents back to the latent), and so are the
last layer's bias and the Gaussian blend.  Points are Morton-sorted per row
so tiles are compact, and a (member, tile) pair whose anchor is outside the
cull radius of the tile's bounding box contributes 0 (the background member
is never culled).

``member_f`` runs K3/K4 through a ``torch.autograd.Function`` for CUDA
tensors and ``member_f_plain`` (differentiated by autograd) for CPU
tensors; ``member_f.launches`` and ``member_f.bwd_launches`` count kernel
launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from nphm_tpu_torch.models.ensemble import (
    NPHMConfig,
    _split_cond,
    blend_weights,
    mirror_scale,
    predict_anchors,
)
from nphm_tpu_torch.models.mlp import softplus_beta
from nphm_tpu_torch.ops import _build

SQRT2 = 1.4142135623730951
DEFAULT_TILE = 512  # cull-tile size (points sharing one member predicate)
K_STEP = 8  # the MMA's K step: weight rows are padded to a multiple of it
MAX_WIDTH = 256  # csrc/tc_tile.cuh kMaxN: the widest product of K3-K5
FIT_LANES = 64  # points per K3/K4 block: csrc/tc_tile.cuh kRows
CULL_EPS_TRAIN = 0.0


def prepare_train_operands(params, cfg: NPHMConfig, lat):
    """Per-member operands with conditioning folded per row (differentiable).

    lat: [B, lat_dim].  Returns (layers, last_b [A, out]) with layers[i] a
    dict: layer 0 {"wp" [A,H,3], "b" [A,B,H]}; skip {"w" [A,out,h], "wp"
    [A,out,3], "b" [A,B,out]} (1/sqrt(2) folded in); other hidden layers
    {"w" [A,out,in], "b" [A,out]}; last {"w" [A,out,in]}.
    """
    shapes, skip_in = cfg.layer_shapes
    L = len(shapes)
    ds = cfg.input_dim
    idx = torch.as_tensor(cfg.member_map, device=lat.device)
    cond = _split_cond(cfg, lat)  # [B, A, C]
    layers = []
    last_b = None
    for i in range(L):
        w = params["ensemble"][i]["w"][idx]  # [A, out, in]
        b = params["ensemble"][i]["b"][idx]  # [A, out]
        if i == 0:
            bias = torch.einsum("bac,aoc->abo", cond, w[:, :, ds:]) + b[:, None, :]
            layers.append({"wp": w[:, :, :ds], "b": bias})
        elif i == skip_in:
            h = w.shape[2] - cfg.d_in
            bias = (
                torch.einsum("bac,aoc->abo", cond, w[:, :, h + ds :]) / SQRT2
                + b[:, None, :]
            )
            layers.append({"w": w[:, :, :h] / SQRT2, "wp": w[:, :, h : h + ds] / SQRT2,
                           "b": bias})
        elif i == L - 1:
            layers.append({"w": w})
            last_b = b
        else:
            layers.append({"w": w, "b": b})
    return layers, last_b


def active_mask(cfg: NPHMConfig, coords, tile: int, cull_eps: float):
    """int32 [n_tiles, A] per-(tile, member) liveness from tile bounding boxes.

    coords: [A, 3, M] member-local coordinates, so the distance to a
    member's anchor is |coords|.  The background member is always live.
    """
    A, _, M = coords.shape
    n_t = M // tile
    if cull_eps <= 0:
        return torch.ones((n_t, A), dtype=torch.int32, device=coords.device)
    r2 = float(np.log(1.0 / cull_eps) * cfg.blend_var)
    c = coords.detach().reshape(A, 3, n_t, tile)
    lo = c.amin(dim=3)
    hi = c.amax(dim=3)
    closest = torch.minimum(torch.maximum(torch.zeros_like(lo), lo), hi)
    d2 = torch.sum(closest**2, dim=1)  # [A, n_t]
    active = (d2 < r2).to(torch.int32)
    active[A - 1] = 1
    return active.T.contiguous()


def member_f_plain(cfg: NPHMConfig, layers, coords, active, tile: int, n_rows: int):
    """Plain PyTorch F [A, M] of every member (culled tiles are 0).

    coords: [A, 3, M] with M = n_rows * Np; layers from prepare_train_operands.
    Differentiable through torch autograd.
    """
    _shapes, skip_in = cfg.layer_shapes
    L = len(layers)
    A, _, M = coords.shape
    x = coords.permute(0, 2, 1).reshape(A, n_rows, M // n_rows, 3)
    h = None
    for i in range(L - 1):
        lay = layers[i]
        if i == 0:
            z = torch.einsum("abni,aoi->abno", x, lay["wp"]) + lay["b"][:, :, None, :]
        elif i == skip_in:
            z = (
                torch.einsum("abni,aoi->abno", h, lay["w"])
                + torch.einsum("abni,aoi->abno", x, lay["wp"])
                + lay["b"][:, :, None, :]
            )
        else:
            z = torch.einsum("abni,aoi->abno", h, lay["w"]) + lay["b"][:, None, None, :]
        h = softplus_beta(z, cfg.beta)
    f = torch.einsum("abni,aoi->abno", h, layers[-1]["w"])[..., 0].reshape(A, M)
    live = active.T.repeat_interleave(tile, dim=1).bool()  # [A, M]
    return torch.where(live, f, 0.0)


def _fit_trunk(cfg: NPHMConfig, layers, n_rows: int, row_len: int):
    """Kernel-layout tensors and the ``Trunk`` descriptor for K3/K4 (and
    K5/K6, ``ops/train_fields.py``).

    Hidden layers carry both K-major orientations: ``wt`` [A, out, ldwt]
    for forward products over the inputs, ``w`` [A, in, ldw] for reverse
    products over the outputs, their leading dims rounded to ``K_STEP``
    with zero columns.  K3-K5 stage them in K slices and read zeros past the
    width rounded to ``K_STEP``, so no wider padding is needed."""
    _shapes, skip_in = cfg.layer_shapes
    L = len(layers)
    specs, keep = [], []
    wp_skip = None
    for i, lay in enumerate(layers):
        if i == 0:
            w = lay["wp"].detach().contiguous()
            H = w.shape[1]
            b = lay["b"].detach().contiguous()  # [A, B, H]
            spec = dict(n_in=3, n_out=H, w=w, ldw=3, w_ms=H * 3, b=b,
                        b_ms=n_rows * H, b_rs=H)
        elif i == L - 1:
            if lay["w"].shape[1] != 1:
                raise ValueError("the fit kernels take a single SDF output")
            w = lay["w"].detach()[:, 0, :].contiguous()  # [A, in]
            spec = dict(n_in=w.shape[1], n_out=1, w=w, ldw=1, w_ms=w.shape[1])
        else:
            wd = lay["w"].detach()
            n_out, n_in = wd.shape[1], wd.shape[2]
            ldw = _build.round_up(n_out, K_STEP)
            ldwt = _build.round_up(n_in, K_STEP)
            w = _build.padded(wd.transpose(1, 2), ldw)  # [A, in, ldw]
            wt = _build.padded(wd, ldwt)  # [A, out, ldwt]
            b = lay["b"].detach().contiguous()
            spec = dict(n_in=n_in, n_out=n_out, w=w, ldw=ldw, w_ms=n_in * ldw,
                        wt=wt, ldwt=ldwt, wt_ms=n_out * ldwt, b=b)
            if i == skip_in:
                wp_skip = lay["wp"].detach().contiguous()
                spec.update(b_ms=n_rows * n_out, b_rs=n_out)
            else:
                spec.update(b_ms=n_out, b_rs=0)
            keep.append(wt)
        keep.append(w)
        if spec.get("b") is not None:
            keep.append(spec["b"])
        specs.append(spec)
    tr = _build.make_trunk(
        n_layers=L, skip=skip_in, row_len=row_len, beta=cfg.beta, layers=specs,
        wp=wp_skip, wp_ms=wp_skip.shape[1] * 3,
    )
    keep.append(wp_skip)
    hmax = max(s["n_out"] for s in specs[:-1])
    hsum = sum(s["n_out"] for s in specs[:-1])
    return tr, keep, hmax, hsum


class _MemberF(torch.autograd.Function):
    """F = K3(coords); backward K4 -> (d_bias0, d_biasS, d_coords)."""

    @staticmethod
    def forward(ctx, bias0, bias_s, coords, cfg, layers, active, tile, n_rows):
        lib = _build.lib()
        A, _, M = coords.shape
        row_len = M // n_rows
        tr, keep, _hmax, _hsum = _fit_trunk(cfg, layers, n_rows, row_len)
        coords_c = coords.detach().contiguous()
        _build.require_cuda_f32(coords_c, *keep)
        _build.require_mask(active, (M // tile, A), coords.device)
        F = torch.empty((A, M), device=coords.device)
        rc = lib.nphm_fit_fwd(
            ctypes.byref(tr), coords_c.data_ptr(), active.data_ptr(), F.data_ptr(),
            M, A, tile, _build.stream_ptr(coords.device),
        )
        _build.check(rc, "nphm_fit_fwd")
        member_f.launches += 1
        ctx.save_for_backward(coords_c)
        ctx.fit = (tr, keep, active, tile, n_rows)
        return F

    @staticmethod
    def backward(ctx, dF):
        (coords,) = ctx.saved_tensors
        tr, keep, active, tile, n_rows = ctx.fit
        lib = _build.lib()
        A, _, M = coords.shape
        n_blk = M // FIT_LANES
        H0, HS = tr.n_out[0], tr.n_out[tr.skip]
        dev = coords.device
        dF = dF.to(torch.float32).contiguous()
        dcoords = torch.empty((A, 3, M), device=dev)
        part0 = torch.empty((A, n_blk, H0), device=dev)
        part_s = torch.empty((A, n_blk, HS), device=dev)
        d_bias0 = torch.empty((A, n_rows, H0), device=dev)
        d_bias_s = torch.empty((A, n_rows, HS), device=dev)
        _build.require_cuda_f32(dF, *keep)
        rc = lib.nphm_fit_bwd(
            ctypes.byref(tr), coords.data_ptr(), dF.data_ptr(), active.data_ptr(),
            dcoords.data_ptr(), part0.data_ptr(), part_s.data_ptr(),
            d_bias0.data_ptr(), d_bias_s.data_ptr(), M, A, n_rows, tile,
            _build.stream_ptr(dev),
        )
        _build.check(rc, "nphm_fit_bwd")
        member_f.bwd_launches += 1
        return d_bias0, d_bias_s, dcoords, None, None, None, None, None


def check_widths(layers):
    """Raise unless every hidden product fits the tensor-core tile (K3-K5)."""
    if max(max(lay["w"].shape[1:]) for lay in layers[1:-1]) > MAX_WIDTH:
        raise ValueError(f"K3-K5 take hidden layers at most {MAX_WIDTH} wide")


def member_f(cfg: NPHMConfig, layers, coords, active, tile: int, n_rows: int):
    """F [A, M] per-member raw SDF; first-order gradient w.r.t. the folded
    biases and coords only (valid under frozen decoder weights)."""
    if not coords.is_cuda:
        return member_f_plain(cfg, layers, coords, active, tile, n_rows)
    if tile % FIT_LANES:
        raise ValueError(f"tile must be a multiple of K3/K4's {FIT_LANES} points a block")
    check_widths(layers)
    if _build.lib().nphm_fit_lanes_per_block() != FIT_LANES:
        raise RuntimeError("K3/K4's block size disagrees with ops.fit_fields.FIT_LANES")
    _, skip_in = cfg.layer_shapes
    return _MemberF.apply(layers[0]["b"], layers[skip_in]["b"], coords, cfg,
                          layers, active.contiguous(), tile, n_rows)


member_f.launches = 0
member_f.bwd_launches = 0


def morton_codes(xyz):
    """Per-row 30-bit Morton codes for spatial sorting. xyz: [B, N, 3]."""
    lo = xyz.amin(dim=1, keepdim=True)
    hi = xyz.amax(dim=1, keepdim=True)
    q = torch.clamp((xyz - lo) / (hi - lo + 1e-9) * 1023.0, 0.0, 1023.0)
    q = q.to(torch.int64)

    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return (spread(q[..., 0]) << 2) | (spread(q[..., 1]) << 1) | spread(q[..., 2])


def apply_nphm_fit(params, cfg: NPHMConfig, xyz, lat, *, tile: int = DEFAULT_TILE,
                   cull_eps: float = CULL_EPS_TRAIN, sort: bool | None = None,
                   member_fn=member_f):
    """Fit-specialised NPHM field: sdf only, first-order gradient w.r.t.
    lat and xyz (training-mode semantics; NOT valid for weight gradients).

    xyz: [B, N, 3]; lat: [B, lat_dim].  Returns (sdf [B, N, 1], anchors).
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

    centers = torch.cat([anchors, torch.zeros_like(anchors[:, :1, :])], dim=1)
    coords = (xyz_s[:, :, None, :] - centers[:, None, :, :]) * mirror_scale(
        cfg, xyz.device
    )
    coords_t = coords.permute(2, 3, 0, 1).reshape(A, 3, B * Np)

    layers, last_b = prepare_train_operands(params, cfg, lat)
    active = active_mask(cfg, coords_t, tile, cull_eps)
    F = member_fn(cfg, layers, coords_t, active, tile, B)
    Fm = F.reshape(A, B, Np).permute(1, 2, 0) + last_b[:, 0]
    wn = blend_weights(xyz_s, anchors, cfg.blend_var, cfg.blend_background_dist)
    sdf = torch.sum(wn * Fm, dim=-1)[:, :N]
    if perm is not None:
        sdf = torch.gather(sdf, 1, torch.argsort(perm, dim=1))
    return sdf[..., None], anchors
