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
tensor cores over the K-major weights below, staged in K slices through
shared memory (``csrc/field_tile.cuh``), at ``precision.current()``: in
3xTF32 (``ops/tf32.py``) at F32, in one pass on TF32-rounded operands at
TF32, in bf16 tensor-core MMAs at BF16.  K4 runs at its
forward's precision, over its forward's trunk.  Each kernel's route at each
precision is in ``ROUTES``: at BF16 the hidden weights are bf16, rounded
once per call (``route_weights``), and every product step is one bf16
MMA, K4's reverse sweep included.

Symmetric sharing and the mirror sign are expanded outside (torch autograd
maps the bias and coordinate cotangents back to the latent), and so are the
last layer's bias and the Gaussian blend.  Points are Morton-sorted per row
so tiles are compact, and a (member, tile) pair whose anchor is outside the
cull radius of the tile's bounding box contributes 0 (the background member
is never culled).

``member_f`` runs K3/K4 through a ``torch.autograd.Function`` for CUDA
tensors and ``member_f_plain`` (differentiated by autograd) for CPU
tensors; ``member_f.launches`` and ``member_f.bwd_launches`` count kernel
launches, ``member_f.launches_at`` and ``member_f.bwd_launches_at`` the
launches of each precision's instantiation.
"""

from __future__ import annotations

import ctypes
import enum

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
from nphm_tpu_torch.ops import _build, precision
from nphm_tpu_torch.ops.precision import Precision

SQRT2 = 1.4142135623730951
DEFAULT_TILE = 512  # cull-tile size (points sharing one member predicate)
K_STEP = 8  # the MMA's K step: weight rows are padded to a multiple of it
MAX_WIDTH = 256  # csrc/tc_tile.cuh kMaxN: the widest product of K3-K6
FIT_LANES = 64  # points per K3/K4 block: csrc/tc_tile.cuh kRows
CULL_EPS_TRAIN = 0.0


class Route(enum.IntEnum):
    """How a kernel instantiation runs its products (``csrc/tc_tile.cuh``
    route codes): operands split or rounded per fragment, or hidden weights
    the host rounds once per call (``route_weights``)."""

    F32 = 0  # 3xTF32
    TF32 = 1  # one TF32 pass, operands rounded per fragment
    BF16_MMA = 4  # bf16 weights in K_PERM order, one m16n8k16 .bf16 MMA a step


# Each kernel's route at each precision: the same for K3-K6, so a backward
# launches over its forward's trunk.
ROUTES = {kernel: {Precision.F32: Route.F32, Precision.TF32: Route.TF32,
                   Precision.BF16: Route.BF16_MMA}
          for kernel in ("fit_fwd", "fit_bwd", "train_fwd", "train_bwd")}
# csrc/tc_tile.cuh kPerm: position s of each group of 16 K indices of a
# BF16_MMA weight row holds K index K_PERM[s] of the group
K_PERM = (0, 4, 1, 5, 2, 6, 3, 7, 8, 12, 9, 13, 10, 14, 11, 15)


def route_k_step(route: Route) -> int:
    """The K padding of a route's weight rows (csrc/tc_tile.cuh k_pad)."""
    return 16 if route == Route.BF16_MMA else K_STEP


def route_weights(w: torch.Tensor, route: Route) -> torch.Tensor:
    """K-major hidden weights [..., K] (K a multiple of ``route_k_step``,
    zero columns past the width) as ``route`` reads them: at BF16_MMA
    rounded to bf16 (nearest even, ``precision.bf16_round``) and stored as
    bf16 with each group of 16 columns in ``K_PERM`` order; else unchanged."""
    if route == Route.BF16_MMA:
        # K_PERM within each half of 8: position 2t + u holds K index 4u + t
        k = w.shape[-1]
        halves = w.to(torch.bfloat16).reshape(*w.shape[:-1], k // 8, 2, 4)
        return halves.transpose(-1, -2).reshape(w.shape).contiguous()
    return w


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
            bias = precision.einsum("bac,aoc->abo", cond, w[:, :, ds:]) + b[:, None, :]
            layers.append({"wp": w[:, :, :ds], "b": bias})
        elif i == skip_in:
            h = w.shape[2] - cfg.d_in
            bias = (
                precision.einsum("bac,aoc->abo", cond, w[:, :, h + ds :]) / SQRT2
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
    Differentiable through torch autograd.  The hidden products, the ones
    the kernels run on the tensor cores, round as K3-K6 do at
    ``precision.current()`` (``precision.einsum``, in every derivative);
    layer 0's and the skip layer's point terms and the head product stay
    fp32, as the kernels' FMA passes compute them.
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
                precision.einsum("abni,aoi->abno", h, lay["w"])
                + torch.einsum("abni,aoi->abno", x, lay["wp"])
                + lay["b"][:, :, None, :]
            )
        else:
            z = precision.einsum("abni,aoi->abno", h, lay["w"]) + lay["b"][:, None, None, :]
        h = softplus_beta(z, cfg.beta)
    f = torch.einsum("abni,aoi->abno", h, layers[-1]["w"])[..., 0].reshape(A, M)
    live = active.T.repeat_interleave(tile, dim=1).bool()  # [A, M]
    return torch.where(live, f, 0.0)


def _fit_trunk(cfg: NPHMConfig, layers, n_rows: int, row_len: int,
               route: Route = Route.F32):
    """Kernel-layout tensors and the ``Trunk`` descriptor for K3/K4 (and
    K5/K6, ``ops/train_fields.py``) at ``route``.

    Hidden layers carry both K-major orientations: ``wt`` [A, out, ldwt]
    for forward products over the inputs, ``w`` [A, in, ldw] for reverse
    products over the outputs, their leading dims rounded to ``K_STEP``
    (16 at BF16_MMA) with zero columns, as ``route_weights`` gives them.
    K3-K6 stage them in K slices and read zeros past the width rounded to
    the K step, so no wider padding is needed."""
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
            ldw = _build.round_up(n_out, route_k_step(route))
            ldwt = _build.round_up(n_in, route_k_step(route))
            w = route_weights(_build.padded(wd.transpose(1, 2), ldw), route)  # [A, in, ldw]
            wt = route_weights(_build.padded(wd, ldwt), route)  # [A, out, ldwt]
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


SMEM_OPTIN = 232_448  # shared memory a block can opt into on Hopper


def smem_bytes(kernel: str, cfg: NPHMConfig, route: Route) -> int:
    """Dynamic shared memory of one block of ``kernel`` ("fit_fwd" K3,
    "fit_bwd" K4, "train_fwd" K5, "train_bwd" K6's two passes,
    "lane_contract" K6's contraction) at ``route`` over ``cfg``'s trunk: a
    host copy of ``csrc/field_tile.cuh::setup`` and
    ``csrc/train_fields.cu::ctr_smem``, for the CPU tests of the sizing.
    The copy has no check of its own here: ``chip_smoke.py``'s phase 14
    requires it to equal the built library's figure for every kernel and
    route, so a change to either C++ function must be made here as well."""
    shapes, skip = cfg.layer_shapes
    outs = [n_out for _, n_out in shapes[:-1]]
    # the hidden products' K (the skip layer's hidden part)
    n_ins = [n_in - (cfg.d_in if i == skip else 0)
             for i, (n_in, _) in enumerate(shapes[:-1]) if i > 0]
    act = [64 * (_build.round_up(w, 8) + 4) for w in outs]
    if kernel == "lane_contract":
        # B side: the hidden inputs' [h | q] rows, fp32; at BF16_MMA the
        # hidden outputs' [zbar | pbar] rows, bf16
        bf16 = route == Route.BF16_MMA
        cmax = max([8] + (outs[1:] if bf16 else n_ins))
        b_floats = _build.round_up(cmax, 8) * 32 // (2 if bf16 else 1)
        stage = (64 * 32 + b_floats + 255) & ~255
        return 4 * 4 * stage + 1024 + 16 * 4
    if kernel == "train_bwd":
        act_floats, point_floats = 3 * max(act), 12 * 64
    elif kernel == "fit_fwd":
        act_floats, point_floats = 2 * max(act), 8 * 64
    else:
        act_floats, point_floats = sum(act), 8 * 64
    nmax = max([8] + outs[1:] + n_ins)
    fixed = 4 * (act_floats + point_floats) + 1024 + 16 * 3
    ks = 16
    while ks > 8 and fixed + 4 * 3 * ((_build.round_up(nmax, 8) * ks + 255) & ~255) > SMEM_OPTIN:
        ks //= 2
    return fixed + 4 * 3 * ((_build.round_up(nmax, 8) * ks + 255) & ~255)


def require_operands(*tensors):
    """``_build.require_cuda_f32`` over a trunk's tensors (BF16_MMA's hidden
    weights are bf16)."""
    _build.require_cuda_f32(*tensors, dtypes=(torch.float32, torch.bfloat16))


class _MemberF(torch.autograd.Function):
    """F = K3(coords); backward K4 -> (d_bias0, d_biasS, d_coords)."""

    @staticmethod
    def forward(ctx, bias0, bias_s, coords, cfg, layers, active, tile, n_rows):
        lib = _build.lib()
        prec = precision.current()
        A, _, M = coords.shape
        row_len = M // n_rows
        route = ROUTES["fit_fwd"][prec]
        tr, keep, _hmax, _hsum = _fit_trunk(cfg, layers, n_rows, row_len, route)
        coords_c = coords.detach().contiguous()
        _build.require_cuda_f32(coords_c)
        require_operands(coords_c, *keep)
        _build.require_mask(active, (M // tile, A), coords.device)
        F = torch.empty((A, M), device=coords.device)
        rc = lib.nphm_fit_fwd(
            ctypes.byref(tr), coords_c.data_ptr(), active.data_ptr(), F.data_ptr(),
            M, A, tile, int(route), _build.stream_ptr(coords.device),
        )
        _build.check(rc, "nphm_fit_fwd")
        member_f.launches += 1
        member_f.launches_at[prec] += 1
        ctx.save_for_backward(coords_c)
        ctx.fit = (tr, keep, active, tile, n_rows, prec)
        return F

    @staticmethod
    def backward(ctx, dF):
        (coords,) = ctx.saved_tensors
        tr, keep, active, tile, n_rows, prec = ctx.fit
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
        _build.require_cuda_f32(dF)
        require_operands(dF, *keep)
        rc = lib.nphm_fit_bwd(
            ctypes.byref(tr), coords.data_ptr(), dF.data_ptr(), active.data_ptr(),
            dcoords.data_ptr(), part0.data_ptr(), part_s.data_ptr(),
            d_bias0.data_ptr(), d_bias_s.data_ptr(), M, A, n_rows, tile,
            int(ROUTES["fit_bwd"][prec]), _build.stream_ptr(dev),
        )
        _build.check(rc, "nphm_fit_bwd")
        member_f.bwd_launches += 1
        member_f.bwd_launches_at[prec] += 1
        return d_bias0, d_bias_s, dcoords, None, None, None, None, None


def check_widths(layers):
    """Raise unless every hidden product fits the tensor-core tile (K3-K6)."""
    if max(max(lay["w"].shape[1:]) for lay in layers[1:-1]) > MAX_WIDTH:
        raise ValueError(f"K3-K6 take hidden layers at most {MAX_WIDTH} wide")


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
member_f.launches_at = precision.counters()
member_f.bwd_launches_at = precision.counters()


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
