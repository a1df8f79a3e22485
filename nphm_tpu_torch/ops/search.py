"""Fused Broyden correspondence search: kernel K2 (``csrc/broyden_search.cu``)
and its plain PyTorch version (counterpart of ``nphm_tpu/ops/pallas_search.py``).

The whole warm search (residual init plus every good-Broyden iteration up to
a runtime budget) runs per (obs, point) lane through the deformation trunk,
whose row-constant conditioning is folded into per-obs biases outside the
kernel.  Lanes are grouped in tiles of 32; a tile stops iterating once none
of its lanes is active, which only skips no-op iterations, so the result
equals the global ``any(active)`` loop and ``iters`` is the max over tiles.
Padding lanes never count as active.  The search is forward only: the fit
attaches gradients at the roots through the IFT correction.

``broyden_search`` launches K2 for CUDA tensors and runs
``broyden_search_plain`` for CPU tensors; ``broyden_search.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from nphm_tpu_torch.models.deepsdf import DeepSDFConfig
from nphm_tpu_torch.models.deformation import conditioning
from nphm_tpu_torch.models.mlp import softplus_beta
from nphm_tpu_torch.ops import _build

SQRT2 = 1.4142135623730951
TILE = 32  # lanes per tile (one CUDA block)


def prepare_search_operands(params_trunk, tcfg: DeepSDFConfig, cond):
    """Trunk operands with the conditioning cond [B, lat_dim] folded per row.

    Returns a list of per-layer dicts: layer 0 {"wp" [H,3], "b" [B,H]};
    hidden {"w" [out,in], "b" [out]}; skip {"w", "wp" [out,3], "b" [B,out]}
    with 1/sqrt(2) folded in; last {"w" [out,in], "b" [out]}.
    """
    shapes, skip_in = tcfg.layer_shapes
    ds = tcfg.d_in_spatial
    layers = []
    for i, lay in enumerate(params_trunk["layers"]):
        w, b = lay["w"], lay["b"]
        if i == 0:
            layers.append({"wp": w[:, :ds], "b": cond @ w[:, ds:].T + b})
        elif i == skip_in:
            h = w.shape[1] - tcfg.d_in
            layers.append({
                "w": w[:, :h] / SQRT2,
                "wp": w[:, h : h + ds] / SQRT2,
                "b": (cond @ w[:, h + ds :].T) / SQRT2 + b,
            })
        else:
            layers.append({"w": w, "b": b})
    return layers


def _check_trunk(tcfg: DeepSDFConfig):
    if tcfg.d_in_spatial != 3 or tcfg.out_dim < 3:
        raise ValueError("fused search needs a raw-xyz trunk with >= 3 outputs")


def _flat(obs, xc_init, j_inv_init):
    B, N, _ = obs.shape
    return (
        obs.reshape(B * N, 3).to(torch.float32),
        xc_init.reshape(B * N, 3).to(torch.float32),
        j_inv_init.reshape(B * N, 9).to(torch.float32),
    )


def _trunk_residual(layers, tcfg, x, obs, rows):
    """g(x) = x + trunk(x) - obs for lanes x [P, 3] with cond rows [P]."""
    _shapes, skip_in = tcfg.layer_shapes
    L = len(layers)
    h = None
    for i in range(L - 1):
        lay = layers[i]
        if i == 0:
            z = x @ lay["wp"].T + lay["b"][rows]
        elif i == skip_in:
            z = h @ lay["w"].T + x @ lay["wp"].T + lay["b"][rows]
        else:
            z = h @ lay["w"].T + lay["b"]
        h = softplus_beta(z, tcfg.beta) if tcfg.beta > 0 else torch.relu(z)
    delta = (h @ layers[-1]["w"].T + layers[-1]["b"])[:, :3]
    return (x + delta) - obs


def _matvec3(j9, v):
    """out_i = sum_j J[3i+j] v_j; j9 [P, 9], v [P, 3]."""
    return torch.einsum("pij,pj->pi", j9.reshape(-1, 3, 3), v)


def _result(B, N, xb, bn, j9, act, tile_iters, cvg):
    diff = bn[: B * N].reshape(B, N)
    return {
        "result": xb[: B * N].reshape(B, N, 3),
        "diff": diff,
        "valid_ids": diff < cvg,
        "j_inv": j9[: B * N].reshape(B, N, 3, 3),
        "active": act[: B * N].reshape(B, N),
        "iters": tile_iters.max() if tile_iters.numel() else torch.zeros(
            (), dtype=torch.int32, device=tile_iters.device),
        "tile_iters": tile_iters,  # iterations each TILE-lane tile ran
    }


@torch.no_grad()
def broyden_search_plain(params_trunk, tcfg: DeepSDFConfig, cond, obs, xc_init,
                         j_inv_init, n_iters, *, cvg_thresh: float = 1e-6,
                         dvg_thresh: float = 0.2, eps: float = 1e-6):
    """Plain PyTorch version of K2: same tiles, pad lanes and per-tile exit."""
    _check_trunk(tcfg)
    B, N, _ = obs.shape
    P = B * N
    Pp = _build.round_up(P, TILE)
    layers = prepare_search_operands(params_trunk, tcfg, cond.to(torch.float32))
    o, x, j9 = _flat(obs, xc_init, j_inv_init)
    pad = Pp - P
    if pad:
        o, x, j9 = (torch.cat([t, t[-1:].expand(pad, t.shape[1])]) for t in (o, x, j9))
    dev = obs.device
    lane = torch.arange(Pp, device=dev)
    inb = lane < P
    rows = torch.clamp(lane, max=P - 1) // N
    n_t = Pp // TILE

    gx = _trunk_residual(layers, tcfg, x, o, rows)
    upd = -_matvec3(j9, gx)
    bn = torch.sqrt(torch.sum(gx * gx, dim=-1))
    xb = x.clone()
    act = inb.clone()
    tile_it = torch.zeros(n_t, dtype=torch.int32, device=dev)
    n_iters = int(n_iters)
    while True:
        tile_live = (tile_it < n_iters) & act.reshape(n_t, TILE).any(dim=1)
        if not bool(tile_live.any()):
            break
        live = tile_live.repeat_interleave(TILE)
        a = act[:, None]
        dx = torch.where(a, upd, 0.0)
        x2 = x + dx
        gxn = _trunk_residual(layers, tcfg, x2, o, rows)
        dg = torch.where(a, gxn - gx, 0.0)
        gx2 = gx + dg
        n2 = torch.sqrt(torch.sum(gx2 * gx2, dim=-1))
        better = n2 < bn
        bn2 = torch.where(better, n2, bn)
        xb2 = torch.where(better[:, None], x2, xb)
        act2 = inb & (bn2 > cvg_thresh) & (n2 < dvg_thresh)
        # good-Broyden rank-1 update of J^-1
        vT = torch.einsum("pi,pij->pj", dx, j9.reshape(-1, 3, 3))
        u = dx - _matvec3(j9, dg)
        den = torch.sum(vT * dg, dim=-1)
        den = torch.where(den >= 0, den + eps, den - eps)
        u = u / den[:, None]
        outer = (u[:, :, None] * vT[:, None, :]).reshape(-1, 9)
        j2 = j9 + torch.where(a, outer, 0.0)
        upd2 = -_matvec3(j2, gx2)
        lv = live[:, None]
        x, gx, upd = (torch.where(lv, n, c) for n, c in ((x2, x), (gx2, gx), (upd2, upd)))
        j9 = torch.where(lv, j2, j9)
        xb = torch.where(lv, xb2, xb)
        bn = torch.where(live, bn2, bn)
        act = torch.where(live, act2, act)
        tile_it = tile_it + tile_live.to(torch.int32)
    return _result(B, N, xb, bn, j9, act, tile_it, cvg_thresh)


def _search_trunk(layers, tcfg: DeepSDFConfig, n_per_row: int):
    """Kernel-layout tensors and the ``Trunk`` descriptor for K2."""
    _shapes, skip_in = tcfg.layer_shapes
    L = len(layers)
    specs, keep = [], []
    wp_skip = None
    for i, lay in enumerate(layers):
        b = lay["b"].contiguous()
        if i == 0:
            w = lay["wp"].contiguous()
            H = w.shape[0]
            spec = dict(n_in=3, n_out=H, w=w, ldw=3, w_ms=0, b_rs=H)
        elif i == L - 1:
            w = lay["w"].T.contiguous()  # [in, out]
            spec = dict(n_in=w.shape[0], n_out=w.shape[1], w=w, ldw=w.shape[1], w_ms=0)
        else:
            n_out, n_in = lay["w"].shape
            ldw = _build.round_up(n_out, 8)
            w = _build.padded(lay["w"].T, ldw)
            spec = dict(n_in=n_in, n_out=n_out, w=w, ldw=ldw, w_ms=0)
            if i == skip_in:
                wp_skip = lay["wp"].contiguous()
                spec["b_rs"] = n_out
        spec.update(b=b, b_ms=0)
        spec.setdefault("b_rs", 0)
        specs.append(spec)
        keep += [w, b]
    tr = _build.make_trunk(
        n_layers=L, skip=skip_in, row_len=n_per_row, beta=tcfg.beta, layers=specs,
        wp=wp_skip, wp_ms=0,
    )
    keep.append(wp_skip)
    hmax = max(s["n_out"] for s in specs[:-1])
    return tr, keep, hmax


@torch.no_grad()
def broyden_search(params_trunk, tcfg: DeepSDFConfig, cond, obs, xc_init,
                   j_inv_init, n_iters, *, cvg_thresh: float = 1e-6,
                   dvg_thresh: float = 0.2, eps: float = 1e-6):
    """Run the whole Broyden search fused.

    cond: [B, tcfg.lat_dim] row-constant conditioning; obs / xc_init:
    [B, N, 3]; j_inv_init: [B, N, 3, 3]; n_iters: iteration budget.
    Returns dict(result [B,N,3], diff [B,N], valid_ids [B,N], j_inv
    [B,N,3,3], active [B,N], iters) like ``fitting.broyden.broyden``, plus
    ``tile_iters``, the iterations each tile of lanes ran.
    """
    if not obs.is_cuda:
        return broyden_search_plain(
            params_trunk, tcfg, cond, obs, xc_init, j_inv_init, n_iters,
            cvg_thresh=cvg_thresh, dvg_thresh=dvg_thresh, eps=eps,
        )
    _check_trunk(tcfg)
    if tcfg.beta <= 0 or tcfg.out_dim > 4:
        raise ValueError("K2 implements softplus trunks with at most 4 outputs")
    lib = _build.lib()
    if lib.nphm_search_lanes_per_block() != TILE:
        raise RuntimeError("K2 tile size disagrees with ops.search.TILE")
    B, N, _ = obs.shape
    P = B * N
    Pp = _build.round_up(P, TILE)
    layers = prepare_search_operands(params_trunk, tcfg, cond.to(torch.float32))
    tr, keep, hmax = _search_trunk(layers, tcfg, N)
    o, x, j9 = (t.contiguous() for t in _flat(obs, xc_init, j_inv_init))
    _build.require_cuda_f32(o, x, j9, *keep)
    dev = obs.device
    xb = torch.empty((Pp, 3), device=dev)
    bn = torch.empty((Pp,), device=dev)
    jo = torch.empty((Pp, 9), device=dev)
    act = torch.empty((Pp,), device=dev)
    iters = torch.empty((Pp // TILE,), dtype=torch.int32, device=dev)
    rc = lib.nphm_broyden_search(
        ctypes.byref(tr), o.data_ptr(), x.data_ptr(), j9.data_ptr(),
        xb.data_ptr(), bn.data_ptr(), jo.data_ptr(), act.data_ptr(),
        iters.data_ptr(), Pp, P, int(n_iters), cvg_thresh, dvg_thresh, eps, hmax,
        _build.stream_ptr(dev),
    )
    _build.check(rc, "nphm_broyden_search")
    broyden_search.launches += 1
    return _result(B, N, xb, bn, jo, act > 0.5, iters, cvg_thresh)


broyden_search.launches = 0


def _trunk_of(decoder_expr):
    if getattr(decoder_expr, "kind", None) != "deformation":
        return None
    tcfg = decoder_expr.cfg.trunk_cfg
    if tcfg.d_in_spatial != 3 or tcfg.out_dim < 3 or tcfg.beta <= 0:
        return None
    return tcfg


def search_fusable(decoder_expr) -> bool:
    """Is this expression decoder's search kernel-eligible?"""
    return _trunk_of(decoder_expr) is not None


@torch.no_grad()
def search_fused(decoder_expr, params_expr, obs, cond_lat, anchors, *,
                 max_steps, xc_init, j_inv_init, cvg_thresh: float = 1e-6,
                 dvg_thresh: float = 0.2, search_fn=broyden_search):
    """Counterpart of ``fitting.broyden.search`` on the fused path.

    cond_lat: [B, lat_shape_full + lat_expr]; requires explicit warm inits.
    Diverged points (final-state inactive and not valid) get J^-1 reset to I.
    Returns (xc [B, N, 3], result dict).
    """
    dcfg = decoder_expr.cfg
    cond = conditioning(params_expr, dcfg, cond_lat, anchors)
    res = search_fn(
        params_expr["trunk"], dcfg.trunk_cfg, cond, obs, xc_init, j_inv_init,
        max_steps, cvg_thresh=cvg_thresh, dvg_thresh=dvg_thresh,
    )
    diverged = ~res["active"] & ~res["valid_ids"]
    eye = torch.eye(3, dtype=res["j_inv"].dtype, device=obs.device)
    j_inv = torch.where(diverged[..., None, None], eye, res["j_inv"])
    xc = res["result"]
    return xc, {
        "result": xc,
        "diff": res["diff"].reshape(-1),
        "valid_ids": res["valid_ids"],
        "j_inv": j_inv,
        "iters": res["iters"],
    }
