"""Fused Broyden correspondence search: kernel K2 (``csrc/broyden_search.cu``)
and its plain PyTorch version (counterpart of ``nphm_tpu/ops/pallas_search.py``).

The whole warm search (residual init plus every good-Broyden iteration up to
a runtime budget) runs per (obs, point) lane through the deformation trunk,
whose row-constant conditioning is folded into per-obs biases outside the
kernel.  Lanes are grouped in tiles of 32 (one CUDA block); a tile stops
iterating once none of its lanes is active, which only skips no-op
iterations, so the result equals the global ``any(active)`` loop and
``iters`` is the max over tiles.  A batched fit folds its subjects into
the rows: ``groups`` splits the lanes into equal groups, each padded to a
whole number of tiles, so no tile spans two subjects and ``group_iters``
is each subject's own iteration count.  Padding lanes never count as
active.  The
search is forward only: the fit attaches gradients at the roots through the
IFT correction.

K2 runs the trunk's hidden products on the tensor cores as 3xTF32
(``ops/tf32.py``): the hidden weights go over K-major (``wt`` [out, in]
rounded to 8 columns) and stream through shared memory in 16-wide K slices
of at most 256 outputs; a layer is at most ``MAX_WIDTH`` wide, so the NPM
family's 8x1024 offsets trunk stays on the plain search.

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
TILE = 32  # lanes per tile: csrc/broyden_search.cu kLanes
MAX_WIDTH = 512  # widest non-head layer K2 takes: kMaxWidth
K_SLICE, RING_STAGES, HALF = 16, 2, 256  # its weight ring: kKS, kStages, kHalf
STATE_FIELDS = 28  # floats of Broyden state a lane keeps in shared memory: kFields
MAX_SMEM_BYTES = 232448  # shared memory one block can use on an H100


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


def lane_layout(n_lanes: int, groups: int = 1):
    """(n_pad, group_pad, group_real): n_lanes split into ``groups`` equal
    groups of group_real lanes, each padded to group_pad, a whole number of
    tiles."""
    if groups < 1 or n_lanes % groups:
        raise ValueError(f"{n_lanes} lanes do not split into {groups} equal groups")
    g_real = n_lanes // groups
    g_pad = _build.round_up(g_real, TILE)
    return groups * g_pad, g_pad, g_real


def _result(B, N, groups, xb, bn, j9, act, tile_iters, cvg):
    """Outputs of the padded lanes -> [B, N, ...] of the real ones."""
    _, g_pad, g_real = lane_layout(B * N, groups)

    def real(t, *shape):
        return t.reshape((groups, g_pad) + t.shape[1:])[:, :g_real].reshape(B, N, *shape)

    diff = real(bn)
    group_iters = (tile_iters.reshape(groups, -1).amax(dim=1) if tile_iters.numel()
                   else torch.zeros(groups, dtype=torch.int32, device=tile_iters.device))
    return {
        "result": real(xb, 3),
        "diff": diff,
        "valid_ids": diff < cvg,
        "j_inv": real(j9, 3, 3),
        "active": real(act),
        "iters": group_iters.max(),
        "group_iters": group_iters,  # iterations each group of lanes ran
        "tile_iters": tile_iters,  # iterations each TILE-lane tile ran
    }


@torch.no_grad()
def broyden_search_plain(params_trunk, tcfg: DeepSDFConfig, cond, obs, xc_init,
                         j_inv_init, n_iters, *, cvg_thresh: float = 1e-6,
                         dvg_thresh: float = 0.2, eps: float = 1e-6, groups: int = 1):
    """Plain PyTorch version of K2: same tiles, lane groups, pad lanes and
    per-tile exit."""
    _check_trunk(tcfg)
    B, N, _ = obs.shape
    Pp, g_pad, g_real = lane_layout(B * N, groups)
    layers = prepare_search_operands(params_trunk, tcfg, cond.to(torch.float32))
    dev = obs.device
    lane = torch.arange(Pp, device=dev)
    grp, q = lane // g_pad, lane % g_pad
    inb = q < g_real
    # a padding lane repeats its group's last real lane, as in the kernel
    src = grp * g_real + torch.clamp(q, max=g_real - 1)
    o, x, j9 = (t[src] for t in _flat(obs, xc_init, j_inv_init))
    rows = src // N
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
    return _result(B, N, groups, xb, bn, j9, act, tile_it, cvg_thresh)


def _search_trunk(layers, tcfg: DeepSDFConfig, n_per_row: int):
    """Kernel-layout tensors and the ``Trunk`` descriptor for K2: hidden
    layers K-major (``wt`` [out, ldwt], ldwt = in rounded up to the MMA's K
    step of 8, zero columns past it), the head as [in, out]."""
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
            ldwt = _build.round_up(n_in, 8)
            w = _build.padded(lay["w"], ldwt)  # [out, ldwt]
            spec = dict(n_in=n_in, n_out=n_out, w=w, ldw=ldwt, w_ms=0, wt=w, ldwt=ldwt,
                        wt_ms=0)
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
    return tr, keep


@torch.no_grad()
def broyden_search(params_trunk, tcfg: DeepSDFConfig, cond, obs, xc_init,
                   j_inv_init, n_iters, *, cvg_thresh: float = 1e-6,
                   dvg_thresh: float = 0.2, eps: float = 1e-6, groups: int = 1):
    """Run the whole Broyden search fused.

    cond: [B, tcfg.lat_dim] row-constant conditioning; obs / xc_init:
    [B, N, 3]; j_inv_init: [B, N, 3, 3]; n_iters: iteration budget;
    groups: equal groups of rows (a batched fit's subjects) whose lanes
    never share a tile.  Returns dict(result [B,N,3], diff [B,N], valid_ids
    [B,N], j_inv [B,N,3,3], active [B,N], iters) like
    ``fitting.broyden.broyden``, plus ``group_iters`` [groups] and
    ``tile_iters``, the iterations each group and each tile of lanes ran.
    """
    if not obs.is_cuda:
        return broyden_search_plain(
            params_trunk, tcfg, cond, obs, xc_init, j_inv_init, n_iters,
            cvg_thresh=cvg_thresh, dvg_thresh=dvg_thresh, eps=eps, groups=groups,
        )
    _check_trunk(tcfg)
    if tcfg.beta <= 0 or tcfg.out_dim > 4:
        raise ValueError("K2 implements softplus trunks with at most 4 outputs")
    lib = _build.lib()
    if lib.nphm_search_lanes_per_block() != TILE:
        raise RuntimeError("K2 tile size disagrees with ops.search.TILE")
    B, N, _ = obs.shape
    Pp, g_pad, g_real = lane_layout(B * N, groups)
    layers = prepare_search_operands(params_trunk, tcfg, cond.to(torch.float32))
    tr, keep = _search_trunk(layers, tcfg, N)
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
        iters.data_ptr(), Pp, g_pad, g_real, int(n_iters), cvg_thresh, dvg_thresh, eps,
        _build.stream_ptr(dev),
    )
    _build.check(rc, "nphm_broyden_search")
    broyden_search.launches += 1
    return _result(B, N, groups, xb, bn, jo, act > 0.5, iters, cvg_thresh)


broyden_search.launches = 0


def _trunk_of(decoder_expr):
    """The DeepSDF trunk config K2 would run: the deformation field's trunk,
    or the NPM offsets network itself; None when K2 cannot run it (an
    ``interpolate`` field's conditioning is per point, K2's per row)."""
    kind = getattr(decoder_expr, "kind", None)
    if kind == "deformation_npm":
        tcfg = decoder_expr.cfg
    elif kind == "deformation":
        if decoder_expr.cfg.per_point:
            return None
        tcfg = decoder_expr.cfg.trunk_cfg
    else:
        return None
    if tcfg.d_in_spatial != 3 or tcfg.out_dim < 3 or tcfg.beta <= 0:
        return None
    return tcfg


def search_fusable(decoder_expr) -> bool:
    """Is this expression decoder's search kernel-eligible?"""
    return _trunk_of(decoder_expr) is not None


def search_smem_bytes(tcfg: DeepSDFConfig) -> int:
    """K2's dynamic shared memory for this trunk, a mirror of
    ``search_setup`` (csrc/broyden_search.cu): the [32][act_ld(hmax)]
    activation tile (hmax the widest non-head layer output), the lanes'
    state, head outputs and rows, and the 1 KB-aligned weight ring and its
    barriers."""
    shapes, _skip = tcfg.layer_shapes
    outs = [n_out for _n_in, n_out in shapes[:-1]]
    hmax, nmax = max(outs + [8]), max(outs[1:] + [8])
    ld = _build.round_up(hmax, 8) + 4
    stage = _build.round_up(_build.round_up(min(nmax, HALF), 8) * K_SLICE, 256)
    return 4 * (TILE * ld + (STATE_FIELDS + 5) * TILE + RING_STAGES * stage) + 1024 + (
        16 * RING_STAGES)


def search_fits(decoder_expr) -> bool:
    """Does K2 take this decoder's trunk?  Every non-head layer at most
    ``MAX_WIDTH`` wide, and the shared memory within one block's: True for
    the NPHM 6x512 deformation trunk (104,096 bytes), False for the NPM
    family's 8x1024 offsets trunk."""
    tcfg = _trunk_of(decoder_expr)
    if tcfg is None:
        return False
    shapes, _skip = tcfg.layer_shapes
    return (max(n_out for _n_in, n_out in shapes[:-1]) <= MAX_WIDTH
            and search_smem_bytes(tcfg) <= MAX_SMEM_BYTES)


@torch.no_grad()
def search_fused(decoder_expr, params_expr, obs, cond_lat, anchors, *,
                 max_steps, xc_init, j_inv_init, cvg_thresh: float = 1e-6,
                 dvg_thresh: float = 0.2, groups: int = 1, search_fn=broyden_search):
    """Counterpart of ``fitting.broyden.search`` on the fused path.

    cond_lat: [B, lat_shape_full + lat_expr]; requires explicit warm inits;
    ``groups``: the subjects folded into the B rows (``broyden_search``).
    The NPM family's offsets network is the trunk itself, conditioned on
    cond_lat = [z_id, z_ex].  Diverged points (final-state inactive and not
    valid) get J^-1 reset to I.  Returns (xc [B, N, 3], result dict).
    """
    if decoder_expr.kind == "deformation_npm":
        tcfg, cond, trunk = decoder_expr.cfg, cond_lat, params_expr
    else:
        dcfg = decoder_expr.cfg
        cond = conditioning(params_expr, dcfg, cond_lat, anchors)
        tcfg, trunk = dcfg.trunk_cfg, params_expr["trunk"]
    res = search_fn(
        trunk, tcfg, cond, obs, xc_init, j_inv_init,
        max_steps, cvg_thresh=cvg_thresh, dvg_thresh=dvg_thresh, groups=groups,
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
        "group_iters": res["group_iters"],
    }
