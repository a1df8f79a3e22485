#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nphm_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Device and build: require CUDA, print the card's name and power limit,
   build every kernel from ``nphm_tpu_torch/csrc`` with nvcc (the SASS of
   the product kernels of K3-K7 must hold tensor-core instructions),
   and the host marching library from ``csrc`` (so phase 4 times
   marching, not its build).
2. Models at production dims: the NPHM ensemble of ``configs/nphm.yaml``
   and the compress-mode deformation field of ``configs/nphm_def.yaml``,
   and the NPM family of ``configs/npm.yaml`` / ``configs/npm_def.yaml``
   (8x1024 DeepSDF identity decoder and offsets network), initialised from
   seeded ``torch.Generator``s; mean anchors are the seeded unit-sphere
   fallback (no assets needed).
3. Each kernel against its plain PyTorch version on the card, at the main
   paths' shapes, with its tolerance, both timed with CUDA events, and its
   bound (the least time the card could take for the same work) computed
   from the inputs of the timed run: fp32 operations for the SIMT kernels,
   3xTF32 tensor-core operations for K3-K7.  Each is also
   timed against the PyTorch calls cuBLAS would run for its products
   (``library_ms``): one ``torch.addmm`` per layer for K7, one
   ``torch.baddbmm`` per layer and pass over the member axis for K1 and
   K3-K6 (K2, an iterative search, has none).
4. The fit-and-extract path through the port's entry points: ``fit_joint``
   on synthetic single-view observations, ``extract_mesh`` at res 256,
   ``deform_mesh_batch`` over the fitted expressions and one PLY export.
   K1-K4's and K7's (posing) launch counters must move during this phase.
   Then a 5-step fit through the kernels is held against the same fit on
   the plain torch path (same draws).
5. The identity-training path: ``IdentityTrainer.train_model`` at the
   widths of ``configs/nphm.yaml`` on synthetic heads, with checkpointing,
   reconstruction logging and a resume; K5, K6 and K1's counters must move.
   Then a 3-step training run through K5/K6 is held against the same run on
   the plain path.
6. The NPM path through the same entry points: ``fit_joint`` (K2's shared
   memory does not fit the 8x1024 offsets trunk, so its counter must stay
   at 0), ``extract_mesh`` at res 256 and ``deform_mesh_batch`` through K7,
   one PLY export; then the NPM grid through K7 against its plain version.

The second-to-last line is the kernel table as JSON, the last line the
device record as JSON.  Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
GRID_MIN = (-0.55, -0.5, -0.95)
GRID_MAX = (0.55, 0.75, 0.4)
FIT_STEPS = 300
EXTRACT_RES = 256
K7_GRID_POINTS = 1 << 20  # K7's check (a): points of the res-256 grid
K7_MESH_POINTS = 1 << 19  # checks (b), (c): points of a warped sphere

# Tolerances of kernel vs plain version (fp32 both; only summation order
# and FMA contraction differ, amplified through 4-7 layers).
TOL_K1 = 1e-4  # SDF, absolute
TOL_K2_X = 1e-4  # roots, absolute, lanes valid in both
TOL_K2_J = 1e-2  # J^-1 entries, absolute, lanes valid in both (secant divides)
TOL_K2_NVALID = 0.005  # |n_valid difference| / lanes
TOL_K3 = 1e-4  # F, absolute
TOL_K4 = 1e-4  # gradients, relative to the plain version's max magnitude
TOL_K5 = 1e-4  # F and G, absolute
TOL_K6 = 1e-4  # every gradient, relative to the plain version's max magnitude
# 5-step fit, kernels vs plain path: Adam amplifies ordering noise
TOL_FIT_RTOL, TOL_FIT_ATOL = 1e-3, 5e-4
# 3 training steps, kernels vs plain path: |d_kernel - d_plain| / |d_plain|
# for the change d = after - before of the params and of each latent table
# (L2 norms; measured on an H100: 2.1e-6, 2.7e-6 and 4.9e-5).  Not an
# elementwise bound: Adam moves a weight by ~lr whatever its gradient's
# size, so a near-zero gradient component whose sign differs by ordering
# noise jumps by up to lr while the rest agree.  The validation latents
# take one row-Adam step, made mostly of such ~lr * sign moves.
TOL_TRAIN_UPDATE = {"params": 5e-5, "latents": 5e-5, "latents_val": 5e-4}
TOL_TRAIN_TERMS = 1e-4  # loss terms, relative
# K7, relative to the magnitude of the plain version's head product (its
# output less the head bias): fp32 both ways, only the summation order
# differs, over K = 1024 and 8 layers.  The NPM identity field's head bias
# is shifted to cancel the product (build_npm_models), so its output alone
# would be no measure of the rounding.
TOL_K7 = 1e-4

# Card peaks for the bound (published H100 SXM figures at 700 W, dense):
# fp32 outside the tensor cores (K1, K2: fp32 SIMT), TF32 on the tensor
# cores (K3-K7: 3xTF32, three TF32 products per fp32 product), HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES_S = 3.35e12
# Kernels whose products run as 3xTF32 on the tensor cores, and the kernel
# functions (mangled-name fragments) whose SASS must hold HMMA/HGMMA: each
# of K6's product kernels (its fixed-order sums run no product).
TENSOR_CORE_KERNELS = {"fit_fwd": ("fit_fwd_kernel",), "fit_bwd": ("fit_bwd_kernel",),
                       "train_fwd": ("train_fwd_kernel",),
                       "train_bwd": ("train_bwd_fwd_kernel", "train_bwd_rev_kernel",
                                     "lane_contract"),
                       "deepsdf_trunk": ("trunk_layer_kernel",)}

KERNELS = {
    "ensemble_sdf": ("nphm_tpu_torch/csrc/ensemble_sdf.cu",
                     "nphm_tpu/ops/pallas_ensemble.py:406"),
    "broyden_search": ("nphm_tpu_torch/csrc/broyden_search.cu",
                       "nphm_tpu/ops/pallas_search.py:389"),
    "fit_fwd": ("nphm_tpu_torch/csrc/fit_fields.cu",
                "nphm_tpu/ops/pallas_train.py:707"),
    "fit_bwd": ("nphm_tpu_torch/csrc/fit_fields.cu",
                "nphm_tpu/ops/pallas_train.py:758"),
    "train_fwd": ("nphm_tpu_torch/csrc/train_fields.cu",
                  "nphm_tpu/ops/pallas_train.py:489"),
    "train_bwd": ("nphm_tpu_torch/csrc/train_fields.cu",
                  "nphm_tpu/ops/pallas_train.py:550"),
    "deepsdf_trunk": ("nphm_tpu_torch/csrc/deepsdf_trunk.cu",
                      "nphm_tpu/ops/pallas_mlp.py:191"),
}


class SmokeFailure(RuntimeError):
    pass


def expect(ok: bool, what: str):
    if not ok:
        raise SmokeFailure(what)


def log(msg: str):
    print(msg, flush=True)


def bound(flops: float, nbytes: float, tf32x3: bool = False) -> dict:
    """The least time the card could take: the larger of the operations over
    the peak of the units that run them and the bytes (each input read once,
    each output written once) over the memory rate.  flops counts fp32
    multiply-adds as 2; a 3xTF32 kernel runs three TF32 products for each,
    on the tensor cores."""
    t_ops = (3.0 * flops / PEAK_TF32_FLOPS if tf32x3 else flops / PEAK_FP32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def bound_note(flops: float, b: dict) -> str:
    """A 3xTF32 kernel's bound beside its fp32 figure, for the log."""
    return (f"bound {b['bound_ms']:.3f} ms ({b['bound_by']}, 3xTF32 at "
            f"{PEAK_TF32_FLOPS / 1e12:g} TFLOP/s; fp32 at {PEAK_FP32_FLOPS / 1e12:g} "
            f"TFLOP/s: {flops / PEAK_FP32_FLOPS * 1e3:.3f} ms)")


def trunk_fmas(shapes, skip: int, ds: int, d_in: int) -> int:
    """FMAs of one point through a trunk whose conditioning is folded into
    biases: layer 0 and the skip layer touch only the ``ds`` point inputs."""
    total = 0
    for i, (n_in, n_out) in enumerate(shapes):
        if i == 0:
            n_in = ds
        elif i == skip:
            n_in = n_in - d_in + ds
        total += n_in * n_out
    return total


def nphm_fmas(cfg) -> int:
    shapes, skip = cfg.layer_shapes
    return trunk_fmas(shapes, skip, cfg.input_dim, cfg.d_in)


def weight_bytes(params_ensemble, cfg) -> int:
    """Bytes of the per-member weights a kernel reads (expanded members)."""
    return 4 * cfg.n_members * sum(
        lay["w"][0].numel() + lay["b"][0].numel() for lay in params_ensemble)


def live_lanes(active, tile: int, n_rows: int, n_real: int) -> int:
    """(lane, member) pairs a culled kernel computes, pad lanes excluded.
    active: [n_tiles, members]; rows of Np lanes hold n_real real points."""
    n_t = active.shape[0]
    Np = n_t * tile // n_rows
    real = [min(tile, max(0, n_real - (t * tile) % Np)) for t in range(n_t)]
    per_tile = active.sum(dim=1).cpu().tolist()
    return int(sum(r * int(a) for r, a in zip(real, per_tile)))


def cuda_ms(fn, reps: int):
    """Mean milliseconds of fn() over reps launches, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# ---------------------------------------------------------------------------
# Phase 1 and 2
# ---------------------------------------------------------------------------


def device_and_build():
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: no GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    from nphm_tpu_torch.ops import _build

    secs, report = _build.build()
    _build.lib()
    log(f"[build] nvcc built {os.path.relpath(_build.LIB_PATH, ROOT)} in {secs:.2f} s")
    for line in report.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log(f"[ptxas] {line.strip()}")
    counts = _build.sass_mma_counts()
    for name, fns in TENSOR_CORE_KERNELS.items():
        for fn in fns:
            n = {k: v for k, v in counts.items() if fn in k}
            log(f"[sass] {name}: tensor-core instructions (HGMMA/HMMA) per kernel "
                f"{json.dumps(n)}")
            expect(bool(n) and all(v > 0 for v in n.values()),
                   f"{name}'s SASS holds no tensor-core instruction in {fn}")
    from nphm_tpu_torch.ops.native import get_lib

    t0 = time.perf_counter()
    get_lib()
    log(f"[build] host marching library ready in {time.perf_counter() - t0:.2f} s")
    return smi


def mean_anchors():
    import numpy as np

    rng = np.random.default_rng(0)
    d = rng.normal(size=(39, 3))
    return (0.4 * d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def build_models(device):
    import torch

    from nphm_tpu_torch.config import (
        deformation_config_from_yaml,
        load_yaml,
        nphm_config_from_yaml,
    )
    from nphm_tpu_torch.models import make_deformation_decoder, make_nphm_decoder

    cfg_s = nphm_config_from_yaml(
        load_yaml(os.path.join(ROOT, "configs", "nphm.yaml"))["decoder"]
    )
    cfg_e = deformation_config_from_yaml(
        load_yaml(os.path.join(ROOT, "configs", "nphm_def.yaml")), "compress"
    )
    shape = make_nphm_decoder(cfg_s, mean_anchors())
    expr = make_deformation_decoder(cfg_e)
    gen = torch.Generator().manual_seed(SEED)
    params_shape = shape.init(gen, device)
    params_expr = expr.init(gen, device)
    log(f"[models] NPHM {cfg_s.n_members} members x {cfg_s.layer_shapes[0]}; "
        f"deformation {cfg_e.mode} trunk {cfg_e.trunk_cfg.layer_shapes[0]}")
    return shape, params_shape, expr, params_expr, gen


def build_npm_models(device):
    """The NPM family at the widths of configs/npm.yaml and npm_def.yaml.

    At the configs' init the identity field is nearly constant (about -0.4
    over the head box: the U(+-1/sqrt(fan_in)) hidden layers damp the
    spatial signal and only the head is geometric), so it has no zero set.
    The head bias is shifted by the field's median over the observed points
    of phase 6, which puts the zero set through them.
    """
    import numpy as np
    import torch

    from nphm_tpu_torch.config import (
        build_expression_decoder,
        build_identity_decoder,
        load_yaml,
    )
    from nphm_tpu_torch.ops.trunk import deepsdf_trunk_plain

    shape = build_identity_decoder(
        load_yaml(os.path.join(ROOT, "configs", "npm.yaml"))["decoder"], local=False)
    expr = build_expression_decoder(
        load_yaml(os.path.join(ROOT, "configs", "npm_def.yaml")), "npm")
    gen = torch.Generator().manual_seed(SEED + 10)
    params_shape = shape.init(gen, device)
    params_expr = expr.init(gen, device)
    pts = torch.tensor(np.concatenate(npm_observations()), device=device)
    sdf = deepsdf_trunk_plain(params_shape, shape.cfg, pts,
                              torch.zeros(shape.lat_dim, device=device))
    shift = float(sdf.median())
    params_shape["layers"][-1]["b"] -= shift
    log(f"[models] NPM identity {shape.cfg.layer_shapes[0]} (head bias shifted by "
        f"{-shift:.5f}; field at the observed points was {float(sdf.min()):.5f} .. "
        f"{float(sdf.max()):.5f}); offsets {expr.cfg.layer_shapes[0]}")
    return shape, params_shape, expr, params_expr, gen


def npm_observations():
    return observations(20, 2500, SEED + 3)


def observations(n_obs: int, n_pts: int, seed: int):
    """Sphere of radius 0.4 warped per observation by a seeded nonrigid warp."""
    import numpy as np

    from nphm_tpu_torch.data.dummy import _nonrigid_warp

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_obs):
        d = rng.normal(size=(n_pts, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        out.append(_nonrigid_warp(rng)((0.4 * d).astype(np.float32)))
    return out


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_k1(shape, params, gen, device, rows):
    import torch

    from nphm_tpu_torch.ops.ensemble import (
        CULL_EPS,
        DEFAULT_TILE,
        _brick_points,
        _prepare,
        grid_tile,
        nphm_grid_sdf,
        nphm_sdf,
        nphm_sdf_plain,
    )

    cfg = shape.cfg
    lat = (torch.randn(cfg.lat_dim, generator=gen) * 0.1).to(device)
    lo = torch.tensor(GRID_MIN, device=device)
    hi = torch.tensor(GRID_MAX, device=device)
    pts = lo + (hi - lo) * torch.rand((256 * 1024, 3), generator=gen).to(device)
    err = 0.0
    for eps in (CULL_EPS, 0.0):
        a = nphm_grid_sdf(params, cfg, lat, GRID_MIN, GRID_MAX, 64, cull_eps=eps)
        b = nphm_grid_sdf(params, cfg, lat, GRID_MIN, GRID_MAX, 64, cull_eps=eps,
                          sdf_fn=nphm_sdf_plain)
        e_grid = float((a - b).abs().max())
        c = nphm_sdf(params, cfg, pts, lat, cull_eps=eps)
        d = nphm_sdf_plain(params, cfg, pts, lat, cull_eps=eps)
        e_pts = float((c - d).abs().max())
        expect(bool(torch.isfinite(a).all() and torch.isfinite(c).all()), "K1 non-finite")
        log(f"[K1] cull_eps={eps:g}: 64^3 grid max|err| {e_grid:.3e}, 256k points "
            f"max|err| {e_pts:.3e} (tol {TOL_K1:g})")
        expect(e_grid <= TOL_K1 and e_pts <= TOL_K1, "K1 disagrees with its plain version")
        err = max(err, e_grid, e_pts)
    ms = cuda_ms(lambda: nphm_grid_sdf(params, cfg, lat, GRID_MIN, GRID_MAX, 64), 5)
    plain_ms = cuda_ms(lambda: nphm_grid_sdf(params, cfg, lat, GRID_MIN, GRID_MAX, 64,
                                             sdf_fn=nphm_sdf_plain), 2)
    # the timed grid's live (point, member) pairs, as the kernel culls them
    tile, brick = grid_tile(64, DEFAULT_TILE)
    axes = [torch.linspace(GRID_MIN[i], GRID_MAX[i], 64, device=device) for i in range(3)]
    grid = _brick_points(axes, torch.arange(64**3, device=device), 64, brick, tile)
    with torch.no_grad():
        _, _, _, active = _prepare(params, cfg, grid, lat, tile, CULL_EPS)
    pairs = int(active.sum()) * tile
    b = bound(2.0 * nphm_fmas(cfg) * pairs,
              64**3 * 16 + weight_bytes(params["ensemble"], cfg) // cfg.n_members * cfg.n_loc)
    lib_ms = baddbmm_chain_ms(cfg, cfg.n_members, 64**3, "f", device, 2)
    log(f"[K1] 64^3 brick grid, cull on: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"baddbmm chain (all members, no culling) {lib_ms:.3f} ms; {pairs} live (point, "
        f"member) pairs, bound {b['bound_ms']:.3f} ms ({b['bound_by']})")
    rows["ensemble_sdf"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                library_ms=lib_ms, **b)


def search_inputs(shape, params_shape, expr, params_expr, gen, device, B, N):
    import numpy as np
    import torch

    from nphm_tpu_torch.models.deformation import conditioning
    from nphm_tpu_torch.models.ensemble import predict_anchors

    obs = torch.tensor(np.stack(observations(B, N, SEED + 1)), device=device)
    lat_s = (torch.randn((1, shape.lat_dim), generator=gen) * 0.01).to(device)
    lat_e = (torch.randn((B, expr.lat_dim), generator=gen) * 0.01).to(device)
    anchors = predict_anchors(params_shape, shape.cfg, lat_s).expand(B, -1, -1)
    cond_lat = torch.cat([lat_s.expand(B, -1), lat_e], dim=-1)
    with torch.no_grad():
        cond = conditioning(params_expr, expr.cfg, cond_lat, anchors)
    eye = torch.eye(3, device=device).expand(B, N, 3, 3).contiguous()
    return obs, cond, eye


def check_k2(shape, params_shape, expr, params_expr, gen, device, rows):
    """K2 at the fit's shapes, cold (budget 15) then warm (budget 3), on the
    random-init trunk (an easy search: ~2 iterations) and on a copy whose
    offset head is scaled 90x (about half the lanes diverge, the rest need
    ~9 iterations)."""
    import torch

    from nphm_tpu_torch.ops.search import TILE, broyden_search, broyden_search_plain

    B, N = 5, 1000
    obs, cond, eye = search_inputs(shape, params_shape, expr, params_expr, gen,
                                   device, B, N)
    tcfg = expr.cfg.trunk_cfg
    base = params_expr["trunk"]
    hard = {"layers": base["layers"][:-1] + [
        {k: v * 90.0 for k, v in base["layers"][-1].items()}]}
    err_x = 0.0
    for tag, trunk in (("random-init", base), ("offset head x90", hard)):
        warm = None
        for budget in (15, 3):
            x0, j0 = (obs, eye) if warm is None else (warm["result"], warm["j_inv"])
            k = broyden_search(trunk, tcfg, cond, obs, x0, j0, budget)
            p = broyden_search_plain(trunk, tcfg, cond, obs, x0, j0, budget)
            both = k["valid_ids"] & p["valid_ids"]
            ex = float((k["result"] - p["result"]).abs()[both].max()) if both.any() else 0.0
            eb = float((k["diff"] - p["diff"]).abs()[both].max()) if both.any() else 0.0
            ej = float((k["j_inv"] - p["j_inv"]).abs()[both].max()) if both.any() else 0.0
            nk, np_ = int(k["valid_ids"].sum()), int(p["valid_ids"].sum())
            log(f"[K2] {tag}, budget {budget}: n_valid kernel {nk} plain {np_} of "
                f"{B * N}; still active {int(k['active'].sum())}; iters "
                f"{int(k['iters'])}/{int(p['iters'])}; valid-in-both max|dx| {ex:.3e} "
                f"max|dbn| {eb:.3e} (tol {TOL_K2_X:g}) max|dJ| {ej:.3e} "
                f"(tol {TOL_K2_J:g})")
            expect(bool(torch.isfinite(k["diff"]).all()), "K2 non-finite residuals")
            expect(ex <= TOL_K2_X and eb <= TOL_K2_X and ej <= TOL_K2_J,
                   "K2 disagrees with its plain version")
            expect(abs(nk - np_) <= TOL_K2_NVALID * B * N, "K2 n_valid disagrees")
            err_x = max(err_x, ex, eb)
            warm = p
    ms = cuda_ms(lambda: broyden_search(base, tcfg, cond, obs, obs, eye, 15), 5)
    plain_ms = cuda_ms(lambda: broyden_search_plain(base, tcfg, cond, obs, obs, eye, 15), 3)
    # trunk evaluations the timed search ran: one per lane, plus one per
    # lane and iteration of its tile
    run = broyden_search(base, tcfg, cond, obs, obs, eye, 15)
    its = run["tile_iters"].cpu().tolist()
    real = [min(TILE, B * N - t * TILE) for t in range(len(its))]
    evals = sum(r * (1 + i) for r, i in zip(real, its))
    shapes, skip = tcfg.layer_shapes
    fmas = trunk_fmas(shapes, skip, tcfg.d_in_spatial, tcfg.d_in)
    wbytes = 4 * sum(lay["w"].numel() + lay["b"].numel() for lay in base["layers"])
    b = bound(2.0 * fmas * evals, B * N * 4 * (15 + 14) + wbytes)
    log(f"[K2] B=5 N=1000 budget 15: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; "
        f"iterations per {TILE}-lane tile mean {sum(its) / len(its):.2f} max {max(its)}, "
        f"{evals} trunk evaluations of {fmas} FMAs, bound {b['bound_ms']:.3f} ms "
        f"({b['bound_by']})")
    rows["broyden_search"] = dict(max_abs_err=err_x, ms=ms, plain_ms=plain_ms, **b)


def check_k3_k4(shape, params, gen, device, rows):
    import numpy as np
    import torch

    from nphm_tpu_torch.models.ensemble import mirror_scale, predict_anchors
    from nphm_tpu_torch.ops.fit_fields import (
        active_mask,
        member_f,
        member_f_plain,
        morton_codes,
        prepare_train_operands,
    )

    cfg = shape.cfg
    B, N, tile = 5, 1000, 512
    xyz = torch.tensor(np.stack(observations(B, N, SEED + 2)), device=device)
    lat = (torch.randn((1, cfg.lat_dim), generator=gen) * 0.01).to(device).expand(B, -1)
    lat = lat.contiguous().requires_grad_(True)
    perm = torch.argsort(morton_codes(xyz), dim=1, stable=True)
    xyz = torch.gather(xyz, 1, perm[..., None].expand(B, N, 3))
    Np = -(-N // tile) * tile
    xyz = torch.cat([xyz, xyz[:, -1:].expand(B, Np - N, 3)], dim=1)
    anchors = predict_anchors(params, cfg, lat)
    centers = torch.cat([anchors, torch.zeros_like(anchors[:, :1])], dim=1)
    coords = (xyz[:, :, None] - centers[:, None]) * mirror_scale(cfg, device)
    A = cfg.n_members
    coords = coords.permute(2, 3, 0, 1).reshape(A, 3, B * Np).detach().requires_grad_(True)
    layers, _ = prepare_train_operands(params, cfg, lat)
    active = active_mask(cfg, coords, tile, 1e-10)
    _, skip = cfg.layer_shapes
    ins = (layers[0]["b"], layers[skip]["b"], coords)
    dF = torch.randn((A, B * Np), generator=gen).to(device)

    Fk = member_f(cfg, layers, coords, active, tile, B)
    Fp = member_f_plain(cfg, layers, coords, active, tile, B)
    e3 = float((Fk - Fp).detach().abs().max())
    gk = torch.autograd.grad(Fk, ins, dF, retain_graph=True)
    gp = torch.autograd.grad(Fp, ins, dF, retain_graph=True)
    e4 = 0.0
    for name, a, b in zip(("d_bias0", "d_biasS", "d_coords"), gk, gp):
        scale = float(b.abs().max())
        rel = float((a - b).abs().max()) / max(scale, 1e-30)
        log(f"[K4] {name}: max|err| {float((a - b).abs().max()):.3e}, relative "
            f"{rel:.3e} (tol {TOL_K4:g})")
        expect(rel <= TOL_K4, f"K4 {name} disagrees with its plain version")
        e4 = max(e4, float((a - b).abs().max()))
    log(f"[K3] F [{A}, {B * Np}]: max|err| {e3:.3e} (tol {TOL_K3:g}); live "
        f"(tile, member) pairs {int(active.sum())}/{active.numel()}")
    expect(e3 <= TOL_K3, "K3 disagrees with its plain version")
    expect(bool(torch.isfinite(Fk).all()), "K3 non-finite")

    with torch.no_grad():
        ms3 = cuda_ms(lambda: member_f(cfg, layers, coords, active, tile, B), 10)
        plain3 = cuda_ms(lambda: member_f_plain(cfg, layers, coords, active, tile, B), 5)
    ms4 = cuda_ms(lambda: torch.autograd.grad(Fk, ins, dF, retain_graph=True), 10)
    plain4 = cuda_ms(lambda: torch.autograd.grad(Fp, ins, dF, retain_graph=True), 5)
    pairs = live_lanes(active, tile, B, N)
    wb = weight_bytes(params["ensemble"], cfg)
    flops3 = 2.0 * nphm_fmas(cfg) * pairs
    b3 = bound(flops3, pairs * 16 + wb, tf32x3=True)
    flops4 = 4.0 * nphm_fmas(cfg) * pairs
    b4 = bound(flops4, pairs * 28 + wb, tf32x3=True)
    M = B * Np
    lib3 = baddbmm_chain_ms(cfg, A, M, "f", device, 10)
    lib4 = baddbmm_chain_ms(cfg, A, M, "fr", device, 10)
    log(f"[K3] M=5x1024: kernel {ms3:.3f} ms, plain {plain3:.3f} ms, baddbmm chain "
        f"{lib3:.3f} ms; {pairs} live (point, member) pairs, {bound_note(flops3, b3)}")
    log(f"[K4] M=5x1024: kernel {ms4:.3f} ms, plain backward {plain4:.3f} ms, baddbmm "
        f"forward + reverse chains {lib4:.3f} ms; {bound_note(flops4, b4)}")
    rows["fit_fwd"] = dict(max_abs_err=e3, ms=ms3, plain_ms=plain3, library_ms=lib3, **b3)
    rows["fit_bwd"] = dict(max_abs_err=e4, ms=ms4, plain_ms=plain4, library_ms=lib4, **b4)


def train_batch(n_rows: int, seed: int):
    """Points [n_rows, 1693, 3] of one synthetic identity batch at the
    production sampling (750 face / 250 non-face points a row)."""
    import numpy as np

    from nphm_tpu_torch.data.synthetic import SyntheticIdentityDataset

    ds = SyntheticIdentityDataset(n_subjects=n_rows, batch_size=n_rows, n_face=750,
                                  n_non_face=250, n_anchors=39, seed=seed)
    b = next(iter(ds.batch_iter(seed=seed)))
    return np.concatenate([b["points_face"], b["points_non_face"], b["sup_grad_far"],
                           b["sup_grad_near"]], axis=1)


def check_k5_k6(shape, params, gen, device, rows):
    """K5/K6 at the training path's shapes: production width, B=32 rows x
    1693 points (padded to 2048, so K6 runs in member chunks), without
    culling (the training default) and with cull_eps 1e-10 on Morton-sorted
    points (the fit's "train" route).  Prints the peak device memory, which
    the plain double backward sets."""
    import torch

    from nphm_tpu_torch.models.ensemble import mirror_scale, predict_anchors
    from nphm_tpu_torch.ops.fit_fields import active_mask, morton_codes, prepare_train_operands
    from nphm_tpu_torch.ops.train_fields import (
        _flat,
        _unflat,
        member_fields,
        member_fields_plain,
    )

    cfg = shape.cfg
    B, tile, A = 32, 512, cfg.n_members
    torch.cuda.reset_peak_memory_stats(device)
    xyz0 = torch.tensor(train_batch(B, SEED + 4), device=device)
    N = xyz0.shape[1]
    lat = (torch.randn((B, cfg.lat_dim), generator=gen) * 0.1).to(device)
    e5 = e6 = 0.0
    for cull_eps in (0.0, 1e-10):
        xyz = xyz0
        if cull_eps > 0:
            perm = torch.argsort(morton_codes(xyz), dim=1, stable=True)
            xyz = torch.gather(xyz, 1, perm[..., None].expand(B, N, 3))
        Np = -(-N // tile) * tile
        xyz = torch.cat([xyz, xyz[:, -1:].expand(B, Np - N, 3)], dim=1)
        with torch.no_grad():
            anchors = predict_anchors(params, cfg, lat)
            centers = torch.cat([anchors, torch.zeros_like(anchors[:, :1])], dim=1)
            coords = (xyz[:, :, None] - centers[:, None]) * mirror_scale(cfg, device)
            coords = coords.permute(2, 3, 0, 1).reshape(A, 3, B * Np).contiguous()
            layers, _ = prepare_train_operands(params, cfg, lat)
        flat = [t.detach().clone().requires_grad_(True) for t in _flat(cfg, layers)]
        layers = _unflat(cfg, flat)
        coords.requires_grad_(True)
        active = active_mask(cfg, coords, tile, cull_eps)
        ins = flat + [coords]
        dF = torch.randn((A, B * Np), generator=gen).to(device)
        dG = torch.randn((A, 3, B * Np), generator=gen).to(device)

        Fk, Gk = member_fields(cfg, layers, coords, active, tile, B)
        Fp, Gp = member_fields_plain(cfg, layers, coords, active, tile, B)
        ef = float((Fk - Fp).detach().abs().max())
        eg = float((Gk - Gp).detach().abs().max())
        log(f"[K5] cull_eps={cull_eps:g}: F [{A}, {B * Np}] max|err| {ef:.3e}, G max|err| "
            f"{eg:.3e} (tol {TOL_K5:g}); live (tile, member) pairs "
            f"{int(active.sum())}/{active.numel()}")
        expect(bool(torch.isfinite(Fk).all() and torch.isfinite(Gk).all()), "K5 non-finite")
        expect(ef <= TOL_K5 and eg <= TOL_K5, "K5 disagrees with its plain version")
        e5 = max(e5, ef, eg)
        phi_k = (Fk * dF).sum() + (Gk * dG).sum()
        phi_p = (Fp * dF).sum() + (Gp * dG).sum()
        gk = torch.autograd.grad(phi_k, ins, retain_graph=True)
        gk2 = torch.autograd.grad(phi_k, ins, retain_graph=True)
        expect(all(torch.equal(a, b) for a, b in zip(gk, gk2)),
               "two K6 calls on the same inputs differ (its sums must have a fixed order)")
        del gk2
        gp = torch.autograd.grad(phi_p, ins, retain_graph=True)
        names = [f"op{i}{list(t.shape)}" for i, t in enumerate(flat)] + ["d_coords"]
        worst = (0.0, "")
        for name, a, b in zip(names, gk, gp):
            err = float((a - b).abs().max())
            rel = err / max(float(b.abs().max()), 1e-30)
            expect(bool(torch.isfinite(a).all()), f"K6 {name} non-finite")
            if rel > TOL_K6:
                log(f"[K6] {name}: max|err| {err:.3e}, relative {rel:.3e}")
            expect(rel <= TOL_K6, f"K6 {name} disagrees with its plain version")
            e6 = max(e6, err)
            worst = max(worst, (rel, name))
        log(f"[K6] cull_eps={cull_eps:g}: {len(names)} gradients, worst relative error "
            f"{worst[0]:.3e} ({worst[1]}) (tol {TOL_K6:g}); two calls bit-identical")
        if cull_eps == 0.0:
            with torch.no_grad():
                ms5 = cuda_ms(lambda: member_fields(cfg, layers, coords, active, tile, B), 5)
            plain5 = cuda_ms(lambda: member_fields_plain(cfg, layers, coords, active, tile, B), 3)
            ms6 = cuda_ms(lambda: torch.autograd.grad(phi_k, ins, retain_graph=True), 3)
            plain6 = cuda_ms(lambda: torch.autograd.grad(phi_p, ins, retain_graph=True), 3)
            pairs = live_lanes(active, tile, B, N)
            wb = weight_bytes(params["ensemble"], cfg)
            flops5 = 2.0 * 2 * nphm_fmas(cfg) * pairs
            b5 = bound(flops5, pairs * 28 + wb, tf32x3=True)
            flops6 = 2.0 * 6 * nphm_fmas(cfg) * pairs
            b6 = bound(flops6, pairs * 40 + 2 * wb, tf32x3=True)
            scr6 = A * k6_scratch_bytes(cfg, B * Np)
            log(f"[K5] M={B}x{Np}: kernel {ms5:.3f} ms, plain {plain5:.3f} ms; {pairs} "
                f"(point, member) pairs, {bound_note(flops5, b5)}")
            log(f"[K6] M={B}x{Np}: kernel {ms6:.3f} ms, plain double backward "
                f"{plain6:.3f} ms; {bound_note(flops6, b6)}; its scratch moves "
                f"{scr6 / 1e9:.2f} GB ({scr6 / PEAK_HBM_BYTES_S * 1e3:.3f} ms at "
                f"{PEAK_HBM_BYTES_S / 1e12:g} TB/s)")
        del Fp, Gp, phi_p, gp
    log(f"[K5/K6] peak device memory of the checks at B={B}: "
        f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    del Fk, Gk, phi_k, gk, flat, layers, coords, ins, dF, dG
    torch.cuda.empty_cache()
    lib5 = baddbmm_chain_ms(cfg, A, B * Np, "fr", device, 3)
    lib6 = baddbmm_chain_ms(cfg, A, B * Np, "frfwrw", device, 3)
    log(f"[K5/K6] M={B}x{Np}: baddbmm forward + reverse chains {lib5:.3f} ms (K5's "
        f"products), forward, reverse, tangent forward, weight gradients, reverse, weight "
        f"gradients {lib6:.3f} ms (K6's)")
    rows["train_fwd"] = dict(max_abs_err=e5, ms=ms5, plain_ms=plain5, library_ms=lib5, **b5)
    rows["train_bwd"] = dict(max_abs_err=e6, ms=ms6, plain_ms=plain6, library_ms=lib6, **b6)


def k6_scratch_bytes(cfg, M: int) -> int:
    """Bytes K6's scratch moves for one member over M lanes: its first pass
    writes the [h | q] rows of every hidden layer, the second reads them and
    writes the [zbar | pbar] rows of every hidden product, the contraction
    reads all of them; each row holds 2M floats."""
    shapes, _ = cfg.layer_shapes
    outs = [n_out for _, n_out in shapes[:-1]]
    hq, zp = sum(outs), sum(outs[1:])
    return 4 * 2 * M * (2 * hq + zp + (hq + zp))


def baddbmm_chain_ms(cfg, n_members: int, M: int, passes: str, device, reps: int) -> float:
    """One ``torch.baddbmm`` per layer and pass over the member axis at the
    NPHM ensemble's shapes (conditioning folded: layer 0 reads the 3 point
    inputs, the skip layer hidden + 3), M points a member, TF32 off, random
    operands, no activations.  Passes: "f" a forward chain (each layer's
    output feeds the next; the skip layer reads a separate input), "r" a
    reverse chain through the transposed weights, "w" the weight-gradient
    products x^T d of every layer.  The products cuBLAS would run for the
    per-member chains of K1 and K3-K6; timed only, the port never calls it."""
    import torch

    shapes, skip = cfg.layer_shapes
    ds = cfg.input_dim
    kn = [(ds if i == 0 else (n_in - cfg.d_in + ds if i == skip else n_in), n_out)
          for i, (n_in, n_out) in enumerate(shapes)]
    A = n_members
    W = [torch.randn(A, k, n, device=device) / k**0.5 for k, n in kn]
    bias = [torch.zeros(A, 1, n, device=device) for _, n in kn]
    zero = torch.zeros(1, 1, 1, device=device)
    x0 = torch.randn(A, M, ds, device=device)
    x_skip = torch.randn(A, M, kn[skip][0], device=device)
    d0 = torch.randn(A, M, kn[-1][1], device=device)
    if "w" in passes:
        X = torch.randn(A, M, max(k for k, _ in kn), device=device)
        D = torch.randn(A, M, max(n for _, n in kn), device=device)

    def chain():
        for p in passes:
            if p == "f":
                x = x0
                for i in range(len(W)):
                    x = torch.baddbmm(bias[i], x_skip if i == skip else x, W[i])
            elif p == "r":
                d = d0
                for i in reversed(range(1, len(W))):
                    d = torch.baddbmm(zero, d, W[i].transpose(1, 2))[:, :, : kn[i - 1][1]]
            else:
                for i, (k, n) in enumerate(kn):
                    torch.baddbmm(zero, X[:, :, :k].transpose(1, 2), D[:, :, :n])

    ms = cuda_ms(chain, reps)
    torch.cuda.empty_cache()
    return ms


def addmm_chain_ms(cfg, n: int, device, reps: int) -> float:
    """One ``torch.addmm`` per layer at K7's shapes (layer 0 over the point
    features, the skip layer over hidden + point features, conditioning
    folded): the products cuBLAS would run for the same work, TF32 off,
    random operands, no activations.  Timed only; the port never calls it."""
    import torch

    shapes, skip = cfg.layer_shapes
    ds = cfg.d_in_spatial
    ws, bs = [], []
    for i, (n_in, n_out) in enumerate(shapes):
        k = ds if i == 0 else (n_in - cfg.d_in + ds if i == skip else n_in)
        ws.append(torch.randn(k, n_out, device=device) / k**0.5)
        bs.append(torch.zeros(n_out, device=device))
    pe = torch.randn(n, ds, device=device)
    skip_in = torch.randn(n, ws[skip].shape[0], device=device)

    def chain():
        x = torch.addmm(bs[0], pe, ws[0])
        for i in range(1, len(ws)):
            x = torch.addmm(bs[i], skip_in if i == skip else x, ws[i])
        return x

    return cuda_ms(chain, reps)


def trunk_flops(cfg, n: int) -> float:
    """K7's fp32 operations on n points (conditioning folded)."""
    shapes, skip = cfg.layer_shapes
    return 2.0 * trunk_fmas(shapes, skip, cfg.d_in_spatial, cfg.d_in) * n


def trunk_bound(cfg, n: int, layers) -> dict:
    """K7's bound: its products as 3xTF32 on the tensor cores against the
    point features read, the outputs written and the folded weights."""
    wbytes = 4 * sum(t.numel() for lay in layers for t in lay.values())
    return bound(trunk_flops(cfg, n), n * 4 * (cfg.d_in_spatial + cfg.out_dim) + wbytes,
                 tf32x3=True)


def k7_error(kernel, plain, head_bias):
    """(max |kernel - plain|, the plain head product's max magnitude)."""
    return (float((kernel - plain).abs().max()),
            float((plain - head_bias).abs().max()))


def check_k7(models, npm, device, rows):
    """K7 on the three trunks the main paths run, each against its plain
    version, both timed with CUDA events after a warm-up, beside the addmm
    chain: (a) the NPM identity trunk on 2^20 points of the res-256 grid
    (its middle x-slabs), (b) the NPM offsets trunk and (c) the NPHM
    compress trunk on 2^19 points of a warped sphere (a mesh's vertices).
    The table row is (a), the res-256 NPM grid's trunk."""
    import torch

    from nphm_tpu_torch.models.deformation import conditioning
    from nphm_tpu_torch.models.ensemble import predict_anchors
    from nphm_tpu_torch.ops.trunk import (
        deepsdf_trunk,
        deepsdf_trunk_plain,
        prepare_trunk_operands,
    )

    shape, params_shape, expr, params_expr, gen = models
    n_shape, n_ps, n_expr, n_pe, _ = npm
    res, n_a = 256, K7_GRID_POINTS
    lin = torch.arange(n_a, device=device) + (res**3 - n_a) // 2
    axes = [torch.linspace(GRID_MIN[i], GRID_MAX[i], res, device=device) for i in range(3)]
    grid = torch.stack([axes[0][lin // res**2], axes[1][(lin // res) % res],
                        axes[2][lin % res]], dim=-1)
    verts = torch.tensor(observations(1, K7_MESH_POINTS, SEED + 6)[0], device=device)
    lat_npm = (torch.randn(n_shape.lat_dim, generator=gen) * 0.01).to(device)
    cond_b = (torch.randn(n_expr.cfg.lat_dim, generator=gen) * 0.01).to(device)
    lat_s = (torch.randn((1, shape.lat_dim), generator=gen) * 0.01).to(device)
    lat_e = (torch.randn((1, expr.lat_dim), generator=gen) * 0.01).to(device)
    with torch.no_grad():
        anchors = predict_anchors(params_shape, shape.cfg, lat_s)
        cond_c = conditioning(params_expr, expr.cfg, torch.cat([lat_s, lat_e], -1),
                              anchors)[0]
    cases = (
        ("(a) NPM identity 8x1024, 2^20 res-256 grid points", n_ps, n_shape.cfg, grid,
         lat_npm, 3),
        ("(b) NPM offsets 8x1024, 2^19 sphere points", n_pe, n_expr.cfg, verts, cond_b, 3),
        ("(c) NPHM compress 6x512, 2^19 sphere points", params_expr["trunk"],
         expr.cfg.trunk_cfg, verts, cond_c, 5),
    )
    err = 0.0
    row = None
    for tag, params, cfg, pts, cond, reps in cases:
        k = deepsdf_trunk(params, cfg, pts, cond)
        p = deepsdf_trunk_plain(params, cfg, pts, cond)
        e, scale = k7_error(k, p, params["layers"][-1]["b"])
        log(f"[K7] {tag}: max|err| {e:.3e}, relative {e / max(scale, 1e-30):.3e} "
            f"(tol {TOL_K7:g}) to the head product's max magnitude {scale:.4f}")
        expect(bool(torch.isfinite(k).all()), f"K7 non-finite on {tag}")
        expect(e <= TOL_K7 * scale, f"K7 disagrees with its plain version on {tag}")
        err = max(err, e)
        del k, p
        ms = cuda_ms(lambda: deepsdf_trunk(params, cfg, pts, cond), reps)
        plain_ms = cuda_ms(lambda: deepsdf_trunk_plain(params, cfg, pts, cond), reps)
        lib_ms = addmm_chain_ms(cfg, pts.shape[0], device, reps)
        with torch.no_grad():
            b = trunk_bound(cfg, pts.shape[0], prepare_trunk_operands(params, cfg, cond))
        flops = trunk_flops(cfg, pts.shape[0])
        log(f"[K7] {tag}: kernel {ms:.3f} ms ({flops / ms / 1e9:.2f} fp32-equivalent "
            f"TFLOP/s), plain {plain_ms:.3f} ms, addmm chain {lib_ms:.3f} ms "
            f"({'kernel faster' if ms < lib_ms else 'kernel slower'}); {bound_note(flops, b)}")
        torch.cuda.empty_cache()
        if row is None:
            row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **b)
    rows["deepsdf_trunk"] = dict(max_abs_err=err, **row)


def kernel_checks(models, npm, device):
    shape, params_shape, expr, params_expr, gen = models
    rows = {}
    check_k1(shape, params_shape, gen, device, rows)
    check_k2(shape, params_shape, expr, params_expr, gen, device, rows)
    check_k3_k4(shape, params_shape, gen, device, rows)
    check_k5_k6(shape, params_shape, gen, device, rows)
    check_k7(models, npm, device, rows)
    return rows


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------


def reset_counters():
    from nphm_tpu_torch.ops.ensemble import nphm_sdf
    from nphm_tpu_torch.ops.fit_fields import member_f
    from nphm_tpu_torch.ops.search import broyden_search
    from nphm_tpu_torch.ops.train_fields import member_fields
    from nphm_tpu_torch.ops.trunk import deepsdf_trunk

    deepsdf_trunk.launches = 0
    nphm_sdf.launches = 0
    broyden_search.launches = 0
    member_f.launches = 0
    member_f.bwd_launches = 0
    member_fields.launches = 0
    member_fields.bwd_launches = 0


def read_counters():
    from nphm_tpu_torch.ops.ensemble import nphm_sdf
    from nphm_tpu_torch.ops.fit_fields import member_f
    from nphm_tpu_torch.ops.search import broyden_search
    from nphm_tpu_torch.ops.train_fields import member_fields
    from nphm_tpu_torch.ops.trunk import deepsdf_trunk

    return {
        "ensemble_sdf": nphm_sdf.launches,
        "broyden_search": broyden_search.launches,
        "fit_fwd": member_f.launches,
        "fit_bwd": member_f.bwd_launches,
        "train_fwd": member_fields.launches,
        "train_bwd": member_fields.bwd_launches,
        "deepsdf_trunk": deepsdf_trunk.launches,
    }


def main_path(models, device):
    import numpy as np
    import torch

    from nphm_tpu_torch.fitting.inference import FittingConfig, fit_joint
    from nphm_tpu_torch.reconstruction.extract import deform_mesh_batch, extract_mesh

    shape, params_shape, expr, params_expr, _gen = models
    obs = observations(20, 2500, SEED + 3)
    cfg = FittingConfig(n_steps=FIT_STEPS, log_every=100, seed=SEED)

    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lat_expr, lat_shape, anchors, hist = fit_joint(
        shape, params_shape, expr, params_expr, obs, cfg=cfg, device=device,
        verbose=False,
    )
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    loss = np.asarray(hist["loss"])
    steady = hist["steady_it_s"]
    log(f"[fit] {FIT_STEPS} steps in {t_fit:.2f} s; steady {steady:.2f} it/s "
        f"(first step {hist['first_step_s']:.2f} s excluded); loss "
        f"{loss[0]:.5f} -> {loss[-1]:.5f}; n_valid {int(hist['n_valid'][0])} -> "
        f"{int(hist['n_valid'][-1])} of {cfg.n_obs_per_batch * cfg.n_points_per_obs}; "
        f"executed Broyden iterations mean {float(np.mean(hist['broyden_iters'])):.2f}")
    expect(bool(np.isfinite(loss).all()), "fit loss history is not finite")
    expect(bool(np.isfinite(lat_shape).all() and np.isfinite(lat_expr).all()),
           "fitted latents are not finite")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mesh, timing = extract_mesh(shape, params_shape, lat_shape, GRID_MIN, GRID_MAX,
                                256, device=device, return_timing=True)
    t_ext = time.perf_counter() - t0
    qps = 256**3 / timing["grid_s"]
    log(f"[extract] res 256: grid eval {timing['grid_s']:.3f} s ({qps / 1e6:.2f} M q/s), "
        f"marching {timing['march_s']:.3f} s, total {t_ext:.3f} s; "
        f"{len(mesh.vertices)} vertices, {len(mesh.faces)} faces")
    expect(len(mesh.vertices) > 0 and len(mesh.faces) > 0, "extracted mesh is empty")
    expect(bool(np.isfinite(mesh.vertices).all()), "mesh vertices are not finite")

    t0 = time.perf_counter()
    posed = deform_mesh_batch(mesh, expr, params_expr, lat_expr, anchors=anchors,
                              lat_shape=lat_shape, device=device)
    t_def = time.perf_counter() - t0
    expect(len(posed) == len(obs), "one posed mesh per expression")
    expect(all(np.isfinite(m.vertices).all() for m in posed), "posed vertices not finite")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "expr_000.ply")
        posed[0].export(path)
        size = os.path.getsize(path)
    log(f"[deform] {len(posed)} expressions in {t_def:.3f} s; exported one PLY "
        f"({size} bytes)")
    counts = read_counters()
    log(f"[counters] fit path: {json.dumps(counts)}")
    for name in ("ensemble_sdf", "broyden_search", "fit_fwd", "fit_bwd", "deepsdf_trunk"):
        expect(counts[name] > 0, f"kernel {name} was not launched on the fit path")
    check_fit_reference(models, obs, device)
    return counts


def check_fit_reference(models, obs, device):
    """A short fit through K2-K4 against the plain torch path on the same draws."""
    import numpy as np

    from nphm_tpu_torch.fitting.inference import FittingConfig, fit_joint

    shape, params_shape, expr, params_expr, _gen = models
    steps, nb, npp = 5, 5, 1000
    rng = np.random.default_rng(SEED)
    draws = (rng.integers(0, len(obs), size=(steps, nb)),
             rng.integers(0, len(obs[0]), size=(steps, nb, npp)))
    out = {}
    for mode in ("auto", "off"):
        cfg = FittingConfig(n_steps=steps, fused_search=mode, fused_shape_fields=mode)
        out[mode] = fit_joint(shape, params_shape, expr, params_expr, obs, cfg=cfg,
                              device=device, verbose=False, sample_draws=draws)
    (le, ls, _, h), (rle, rls, _, rh) = out["auto"], out["off"]
    errs = {k: float(np.abs(a - b).max()) for k, a, b in
            (("lat_shape", ls, rls), ("lat_expr", le, rle), ("loss", h["loss"], rh["loss"]))}
    log(f"[fit-check] 5 steps, kernels vs plain path: max|diff| "
        f"{json.dumps(errs)}; n_valid {h['n_valid'].tolist()} vs {rh['n_valid'].tolist()} "
        f"(rtol {TOL_FIT_RTOL:g}, atol {TOL_FIT_ATOL:g})")
    for a, b in ((ls, rls), (le, rle), (h["loss"], rh["loss"])):
        expect(bool(np.allclose(a, b, rtol=TOL_FIT_RTOL, atol=TOL_FIT_ATOL)),
               "the kernel fit disagrees with the plain-path fit")
    expect(bool(np.all(np.abs(h["n_valid"] - rh["n_valid"]) <= TOL_K2_NVALID * nb * npp)),
           "the kernel fit's n_valid disagrees with the plain path's")


# ---------------------------------------------------------------------------
# Phase 5: identity training
# ---------------------------------------------------------------------------


def train_config(**overrides):
    from nphm_tpu_torch.config import load_yaml

    cfg = load_yaml(os.path.join(ROOT, "configs", "nphm.yaml"))
    cfg["training"].update(overrides)
    return cfg


def identity_sets(n_train: int, n_val: int, batch: int):
    from nphm_tpu_torch.data.synthetic import SyntheticIdentityDataset

    kw = dict(n_face=750, n_non_face=250, n_anchors=39, batch_size=batch)
    return (SyntheticIdentityDataset(n_subjects=n_train, seed=SEED, **kw),
            SyntheticIdentityDataset(n_subjects=n_val, seed=SEED + 5, **kw))


class _History:
    """Quiet metrics logger that keeps every epoch's record."""

    def __init__(self):
        self.records = []

    def log(self, metrics, step=None):
        self.records.append(dict(metrics, epoch=step))

    def print(self, msg):
        log(f"[train] {msg}")


def _timed_val_steps(trainer):
    """Wrap the trainer's validation step with a synchronised host clock."""
    import torch

    times = []
    inner = trainer._val_step

    def timed(batch, lr_lat):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(batch, lr_lat)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    trainer._val_step = timed
    return times


def train_path(models, device):
    """Stage-1 training at the widths of configs/nphm.yaml through
    ``IdentityTrainer.train_model``: 64 synthetic subjects in batches of 32
    (750 face / 250 non-face points a row), 4 validation subjects, 3
    epochs with the checkpoint and reconstruction logging (res 128) at
    epoch 0; then a fresh trainer resumes from that checkpoint for one
    epoch, which must repeat the first run's epoch 1."""
    import numpy as np

    from nphm_tpu_torch.training.trainer import IdentityTrainer

    shape, params_shape = models[0], models[1]
    train_ds, val_ds = identity_sets(64, 4, 32)
    with tempfile.TemporaryDirectory() as tmp:
        hist = _History()
        tr = IdentityTrainer(shape, params_shape, train_config(), train_ds, val_ds, "smoke",
                             exp_dir=tmp, logger=hist, recon_resolution=128, seed=SEED,
                             device=device)
        expect(tr._fields_fn is not None, "the trainer did not route to K5/K6")
        val_times = _timed_val_steps(tr)
        reset_counters()
        t0 = time.perf_counter()
        tr.train_model(3)
        t_train = time.perf_counter() - t0
        counts = read_counters()
        recs = sorted(os.listdir(os.path.join(tmp, "smoke", "recs", "epoch_0")))
        ckpts = sorted(os.listdir(os.path.join(tmp, "smoke", "checkpoints")))

        hist2 = _History()
        tr2 = IdentityTrainer(shape, params_shape, train_config(), train_ds, val_ds,
                              "smoke", exp_dir=tmp, logger=hist2, recon_resolution=128,
                              seed=SEED + 1, device=device)
        tr2.train_model(2)
    steps = [1e3 * t for t in tr._timer.times]
    losses = [r["loss"] for r in hist.records]
    log(f"[train] 3 epochs x 2 steps of B=32 rows x 1693 points in {t_train:.2f} s; "
        f"train step ms {[round(t, 3) for t in steps]} (steady mean "
        f"{float(np.mean(steps[1:])):.3f} ms, first step excluded); validation step ms "
        f"{[round(1e3 * t, 3) for t in val_times]}; loss per epoch {losses}; val loss "
        f"per epoch {[r['val_loss'] for r in hist.records]}")
    log(f"[train] epoch-0 exports: {recs}; checkpoints: {ckpts}")
    log(f"[counters] training path: {json.dumps(counts)}")
    for name in ("train_fwd", "train_bwd", "ensemble_sdf"):
        expect(counts[name] > 0, f"kernel {name} was not launched on the training path")
    expect(len(hist.records) == 3 and all(np.isfinite(losses)), "training losses not finite")
    expect(len(recs) == 4 and ckpts == ["checkpoint_epoch_0.pkl"],
           "epoch-0 reconstructions or checkpoint missing")
    expect([r["epoch"] for r in hist2.records] == [1], "the resumed run did not run epoch 1")
    resumed, first = hist2.records[0]["loss"], hist.records[1]["loss"]
    log(f"[train] resumed from epoch 0: epoch-1 loss {resumed!r} vs uninterrupted "
        f"{first!r}")
    expect(abs(resumed - first) <= 1e-6 * abs(first), "the resumed epoch 1 differs")
    check_train_reference(models, device)
    return counts


def check_train_reference(models, device):
    """A 3-step training run through K5/K6 against the same run on the plain
    path (decoder + autograd spatial gradient): same batches, B=4 rows,
    same start.  Compares the change each run made to the params and latent
    tables, and the loss terms."""
    import numpy as np

    from nphm_tpu_torch.training.trainer import IdentityTrainer

    shape, params_shape = models[0], models[1]
    train_ds, val_ds = identity_sets(12, 4, 4)
    keys = ("params", "latents", "latents_val")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for fused in (True, False):
            hist = _History()
            cfg = train_config(fused_train_kernel=fused, ckpt_interval=10**9)
            tr = IdentityTrainer(shape, params_shape, cfg, train_ds, val_ds, f"ref{fused}",
                                 exp_dir=tmp, logger=hist, recon_resolution=32, seed=SEED,
                                 device=device)
            before = {k: _flat_leaves(v) for k, v in tr.state_dict().items() if k in keys}
            tr.train_model(1)
            after = {k: _flat_leaves(v) for k, v in tr.state_dict().items() if k in keys}
            out[fused] = (before, after, hist.records[0])
    (bk, ak, hk), (bp, ap, hp) = out[True], out[False]
    rel, diff = {}, {}
    for key in keys:
        expect(bool(np.array_equal(bk[key], bp[key])), f"the two runs start from different {key}")
        dk, dp = ak[key] - bk[key], ap[key] - bp[key]
        rel[key] = float(np.linalg.norm(dk - dp) / max(np.linalg.norm(dp), 1e-30))
        diff[key] = float(np.abs(ak[key] - ap[key]).max())
    terms = {k: (hk[k], hp[k]) for k in hk
             if k not in ("step_time_s", "steps_per_s", "epoch")}
    rel_terms = max(abs(a - b) / max(abs(b), 1e-12) for a, b in terms.values())
    log(f"[train-check] 3 steps, K5/K6 vs plain path: |d_kernel - d_plain| / |d_plain| "
        + ", ".join(f"{k} {rel[k]:.3e} (tol {TOL_TRAIN_UPDATE[k]:g})" for k in keys) + "; "
        "max|after_kernel - after_plain| " + ", ".join(f"{k} {diff[k]:.3e}" for k in keys)
        + f"; loss terms max relative {rel_terms:.3e} (tol {TOL_TRAIN_TERMS:g})")
    expect(all(rel[k] <= TOL_TRAIN_UPDATE[k] for k in keys),
           "the kernel training run disagrees with the plain-path run")
    expect(rel_terms <= TOL_TRAIN_TERMS, "the kernel training loss terms disagree")


# ---------------------------------------------------------------------------
# Phase 6: the NPM family
# ---------------------------------------------------------------------------


def npm_path(npm, device):
    """The NPM family's fit -> extract -> pose path at the widths of
    configs/npm.yaml and npm_def.yaml, through the port's entry points."""
    import numpy as np
    import torch

    from nphm_tpu_torch.fitting.inference import FittingConfig, _use_fused_search, fit_joint
    from nphm_tpu_torch.ops.trunk import deepsdf_trunk_plain, npm_grid_sdf
    from nphm_tpu_torch.reconstruction.extract import deform_mesh_batch, extract_mesh

    shape, params_shape, expr, params_expr, _gen = npm
    obs = npm_observations()
    cfg = FittingConfig(n_steps=FIT_STEPS, log_every=100, seed=SEED)
    expect(not _use_fused_search(expr, cfg, device),
           "K2's gate let the 8x1024 offsets trunk through")

    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lat_expr, lat_shape, anchors, hist = fit_joint(
        shape, params_shape, expr, params_expr, obs, cfg=cfg, device=device,
        verbose=False,
    )
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    loss = np.asarray(hist["loss"])
    log(f"[npm-fit] {FIT_STEPS} steps in {t_fit:.2f} s; steady {hist['steady_it_s']:.2f} "
        f"it/s (first step {hist['first_step_s']:.2f} s excluded); loss {loss[0]:.5f} -> "
        f"{loss[-1]:.5f}; surface {float(hist['surface'][0]):.5f} -> "
        f"{float(hist['surface'][-1]):.5f}; n_valid {int(hist['n_valid'][0])} -> "
        f"{int(hist['n_valid'][-1])} of {cfg.n_obs_per_batch * cfg.n_points_per_obs}; "
        f"executed Broyden iterations mean {float(np.mean(hist['broyden_iters'])):.2f}")
    expect(anchors is None, "the NPM fit returned anchors")
    expect(bool(np.isfinite(loss).all()), "NPM fit loss history is not finite")
    expect(bool(np.isfinite(lat_shape).all() and np.isfinite(lat_expr).all()),
           "NPM fitted latents are not finite")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mesh, timing = extract_mesh(shape, params_shape, lat_shape, GRID_MIN, GRID_MAX,
                                EXTRACT_RES, device=device, return_timing=True)
    t_ext = time.perf_counter() - t0
    log(f"[npm-extract] res {EXTRACT_RES}: grid eval {timing['grid_s']:.3f} s "
        f"({EXTRACT_RES**3 / timing['grid_s'] / 1e6:.2f} M q/s), marching {timing['march_s']:.3f} "
        f"s, total {t_ext:.3f} s; {len(mesh.vertices)} vertices, {len(mesh.faces)} faces")
    expect(len(mesh.vertices) > 0 and len(mesh.faces) > 0, "NPM mesh is empty")
    expect(bool(np.isfinite(mesh.vertices).all()), "NPM mesh vertices are not finite")

    t0 = time.perf_counter()
    posed = deform_mesh_batch(mesh, expr, params_expr, lat_expr, lat_shape=lat_shape,
                              device=device)
    t_def = time.perf_counter() - t0
    expect(len(posed) == len(obs), "one posed NPM mesh per expression")
    expect(all(np.isfinite(m.vertices).all() for m in posed), "posed NPM vertices not finite")
    moved = float(np.abs(posed[0].vertices - mesh.vertices).max())
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "npm_expr_000.ply")
        posed[0].export(path)
        size = os.path.getsize(path)
    log(f"[npm-deform] {len(posed)} expressions x {len(mesh.vertices)} vertices in "
        f"{t_def:.3f} s (max offset {moved:.4f}); exported one PLY ({size} bytes)")
    counts = read_counters()
    log(f"[counters] NPM path: {json.dumps(counts)}")
    expect(counts["deepsdf_trunk"] > 0, "K7 was not launched on the NPM path")
    expect(counts["broyden_search"] == 0, "K2 was launched on the NPM path")

    lat = torch.tensor(lat_shape, device=device).reshape(-1)
    a = npm_grid_sdf(params_shape, shape.cfg, lat, GRID_MIN, GRID_MAX, 64)
    b = npm_grid_sdf(params_shape, shape.cfg, lat, GRID_MIN, GRID_MAX, 64,
                     trunk_fn=deepsdf_trunk_plain)
    e, scale = k7_error(a, b, params_shape["layers"][-1]["b"])
    log(f"[npm-check] 64^3 NPM grid, K7 vs plain: max|err| {e:.3e}, relative "
        f"{e / max(scale, 1e-30):.3e} (tol {TOL_K7:g}) to the head product's max "
        f"magnitude {scale:.4f}")
    expect(e <= TOL_K7 * scale, "the NPM grid through K7 disagrees with its plain version")
    return counts


def _flat_leaves(tree):
    import numpy as np

    return np.concatenate([np.ravel(x) for x in _leaves(tree)]).astype(np.float64)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def run():
    import torch

    smi = device_and_build()
    device = torch.device("cuda", 0)
    models = build_models(device)
    npm = build_npm_models(device)
    rows = kernel_checks(models, npm, device)
    fit_counts = main_path(models, device)
    train_counts = train_path(models, device)
    npm_counts = npm_path(npm, device)
    table = []
    for name, (source, replaces) in KERNELS.items():
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces,
                      "launches": fit_counts[name] + train_counts[name] + npm_counts[name],
                      "library_ms": None, **rows[name]})
    log(smi)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


def main():
    sys.path.insert(0, ROOT)
    try:
        run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
