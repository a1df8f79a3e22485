#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nphm_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Device and build: require CUDA, print the card's name and power limit,
   build every kernel from ``nphm_tpu_torch/csrc`` with nvcc, and the host
   marching library from ``csrc`` (so phase 4 times marching, not its build).
2. Models at production dims: the NPHM ensemble of ``configs/nphm.yaml``
   and the compress-mode deformation field of ``configs/nphm_def.yaml``,
   initialised from a seeded ``torch.Generator``; mean anchors are the
   seeded unit-sphere fallback (no assets needed).
3. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes, with its tolerance, and both timed with CUDA events.
4. The main path through the port's entry points: ``fit_joint`` on
   synthetic single-view observations, ``extract_mesh`` at res 256,
   ``deform_mesh_batch`` over the fitted expressions and one PLY export.
   Every kernel's launch counter must move during this phase.  Then a
   5-step fit through the kernels is held against the same fit on the
   plain torch path (same draws).

The second-to-last line is the kernel table as JSON, the last line the
device record as JSON.  Nothing here imports JAX.
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

# Tolerances of kernel vs plain version (fp32 both; only summation order
# and FMA contraction differ, amplified through 4-7 layers).
TOL_K1 = 1e-4  # SDF, absolute
TOL_K2_X = 1e-4  # roots, absolute, lanes valid in both
TOL_K2_J = 1e-2  # J^-1 entries, absolute, lanes valid in both (secant divides)
TOL_K2_NVALID = 0.005  # |n_valid difference| / lanes
TOL_K3 = 1e-4  # F, absolute
TOL_K4 = 1e-4  # gradients, relative to the plain version's max magnitude
# 5-step fit, kernels vs plain path: Adam amplifies ordering noise
TOL_FIT_RTOL, TOL_FIT_ATOL = 1e-3, 5e-4

KERNELS = {
    "ensemble_sdf": ("nphm_tpu_torch/csrc/ensemble_sdf.cu",
                     "nphm_tpu/ops/pallas_ensemble.py:406"),
    "broyden_search": ("nphm_tpu_torch/csrc/broyden_search.cu",
                       "nphm_tpu/ops/pallas_search.py:389"),
    "fit_fwd": ("nphm_tpu_torch/csrc/fit_fields.cu",
                "nphm_tpu/ops/pallas_train.py:707"),
    "fit_bwd": ("nphm_tpu_torch/csrc/fit_fields.cu",
                "nphm_tpu/ops/pallas_train.py:758"),
}


class SmokeFailure(RuntimeError):
    pass


def expect(ok: bool, what: str):
    if not ok:
        raise SmokeFailure(what)


def log(msg: str):
    print(msg, flush=True)


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
    from nphm_tpu.ops.native import get_lib

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


def observations(n_obs: int, n_pts: int, seed: int):
    """Sphere of radius 0.4 warped per observation by a seeded nonrigid warp."""
    import numpy as np

    from nphm_tpu.data.dummy import _nonrigid_warp

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
    log(f"[K1] 64^3 brick grid, cull on: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    rows["ensemble_sdf"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


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

    from nphm_tpu_torch.ops.search import broyden_search, broyden_search_plain

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
    log(f"[K2] B=5 N=1000 budget 15: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    rows["broyden_search"] = dict(max_abs_err=err_x, ms=ms, plain_ms=plain_ms)


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
    log(f"[K3] M=5x1024: kernel {ms3:.3f} ms, plain {plain3:.3f} ms")
    log(f"[K4] M=5x1024: kernel {ms4:.3f} ms, plain backward {plain4:.3f} ms")
    rows["fit_fwd"] = dict(max_abs_err=e3, ms=ms3, plain_ms=plain3)
    rows["fit_bwd"] = dict(max_abs_err=e4, ms=ms4, plain_ms=plain4)


def kernel_checks(models, device):
    shape, params_shape, expr, params_expr, gen = models
    rows = {}
    check_k1(shape, params_shape, gen, device, rows)
    check_k2(shape, params_shape, expr, params_expr, gen, device, rows)
    check_k3_k4(shape, params_shape, gen, device, rows)
    return rows


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------


def reset_counters():
    from nphm_tpu_torch.ops.ensemble import nphm_sdf
    from nphm_tpu_torch.ops.fit_fields import member_f
    from nphm_tpu_torch.ops.search import broyden_search

    nphm_sdf.launches = 0
    broyden_search.launches = 0
    member_f.launches = 0
    member_f.bwd_launches = 0


def read_counters():
    from nphm_tpu_torch.ops.ensemble import nphm_sdf
    from nphm_tpu_torch.ops.fit_fields import member_f
    from nphm_tpu_torch.ops.search import broyden_search

    return {
        "ensemble_sdf": nphm_sdf.launches,
        "broyden_search": broyden_search.launches,
        "fit_fwd": member_f.launches,
        "fit_bwd": member_f.bwd_launches,
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
    log(f"[counters] {json.dumps(counts)}")
    for name, n in counts.items():
        expect(n > 0, f"kernel {name} was not launched on the main path")
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


def run():
    import torch

    smi = device_and_build()
    device = torch.device("cuda", 0)
    models = build_models(device)
    rows = kernel_checks(models, device)
    counts = main_path(models, device)
    table = []
    for name, (source, replaces) in KERNELS.items():
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": counts[name], **rows[name]})
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
