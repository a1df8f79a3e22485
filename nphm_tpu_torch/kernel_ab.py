"""Time the fit kernels K3/K4, the training forward K5, the training
backward K6, the search K2 or the ensemble grid K1 of two or more
checkouts on one card, in turns.

    python3 -m nphm_tpu_torch.kernel_ab ROOT_A ROOT_B [ROOT_C ...]
        [--kernels fit|train|train_bwd|search|ensemble|low|phases|f32] [--order ABBA]

Each turn runs in a fresh process from one checkout: that checkout's
``chip_smoke.py`` builds its kernels (``device_and_build``) and the NPHM
models (``build_models``), then

- ``--kernels fit`` (default): ``check_k3_k4``, K3 and K4 at the fit's
  shapes (M = 5 x 1024), each against its plain version, timed with CUDA
  events;
- ``--kernels train``: K5 alone at the training batch (B = 32 rows x 1693
  points, padded to 2048, no culling), through ``member_fields`` under
  ``no_grad``, held once against ``member_fields_plain`` and timed with
  CUDA events; no backward runs, so the turn stays far below the ~55 GiB
  peak of ``check_k5_k6``'s plain double backward;
- ``--kernels train_bwd``: K6 at the same shapes, one
  ``torch.autograd.grad`` of <dF, F> + <dG, G> through ``member_fields``
  (random dF, dG) w.r.t. every operand and the coordinates, timed with CUDA
  events; no plain version runs;
- ``--kernels search``: K2 at the fit's shapes (B = 5 obs x N = 1000
  points, ``chip_smoke.search_inputs``), cold at budget 15 from the
  observations and warm at budget 3 from the plain search's cold roots and
  J^-1, on the random-init trunk and with its offset head scaled 90x;
- ``--kernels ensemble``: K1 through ``nphm_grid_sdf`` on the 64^3 and the
  res-256 brick grids (the extraction's launch), cull on;
- ``--kernels low``: K3 to K6 at each precision ("default", "high",
  "bfloat16"): K3 and K4 at the batched fit's launch shape (8 subjects x 5
  scans x 1000 points, Morton-sorted, culled at 1e-10, as
  ``chip_smoke.check_k3_k4_low``), K5 and K6 at the training batch, each
  timed with CUDA events, and each call's device time split by CUDA kernel
  (``torch.profiler``, the mean of 3 calls), so a kernel made of several
  launches (K6: its two passes, the lane contraction, the fixed-order sums)
  shows where its time goes.  No plain version runs;
- ``--kernels phases``: K4 and K5 at "default" and "bfloat16" at the shapes
  of ``low``, each turn from a copy of its checkout whose kernels are built
  with ``NPHM_PHASE_CLOCKS`` (``csrc/tc_tile.cuh``'s ``PhaseClock``: thread
  0 of each block adds the clock64 cycles of each phase, the cycles it
  waits on weight slices and the blocks to counters the probe reads), so
  each call's block time splits by phase: setup, layer 0, the forward
  products, the bias pass, the softplus' sweep, the head and seed pass,
  the reverse bias and point sums, the reverse products and the tail (the
  probe adds a block barrier after the bias pass and after the reverse
  sums, so that each phase is closed);
- ``--kernels f32``: the F32 rows outside K3-K6 and the F32 main path, each
  through the checkout's own ``chip_smoke`` helpers (so each against its
  plain version): K1 on the 64^3 and res-256 brick grids (``check_k1``),
  K7 on the NPM res-256 grid (``check_k7``), on one 65 536-point chunk of
  the res-256 brick grid under the NPHM compress field (the backward
  warp's launch), on a 65 536-point posing chunk under a GNN field and on
  3 876 864 grid points of the NPM identity trunk (the size of the NPM
  sparse fine pass), and the identity trainer's step (B = 32, K5/K6; the
  median of 5 after 2) and a PRECISION_FIT_STEPS-step batched fit (8
  subjects, K2-K4; ms per subject-step, steady) at "default".

Its rows print as one ``ROWS {...}`` JSON line; the summary gives each
checkout's mean kernel times and the ratio A / B.  Comparing two versions is
only fair within one call on one card, in turns (A, B, B, A by default;
with more than two checkouts each runs once, in order, by default).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

_HEAD = """
import json, sys, torch
sys.path.insert(0, {root!r})
import chip_smoke as c
c.device_and_build()
dev = torch.device("cuda", 0)
shape, params, _e, _pe, gen = c.build_models(dev)
"""

_FIT = """
rows = {{}}
c.check_k3_k4(shape, params, gen, dev, rows)
print("ROWS " + json.dumps(rows), flush=True)
"""

# the training batch of check_k5_k6 (B = 32 rows x 1693 points padded to
# 2048, no culling): coords, the folded operands and the cull mask
_TRAIN_INPUTS = """
from nphm_tpu_torch.models.ensemble import mirror_scale, predict_anchors
from nphm_tpu_torch.ops.fit_fields import active_mask, prepare_train_operands
from nphm_tpu_torch.ops.train_fields import _flat, _unflat, member_fields, member_fields_plain

cfg, B, tile, A = shape.cfg, 32, 512, shape.cfg.n_members
xyz = torch.tensor(c.train_batch(B, c.SEED + 4), device=dev)
N = xyz.shape[1]
Np = -(-N // tile) * tile
xyz = torch.cat([xyz, xyz[:, -1:].expand(B, Np - N, 3)], dim=1)
lat = (torch.randn((B, cfg.lat_dim), generator=gen) * 0.1).to(dev)
with torch.no_grad():
    anchors = predict_anchors(params, cfg, lat)
    centers = torch.cat([anchors, torch.zeros_like(anchors[:, :1])], dim=1)
    coords = (xyz[:, :, None] - centers[:, None]) * mirror_scale(cfg, dev)
    coords = coords.permute(2, 3, 0, 1).reshape(A, 3, B * Np).contiguous()
    layers, _ = prepare_train_operands(params, cfg, lat)
    active = active_mask(cfg, coords, tile, 0.0)
"""

_TRAIN = _TRAIN_INPUTS + """
with torch.no_grad():
    F, G = member_fields(cfg, layers, coords, active, tile, B)
Fp, Gp = member_fields_plain(cfg, layers, coords, active, tile, B)
err = max(float((F - Fp).abs().max()), float((G - Gp).detach().abs().max()))
del Fp, Gp
torch.cuda.empty_cache()
with torch.no_grad():
    ms = c.cuda_ms(lambda: member_fields(cfg, layers, coords, active, tile, B), 5)
print(f"[K5] M={{B}}x{{Np}}: kernel {{ms:.3f}} ms; F, G max|err| {{err:.3e}} vs plain",
      flush=True)
print("ROWS " + json.dumps({{"train_fwd": {{"ms": ms, "max_abs_err": err}}}}), flush=True)
"""

_TRAIN_BWD = _TRAIN_INPUTS + """
flat = [t.detach().clone().requires_grad_(True) for t in _flat(cfg, layers)]
coords.requires_grad_(True)
ins = flat + [coords]
dF = torch.randn((A, B * Np), generator=gen).to(dev)
dG = torch.randn((A, 3, B * Np), generator=gen).to(dev)
F, G = member_fields(cfg, _unflat(cfg, flat), coords, active, tile, B)
phi = (F * dF).sum() + (G * dG).sum()
ms = c.cuda_ms(lambda: torch.autograd.grad(phi, ins, retain_graph=True), 5)
print(f"[K6] M={{B}}x{{Np}}: kernel {{ms:.3f}} ms", flush=True)
print("ROWS " + json.dumps({{"train_bwd": {{"ms": ms}}}}), flush=True)
"""

_SEARCH = """
from nphm_tpu_torch.ops.search import broyden_search, broyden_search_plain

obs, cond, eye = c.search_inputs(shape, params, _e, _pe, gen, dev, 5, 1000)
tcfg, base = _e.cfg.trunk_cfg, _pe["trunk"]
hard = {{"layers": base["layers"][:-1] + [
    {{k: v * 90.0 for k, v in base["layers"][-1].items()}}]}}
rows = {{}}
for tag, trunk in (("search_init", base), ("search_x90", hard)):
    cold = broyden_search_plain(trunk, tcfg, cond, obs, obs, eye, 15)
    x0, j0 = cold["result"], cold["j_inv"]
    ms15 = c.cuda_ms(lambda: broyden_search(trunk, tcfg, cond, obs, obs, eye, 15), 10)
    ms3 = c.cuda_ms(lambda: broyden_search(trunk, tcfg, cond, obs, x0, j0, 3), 10)
    print(f"[K2] {{tag}}: cold budget 15 {{ms15:.3f}} ms, warm budget 3 {{ms3:.3f}} ms",
          flush=True)
    rows[tag + "_15"] = {{"ms": ms15}}
    rows[tag + "_3"] = {{"ms": ms3}}
print("ROWS " + json.dumps(rows), flush=True)
"""

_ENSEMBLE = """
from nphm_tpu_torch.ops.ensemble import nphm_grid_sdf

lat = (torch.randn(shape.cfg.lat_dim, generator=gen) * 0.1).to(dev)
rows = {{}}
for res, reps in ((64, 10), (256, 3)):
    ms = c.cuda_ms(lambda: nphm_grid_sdf(params, shape.cfg, lat, c.GRID_MIN, c.GRID_MAX,
                                         res), reps)
    print(f"[K1] res-{{res}} brick grid: {{ms:.3f}} ms", flush=True)
    rows[f"ensemble_{{res}}"] = {{"ms": ms}}
print("ROWS " + json.dumps(rows), flush=True)
"""

# K3/K4's batched fit launch (8 subjects x 5 scans x 1000 points,
# Morton-sorted, as chip_smoke.check_k3_k4_low) beside the training batch,
# and each kernel's calls at one precision: k3..k6 (K4 and K6 over their
# forward's outputs)
_LOW_INPUTS = _TRAIN_INPUTS + """
import numpy as np

from nphm_tpu_torch.ops import precision
from nphm_tpu_torch.ops.fit_fields import member_f, morton_codes

Bf, S, Nf = 5 * c.BATCH_SUBJECTS, c.BATCH_SUBJECTS, 1000
xf = torch.tensor(np.stack(c.observations(Bf, Nf, c.SEED + 2)), device=dev)
latf = (torch.randn((S, cfg.lat_dim), generator=gen) * 0.01).to(dev)
latf = latf.repeat_interleave(Bf // S, dim=0).contiguous()
perm = torch.argsort(morton_codes(xf), dim=1, stable=True)
xf = torch.gather(xf, 1, perm[..., None].expand(Bf, Nf, 3))
Npf = -(-Nf // tile) * tile
xf = torch.cat([xf, xf[:, -1:].expand(Bf, Npf - Nf, 3)], dim=1)
Mf = Bf * Npf
_, skip = cfg.layer_shapes
dFf = torch.randn((A, Mf), generator=gen).to(dev)
dF = torch.randn((A, B * Np), generator=gen).to(dev)
dG = torch.randn((A, 3, B * Np), generator=gen).to(dev)


def calls():
    lf = latf.clone().requires_grad_(True)
    anch = predict_anchors(params, cfg, lf)
    cen = torch.cat([anch, torch.zeros_like(anch[:, :1])], dim=1)
    cf = (xf[:, :, None] - cen[:, None]) * mirror_scale(cfg, dev)
    cf = cf.permute(2, 3, 0, 1).reshape(A, 3, Mf).detach().requires_grad_(True)
    lay_f, _ = prepare_train_operands(params, cfg, lf)
    act_f = active_mask(cfg, cf, tile, 1e-10)
    ins_f = (lay_f[0]["b"], lay_f[skip]["b"], cf)
    Fk = member_f(cfg, lay_f, cf, act_f, tile, Bf)
    flat = [t.detach().clone().requires_grad_(True) for t in _flat(cfg, layers)]
    cc = coords.detach().clone().requires_grad_(True)
    ins = flat + [cc]
    F, G = member_fields(cfg, _unflat(cfg, flat), cc, active, tile, B)
    phi = (F * dF).sum() + (G * dG).sum()
    return (lambda: member_f(cfg, lay_f, cf, act_f, tile, Bf),
            lambda: torch.autograd.grad(Fk, ins_f, dFf, retain_graph=True),
            lambda: member_fields(cfg, _unflat(cfg, flat), cc, active, tile, B),
            lambda: torch.autograd.grad(phi, ins, retain_graph=True))
"""

_LOW = _LOW_INPUTS + """
import re

from torch.profiler import ProfilerActivity, profile


def split_ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {{}}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or 0
        if t > 0:
            m = re.search(r"([A-Za-z_]\\w*)(<[^()]*>)?\\(", e.key)
            key = m.group(1) + (m.group(2) or "") if m else e.key[:48]
            out[key] = round(out.get(key, 0.0) + t / 1e3 / reps, 4)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


rows = {{}}
for name in ("default", "high", "bfloat16"):
    with precision.matmul_precision(name):
        k3, k4, k5, k6 = calls()
        with torch.no_grad():
            ms3 = c.cuda_ms(k3, 10)
            sp3 = split_ms(k3)
        ms4 = c.cuda_ms(k4, 10)
        sp4 = split_ms(k4)
        with torch.no_grad():
            ms5 = c.cuda_ms(k5, 5)
            sp5 = split_ms(k5)
        ms6 = c.cuda_ms(k6, 5)
        sp6 = split_ms(k6)
        del k3, k4, k5, k6
    for k, ms, sp in (("fit_fwd", ms3, sp3), ("fit_bwd", ms4, sp4), ("train_fwd", ms5, sp5),
                      ("train_bwd", ms6, sp6)):
        rows[f"{{k}}@{{name}}"] = {{"ms": ms, "split_ms": sp}}
        print(f"[K3] {{k}} at {{name}}: {{ms:.3f}} ms; device split {{json.dumps(sp)}}",
              flush=True)
print("ROWS " + json.dumps(rows), flush=True)
"""

# K4 and K5 at F32 and BF16 built with NPHM_PHASE_CLOCKS (csrc/tc_tile.cuh
# PhaseClock): each block's cycles per phase, the mean over the live blocks
_PHASES = _LOW_INPUTS + """
import ctypes

from nphm_tpu_torch.ops import _build

PHASES = ("setup", "layer0", "fwd_products", "bias", "sweep", "head", "rev_sums",
          "rev_products", "tail")


def per_block(entry, fn, reps):
    fn()
    torch.cuda.synchronize()
    out = (ctypes.c_ulonglong * 16)()
    read = getattr(_build.lib(), entry)
    _build.check(read(out, 1), entry)
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    _build.check(read(out, 1), entry)
    blocks = max(out[15], 1)
    cyc = {{p: out[i] / blocks for i, p in enumerate(PHASES)}}
    cyc["ring_wait_thread0"] = out[14] / blocks
    cyc["block"] = sum(out[i] for i in range(len(PHASES))) / blocks
    cyc["blocks_per_call"] = out[15] / reps
    return cyc


rows = {{}}
for name in ("default", "bfloat16"):
    with precision.matmul_precision(name):
        k3, k4, k5, k6 = calls()
        ms4 = c.cuda_ms(k4, 5)
        ph4 = per_block("nphm_fit_phase_cycles", k4, 3)
        with torch.no_grad():
            ms5 = c.cuda_ms(k5, 3)
            ph5 = per_block("nphm_train_phase_cycles", k5, 2)
        del k3, k4, k5, k6
    for k, ms, ph in (("fit_bwd", ms4, ph4), ("train_fwd", ms5, ph5)):
        r = rows[f"{{k}}@{{name}}"] = {{"ms": ms, "phases": {{p: round(v, 1)
                                                            for p, v in ph.items()}}}}
        print(f"[K4] {{k}} at {{name}}: {{ms:.3f}} ms; cycles a block "
              f"{{json.dumps(r['phases'])}}", flush=True)
print("ROWS " + json.dumps(rows), flush=True)
"""

_F32 = """
import statistics
import tempfile
import time

from nphm_tpu_torch.fitting import FittingConfig, fit_joint_batch
from nphm_tpu_torch.models.deformation import conditioning
from nphm_tpu_torch.models.ensemble import predict_anchors
from nphm_tpu_torch.ops.ensemble import DEFAULT_TILE, _brick_points, grid_axes, grid_tile
from nphm_tpu_torch.training.trainer import IdentityTrainer

models = (shape, params, _e, _pe, gen)
npm = c.build_npm_models(dev)
rows = {{}}
c.check_k1(shape, params, gen, dev, rows)
c.check_k7(models, npm, dev, rows)


def cond_of(p_shape, p_expr, expr):
    lat_s = (torch.randn((1, shape.lat_dim), generator=gen) * 0.01).to(dev)
    lat_e = (torch.randn((1, expr.lat_dim), generator=gen) * 0.01).to(dev)
    with torch.no_grad():
        anchors = predict_anchors(p_shape, shape.cfg, lat_s)
        return conditioning(p_expr, expr.cfg, torch.cat([lat_s, lat_e], -1), anchors)[0]


res = 256
tile, brick = grid_tile(res, DEFAULT_TILE)
axes = grid_axes(c.GRID_MIN, c.GRID_MAX, res, dev)
warp = _brick_points(axes, torch.arange(1 << 16, device=dev), res, brick, tile)
rows["deepsdf_trunk@warp"] = c.k7_launch_row(
    _pe["trunk"], _e.cfg.trunk_cfg, warp, cond_of(params, _pe, _e),
    "warp (one 65536-point chunk)", reps=5)
g_shape, g_ps, g_e, g_pe, _g = c.build_mode_models(models, dev)["GNN"]
pose = torch.tensor(c.observations(1, c.K7_POSE_POINTS, c.SEED + 22)[0], device=dev)
rows["deepsdf_trunk@gnn_pose"] = c.k7_launch_row(
    g_pe["trunk"], g_e.cfg.trunk_cfg, pose, cond_of(g_ps, g_pe, g_e),
    "GNN 6x512, posing chunk", 5)
n_shape, n_ps = npm[0], npm[1]
fine = _brick_points(axes, torch.arange(3876864, device=dev), res, brick, tile)
n_lat = (torch.randn(n_shape.lat_dim, generator=gen) * 0.01).to(dev)
rows["deepsdf_trunk@npm_sparse_fine"] = c.k7_launch_row(
    n_ps, n_shape.cfg, fine, n_lat, "npm_sparse_fine size (3876864 grid points)", reps=3)
del warp, pose, fine
torch.cuda.empty_cache()

train_ds, val_ds = c.identity_sets(32, 2, 32)
batch = next(iter(train_ds.batch_iter(seed=0)))
with tempfile.TemporaryDirectory() as tmp:
    tr = IdentityTrainer(shape, params, c.train_config(matmul_precision="default"), train_ds,
                         val_ds, "precision", exp_dir=tmp, logger=c._History(), seed=c.SEED,
                         device=dev)
    steps = []
    for i in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr._train_step(tr._batch(batch), tr.lr_at(0), tr.lr_lat_at(0))
        torch.cuda.synchronize()
        steps.append(1e3 * (time.perf_counter() - t0))
step_ms = statistics.median(steps[2:])
fcfg = FittingConfig(n_steps=c.PRECISION_FIT_STEPS, seed=c.SEED, matmul_precision="default")
_le, _ls, _, hist = fit_joint_batch(shape, params, _e, _pe, c.batch_observations(), cfg=fcfg,
                                    device=dev, verbose=False)
sps = float(hist["steady_subject_steps_s"])
print(f"[f32] identity step (B=32): median {{step_ms:.3f}} ms of steps 3-7 "
      f"({{', '.join(f'{{t:.2f}}' for t in steps)}}); batched fit "
      f"{{c.PRECISION_FIT_STEPS}} steps: {{sps:.2f}} subject-steps/s", flush=True)
rows["identity_step"] = {{"ms": step_ms}}
rows["batched_fit"] = {{"ms": 1e3 / sps}}
print("ROWS " + json.dumps(rows), flush=True)
"""

KERNELS = {"fit": (_FIT, ("fit_fwd", "fit_bwd")), "train": (_TRAIN, ("train_fwd",)),
           "train_bwd": (_TRAIN_BWD, ("train_bwd",)),
           "search": (_SEARCH, ("search_init_15", "search_init_3", "search_x90_15",
                                "search_x90_3")),
           "ensemble": (_ENSEMBLE, ("ensemble_64", "ensemble_256")),
           "phases": (_PHASES, tuple(f"{k}@{p}" for p in ("default", "bfloat16")
                                     for k in ("fit_bwd", "train_fwd"))),
           "low": (_LOW, tuple(f"{k}@{p}" for p in ("default", "high", "bfloat16")
                               for k in ("fit_fwd", "fit_bwd", "train_fwd", "train_bwd"))),
           "f32": (_F32, ("ensemble_sdf", "ensemble_sdf@res256", "deepsdf_trunk",
                          "deepsdf_trunk@warp", "deepsdf_trunk@gnn_pose",
                          "deepsdf_trunk@npm_sparse_fine", "identity_step", "batched_fit"))}


def phase_clock_copy(root: str, dst: str) -> str:
    """A copy of checkout ``root`` at ``dst`` whose kernels build with
    NPHM_PHASE_CLOCKS defined (and nothing built yet)."""
    shutil.copytree(root, dst, ignore=shutil.ignore_patterns(
        "_build", "_archive", ".git", "__pycache__"))
    header = os.path.join(dst, "nphm_tpu_torch", "csrc", "tc_tile.cuh")
    with open(header) as f:
        src = f.read()
    with open(header, "w") as f:
        f.write("#define NPHM_PHASE_CLOCKS 1\n" + src)
    return dst


def run_turn(root: str, body: str, log_path: str | None = None) -> dict:
    proc = subprocess.run([sys.executable, "-c", (_HEAD + body).format(root=root)],
                          cwd=root, capture_output=True, text=True)
    if log_path is not None:
        with open(log_path, "w") as f:
            f.write(proc.stdout + proc.stderr)
    for line in proc.stdout.splitlines():
        if line.startswith(("[K1", "[K2]", "[K3]", "[K4]", "[K5]", "[K6]", "[K7", "[f32]")):
            print(f"  {line}", flush=True)
        if line.startswith("ROWS "):
            return json.loads(line[5:])
    raise RuntimeError(f"turn in {root} failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", help="checkouts A, B, C, ... (at least two)")
    ap.add_argument("--kernels", choices=sorted(KERNELS), default="fit")
    ap.add_argument("--log", default=None,
                    help="directory for each turn's whole output (the build's ptxas report)")
    ap.add_argument("--order", default=None,
                    help="turns by letter (default ABBA for two checkouts, else ABC...)")
    args = ap.parse_args(argv)
    if len(args.roots) < 2:
        ap.error("give at least two checkouts")
    letters = "ABCDEFGH"[: len(args.roots)]
    roots = {t: os.path.abspath(r) for t, r in zip(letters, args.roots)}
    if args.kernels == "phases":
        with tempfile.TemporaryDirectory(prefix="phase_clocks_") as tmp:
            return run(args, {t: phase_clock_copy(r, os.path.join(tmp, t))
                              for t, r in roots.items()})
    return run(args, roots)


def run(args, roots: dict) -> int:
    """The turns of ``main`` over the checkouts ``roots`` (letter: path)."""
    body, names = KERNELS[args.kernels]
    letters = "".join(roots)
    order = args.order or ("ABBA" if len(roots) == 2 else letters)
    times = {t: [] for t in roots}
    last = {}
    if args.log:
        os.makedirs(args.log, exist_ok=True)
    for i, turn in enumerate(order):
        print(f"[ab] turn {turn}: {roots[turn]}", flush=True)
        rows = run_turn(roots[turn], body,
                        os.path.join(args.log, f"turn{i}_{turn}.log") if args.log else None)
        times[turn].append({k: rows[k]["ms"] for k in names})
        last[turn] = {key: {k: rows[k][key] for k in names if key in rows[k]}
                      for key in ("split_ms", "phases")}
    means = {t: {k: sum(r[k] for r in rs) / len(rs) for k in names}
             for t, rs in times.items() if rs}
    summary = {"turns": times, "mean_ms": means}
    if times["A"] and times["B"]:
        summary["ratio_a_over_b"] = {k: means["A"][k] / means["B"][k] for k in names}
    for key in ("split_ms", "phases"):
        per = {t: r[key] for t, r in last.items()}
        if any(per.values()):
            summary[key] = per
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
