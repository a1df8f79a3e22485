#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nphm_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --dp    # phase 13 alone, on every card up to 4

Phases, in order; any failure exits non-zero:

1. Device and build: require CUDA, print the card's name and power limit,
   build every kernel from ``nphm_tpu_torch/csrc`` with nvcc (the SASS of
   the product kernels of K1-K7 must hold tensor-core instructions),
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
   from the inputs of the timed run: 3xTF32 tensor-core operations (their
   fp32 figure in the log).  Each is also timed against the PyTorch calls
   cuBLAS would run for its products (``library_ms``): one ``torch.addmm``
   per layer for K7, one ``torch.baddbmm`` per layer and pass over the
   member axis for K1 and K3-K6.  K2, an iterative search, has none; the
   log gives an ``addmm`` chain over as many trunk evaluations as its timed
   search ran, for information.  K1 and K2 are also timed at the shapes the
   main paths launch them at (the res-256 grid; the warm budget and a hard
   trunk), and two calls of K1, K2 and K6 must be bit-identical.
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
7. The batched fit and the fitting CLI (NPHM models of phase 2): K2, K3
   and K4 at the batched launch shapes (8 subjects x 5 scans = 40 rows of
   1000 points, K2's lanes padded per subject) against their plain
   versions, timed and bounded; ``fit_joint_batch`` on 8 subjects of 20
   scans x 2500 points for 300 steps (K2-K4's counters must move), then 5
   batched steps through the kernels against the plain path on the same
   draws from seeded shape codes, and two subjects through ``fit_joint``
   on their draws against the batched fit.  Then ``python -m nphm_tpu_torch.fitting_pointclouds``
   in a child process on a dummy tree with port checkpoints of the phase-2
   models: ``-demo -batch_subjects 2 -n_steps 50 -resolution 256`` and
   ``-sample -n_samples 1``; every PLY and latent file must exist with a
   non-empty mesh, ``FIT_PHASE_TIMINGS`` must parse, and the child's K1,
   K2, K3, K4 and K7 counters must move.
8. Streamed, sparse and backward-warp extraction on the fitted codes of
   phases 4 (NPHM) and 6 (NPM) at res 256: dense at tile 1024 (K1's or
   K7's grid copied once, cast to f16 on the host for the f16 case, as the
   CPU tests build it), ``extract_mesh_streamed`` (8 slabs, tile 1024) and
   ``extract_mesh_sparse`` (``lip="auto"``) must emit array-equal sorted
   vertex sets with f32 and f16 copies, both families (an NPM decoder's
   streamed call falls back to the f32 dense path, as in the JAX package,
   and is held against the f32 mesh); the streamed path must launch K1
   once per slab and the sparse path once per pass.  The NPHM sparse path
   at the fitting CLI's ``lip=2.0`` (f16) must skip blocks in its coarse
   pass, raise no warning and emit the dense f16 mesh.  Times of dense
   ``extract_mesh``, the streamed path (8 slabs, f32 and f16) and the
   sparse path (f16, lip auto and 2.0) in this run (NPM: dense and
   sparse), with the sparse candidate and transfer counts.  K1 at its new
   launch shapes (one x-slab at the streamed default tile 2048, the
   sparse coarse pass, the candidate blocks' fine pass at lip auto and at
   lip 2.0, the res-64 Lipschitz probe) and K7 at its new ones (one
   65536-point warp chunk, the NPM candidate blocks' fine pass) against
   their plain versions, timed and bounded; each row's launches are
   counted where that shape is launched (``launches_by_shape``).
   ``backward_grid_logits`` at res 256 (K7 warp, then K1) against
   ``get_logits_backward`` through the plain versions on one slab's
   points, within TOL_K1.
9. The training pipeline through the CLIs, each in a child process on a
   dummy tree of 32 training subjects and 1 validation subject (2
   expressions each), at the widths of ``configs/nphm.yaml`` and
   ``configs/nphm_def.yaml``, 2 epochs, a checkpoint every epoch: ``python
   -m nphm_tpu_torch.train -local`` (K5, K6 and K1's counters must move),
   ``train_corresp -mode compress`` on that experiment (K7 and K1 must
   move; its step times at batch 32 are printed), then
   ``fitting_pointclouds -demo -sparse -batch_subjects 2 -n_steps 50
   -resolution 256`` on both (K1's coarse and fine passes, K2-K4 and K7
   must move).  Each child must exit 0, write both checkpoints and
   non-empty reconstruction logs and meshes.
10. Evaluation and the protocol: ``nearest_neighbors(backend="device")``
   on two seeded 250k-point clouds, both directions, against scipy's
   cKDTree (indices equal but for near-ties, max |dist - scipy| <= NN_TOL,
   the same result with the caller's TF32 flag on), both timed; the render
   samples of a res-128 mesh bit-identical at one rasterizer thread and at
   the default count; then ``python -m nphm_tpu_torch.protocol_e2e`` for
   each family in a child at the configs' widths on a cut scale
   (PROTOCOL_ARGS; NPM's stage 1 at its config's lr for NPM_TRAIN_EPOCHS,
   as 2 epochs leave its field without a zero set), the two children at
   once, each stage a grandchild that reports its launch counters: 0
   crashes, 8 non-empty meshes, every metrics file, both CSVs finite, and
   K5/K6 (stage 1), K2-K4 and K1 (the NPHM fit and its streamed
   extraction) and K7 (posing, the NPM grids) launched.
11. The synthetic quality run: ``python -m nphm_tpu_torch.synthetic_e2e``
   in a child at the production widths (``NPHMConfig()``,
   ``DeformationConfig()``) on a cut schedule (SYNTH_ARGS): stage 1 on 16
   ellipsoid heads, the train subject's reconstruction at res 128 in the
   +-0.7 box, ``fit_identity`` of a held-out head, compress-mode stage 2,
   posing, ``fit_joint`` from posed clouds.  Exit 0, one JSON line with the
   JAX script's keys, every Chamfer finite, the posed mesh closer to the
   posed surface than the neutral one, and K1-K7 launched in the child
   (K5/K6 stage 1, K1 the extractions, K3/K4 both fits, K2 the joint fit,
   K7 the posing).
12. The GNN and interpolate deformation modes: phase 2's NPHM identity
   with a seeded field of each mode at the widths of
   ``configs/nphm_def.yaml`` (GNN conditions the trunk on 400 columns, so
   its third layer is 109 wide).  Under GNN, K2 at the batched shape (40
   rows x 1000) and K7 on a 65 536-point posing chunk against their plain
   versions, timed and bounded.  Per mode: 20 ``DeformationTrainer``
   steps at B=32 x 1000 on ``SyntheticDeformationDataset`` (the loss of a
   fixed batch finite and falling); ``fit_joint_batch`` on 8 subjects x 20 scans x 2500
   points for 50 steps, ``extract_mesh`` at res 256 and
   ``deform_mesh_batch``: GNN must launch K1-K4 and K7 and hold 5 batched
   steps through the kernels against the plain path; interpolate must
   launch K1, K3 and K4 and neither K2 nor K7 (its per-point conditioning
   takes the plain search and posing).  Then ``train_corresp -mode GNN``
   (1 epoch) and ``fitting_pointclouds -demo -batch_subjects 2 -n_steps
   20 -resolution 128`` in children on phase 9's tree: exit 0, non-empty
   meshes, the children's K2 and K7 launched.
13. Data parallelism (``nphm_tpu_torch.parallel``): two ranks spawned on
   card 0 over gloo (NCCL refuses two ranks on one device), each building
   phase 2's models.  3 ``IdentityTrainer`` steps at B=32 (16 rows a rank
   through K5/K6) and a validation step, then the same for the
   compress-mode ``DeformationTrainer``, each against rank 0's
   one-process steps from the same start (TOL_TRAIN_UPDATE,
   TOL_TRAIN_TERMS) with every rank's state bit-equal to rank 0's;
   ``fit_joint_batch(mesh=)`` on phase 7's 8 subjects for 50 steps (4
   subjects a rank through K2-K4) from zero and from phase 7's seeded
   shape codes, their divergence from the one-process fits logged, and 5
   steps from the seeded codes held against one process (TOL_FIT_*, as
   phase 7's kernel check: the shards round in another order, which Adam
   grows over tens of steps); sharded dense ``extract_mesh``, ``extract_mesh_streamed``
   and ``extract_mesh_sparse`` (lip 2.0, f16) on phase 4's code at res 256,
   array-equal to phase 8's one-process meshes (K1 per rank);
   ``deform_mesh_batch(device_mesh=)`` of phase 4's 20 expressions within
   TOL_K7 of the one-process posing (K7 per rank).  Each rank's counters
   must move where its path launches a kernel, and each rank's peak device
   memory, step times and walls are logged beside the one-process ones.
   With two cards or more the same runs over NCCL, one rank a card (up to
   4); with one card the log says NCCL was not run.
14. Matmul precision and remat: each K3-K6 instantiation's registers,
   local bytes, shared memory (held against the host's mirror,
   ``fit_fields.smem_bytes``) and blocks per SM; K3 and K4 at the batched
   launch shape (40 x 1024) and K5, K6 at B=32 x 2048, at TF32 ("high")
   and BF16 ("bfloat16"), each timed beside the F32 instantiation on the
   same inputs (the rows' ``f32_ms`` and ``vs_f32``) and held against its
   plain version at the same precision
   (TOL_LOW, relative to the plain output's magnitude; K5/K6's plain
   versions in member chunks) and nearer to it than to the F32 kernel's
   output on the same inputs, two calls bit-identical, timed beside the
   library call at that precision (``baddbmm`` with TF32 on, or on bf16
   operands) and bounded at one tensor-core pass at that precision's peak
   (TF32, or bf16 for BF16), each BF16 row also beside the TF32 row
   (``tf32_ms``, ``vs_tf32``); two ``IdentityTrainer``
   steps (B=32, the second timed) and a 20-step ``fit_joint_batch`` (8
   subjects) at "default", "high" and "bfloat16" from one start: finite,
   the lower precisions' first-step and final fit losses within
   TOL_LOW_LOSS of F32's, and every precision's instantiation of K3-K6
   launched; the NPM stage 1 at the widths of
   ``configs/npm.yaml`` (B=32) for 3 steps with ``remat`` on and off:
   bit-equal updates, each run's peak device memory and step times logged.

Each kernel's entry in the table holds its launches summed over the
paths of phases 4-14 (phase 13's over its ranks), and under "at" its rows at other shapes (K1 on the
res-256 grid, K2-K4 at the batched shapes; K1 and K7 at phase 8's launch
shapes, each with its own launches in phase 8; K2 and K7 under GNN, with
their launches in phase 12's GNN fit and posing; K3-K6 at TF32 and BF16,
with their instantiations' launches in phase 14's main path).

The second-to-last line is the kernel table as JSON, the last line the
device record as JSON.  Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
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
BATCH_SUBJECTS = 8  # phase 7's batched fit (the JAX package's protocol group)
CLI_STEPS = 50  # phase 7's CLI fit
K7_GRID_POINTS = 1 << 20  # K7's check (a): points of the res-256 grid
K7_MESH_POINTS = 1 << 19  # checks (b), (c): points of a warped sphere

# Tolerances of kernel vs plain version (the kernels' 3xTF32 products keep
# ~2^-21 of each fp32 product; otherwise summation order and FMA
# contraction differ, amplified through 4-7 layers).
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
# std of the shape codes phase 7's 5-step batched checks start from
LAT_INIT_STD = 0.05
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
# TF32 on the tensor cores (K1-K7: 3xTF32, three TF32 products per fp32
# product), bf16 on them (K3-K6 at "bfloat16": the card's peak for bf16
# operands, whatever instruction the kernel issues), fp32 outside them (the
# figure each bound is logged beside), HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12
# Kernels whose products run as 3xTF32 on the tensor cores, and the kernel
# functions (mangled-name fragments) whose SASS must hold HMMA/HGMMA: each
# of K6's product kernels (its fixed-order sums run no product).  Those of
# WGMMA_KERNELS must hold HGMMA (wgmma): K7's layer kernel; the others run
# mma.sync (HMMA).
WGMMA_KERNELS = ("trunk_layer_kernel",)
TENSOR_CORE_KERNELS = {"ensemble_sdf": ("ensemble_sdf_kernel",),
                       "broyden_search": ("broyden_search_kernel",),
                       "fit_fwd": ("fit_fwd_kernel",), "fit_bwd": ("fit_bwd_kernel",),
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


def bound(flops: float, nbytes: float, passes: int = 3,
          peak: float = PEAK_TF32_FLOPS) -> dict:
    """The least time the card could take: the larger of the operations over
    the tensor cores' peak and the bytes (each input read once, each output
    written once) over the memory rate.  flops counts fp32 multiply-adds as
    2; a 3xTF32 kernel runs three TF32 products for each (passes), a kernel
    at a lower precision one, at that precision's peak."""
    t_ops = passes * flops / peak * 1e3
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
        if ("Compiling entry" in line or "registers" in line or "spill" in line
                or "wgmma" in line):
            log(f"[ptxas] {line.strip()}")
    counts = _build.sass_mma_counts()
    for name, fns in TENSOR_CORE_KERNELS.items():
        for fn in fns:
            n = {k: v for k, v in counts.items() if fn in k}
            log(f"[sass] {name}: tensor-core instructions per kernel {json.dumps(n)}")
            expect(bool(n) and all(v["HGMMA"] + v["HMMA"] > 0 for v in n.values()),
                   f"{name}'s SASS holds no tensor-core instruction in {fn}")
            if fn in WGMMA_KERNELS:
                expect(all(v["HGMMA"] > 0 for v in n.values()),
                       f"{name}'s SASS holds no HGMMA (wgmma) in {fn}")
    from nphm_tpu_torch.ops.native import get_lib

    t0 = time.perf_counter()
    get_lib()
    log(f"[build] host library (marching, rasterizer) ready in "
        f"{time.perf_counter() - t0:.2f} s")
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
    """K1 against its plain version on the 64^3 brick grid and on 256k
    random points, culling on and off; timed on the 64^3 grid (the table's
    row, beside its plain version and the ``baddbmm`` chain) and on the
    res-256 extraction grid, K1's launch on the main paths (row
    ``ensemble_sdf@res256``, through ``k1_launch_row``: the plain version
    and the chain over 2^18-point chunks of the brick-ordered grid, whole
    cull tiles, so the plain version culls as on the whole grid; one pass
    holds ~25 GB).  That launch must also be bit-identical to
    ``nphm_grid_sdf``'s."""
    import torch

    from nphm_tpu_torch.ops.ensemble import (
        CULL_EPS,
        DEFAULT_TILE,
        _brick_points,
        _prepare,
        _unbrick_gather,
        grid_axes,
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
        a2 = nphm_grid_sdf(params, cfg, lat, GRID_MIN, GRID_MAX, 64, cull_eps=eps)
        b = nphm_grid_sdf(params, cfg, lat, GRID_MIN, GRID_MAX, 64, cull_eps=eps,
                          sdf_fn=nphm_sdf_plain)
        e_grid = float((a - b).abs().max())
        c = nphm_sdf(params, cfg, pts, lat, cull_eps=eps)
        d = nphm_sdf_plain(params, cfg, pts, lat, cull_eps=eps)
        e_pts = float((c - d).abs().max())
        expect(bool(torch.isfinite(a).all() and torch.isfinite(c).all()), "K1 non-finite")
        log(f"[K1] cull_eps={eps:g}: 64^3 grid max|err| {e_grid:.3e}, 256k points "
            f"max|err| {e_pts:.3e} (tol {TOL_K1:g}); two calls bit-identical")
        expect(e_grid <= TOL_K1 and e_pts <= TOL_K1, "K1 disagrees with its plain version")
        expect(torch.equal(a, a2), "two K1 calls on the same inputs differ")
        err = max(err, e_grid, e_pts)
    ms = cuda_ms(lambda: nphm_grid_sdf(params, cfg, lat, GRID_MIN, GRID_MAX, 64), 5)
    plain_ms = cuda_ms(lambda: nphm_grid_sdf(params, cfg, lat, GRID_MIN, GRID_MAX, 64,
                                             sdf_fn=nphm_sdf_plain), 2)
    lib_ms = baddbmm_chain_ms(cfg, cfg.n_members, 64**3, "f", device, 2)
    # the timed 64^3 grid's live (point, member) pairs, as the kernel culls them
    tile, brick = grid_tile(64, DEFAULT_TILE)
    grid = _brick_points(grid_axes(GRID_MIN, GRID_MAX, 64, device),
                         torch.arange(64**3, device=device), 64, brick, tile)
    with torch.no_grad():
        _, _, _, active = _prepare(params, cfg, grid, lat, tile, CULL_EPS)
    pairs = int(active.sum()) * tile
    flops = 2.0 * nphm_fmas(cfg) * pairs
    b = bound(flops, 64**3 * 16 + weight_bytes(params["ensemble"], cfg) // cfg.n_members
              * cfg.n_loc)
    log(f"[K1] 64^3 brick grid, cull on: kernel {ms:.3f} ms, plain {plain_ms:.3f} "
        f"ms, baddbmm chain (all members, no culling) {lib_ms:.3f} ms; {pairs} live "
        f"(point, member) pairs, {bound_note(flops, b)}")
    rows["ensemble_sdf"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                **b)

    # the res-256 extraction grid: K1 once over the whole brick-ordered
    # grid, as nphm_grid_sdf launches it, held against its plain version
    res = EXTRACT_RES
    tile, brick = grid_tile(res, DEFAULT_TILE)
    grid = _brick_points(grid_axes(GRID_MIN, GRID_MAX, res, device),
                         torch.arange(res**3, device=device), res, brick, tile)
    expect(torch.equal(
        nphm_grid_sdf(params, cfg, lat, GRID_MIN, GRID_MAX, res),
        nphm_sdf(params, cfg, grid, lat, tile=tile)[_unbrick_gather(res, brick, tile, device)]),
        "K1 over the res-256 brick grid differs from nphm_grid_sdf's launch")
    rows["ensemble_sdf@res256"] = k1_launch_row(
        shape, params, lat, grid, tile, None, f"res-{res} brick grid (the extraction's launch)",
        reps=2)
    del grid
    torch.cuda.empty_cache()


def search_inputs(shape, params_shape, expr, params_expr, gen, device, B, N,
                  subjects: int = 1):
    """K2's inputs for B rows of N points: ``subjects`` shape codes, each
    conditioning B / subjects consecutive rows (a batched fit's folding)."""
    import numpy as np
    import torch

    from nphm_tpu_torch.models.deformation import conditioning
    from nphm_tpu_torch.models.ensemble import predict_anchors

    obs = torch.tensor(np.stack(observations(B, N, SEED + 1)), device=device)
    lat_s = (torch.randn((subjects, shape.lat_dim), generator=gen) * 0.01).to(device)
    lat_e = (torch.randn((B, expr.lat_dim), generator=gen) * 0.01).to(device)
    rep = B // subjects
    anchors = predict_anchors(params_shape, shape.cfg, lat_s).repeat_interleave(rep, dim=0)
    cond_lat = torch.cat([lat_s.repeat_interleave(rep, dim=0), lat_e], dim=-1)
    with torch.no_grad():
        cond = conditioning(params_expr, expr.cfg, cond_lat, anchors)
    eye = torch.eye(3, device=device).expand(B, N, 3, 3).contiguous()
    return obs, cond, eye


def check_k2(shape, params_shape, expr, params_expr, gen, device, rows):
    """K2 at the fit's shapes, cold (budget 15) then warm (budget 3), on the
    random-init trunk (an easy search: ~2 iterations) and on a copy whose
    offset head is scaled 90x (about half the lanes diverge, the rest need
    ~9 iterations).  Executed iterations agree within one (a lane next to
    the 1e-6 threshold may cross it an iteration apart: fp32 products in
    another order do the same), and two calls are bit-identical.  Timed at
    each of the four searches; the table's row is the cold one on the
    random-init trunk."""
    import torch

    from nphm_tpu_torch.ops.search import TILE, broyden_search, broyden_search_plain

    B, N = 5, 1000
    obs, cond, eye = search_inputs(shape, params_shape, expr, params_expr, gen,
                                   device, B, N)
    tcfg = expr.cfg.trunk_cfg
    base = params_expr["trunk"]
    hard = {"layers": base["layers"][:-1] + [
        {k: v * 90.0 for k, v in base["layers"][-1].items()}]}
    shapes, skip = tcfg.layer_shapes
    fmas = trunk_fmas(shapes, skip, tcfg.d_in_spatial, tcfg.d_in)
    wbytes = 4 * sum(lay["w"].numel() + lay["b"].numel() for lay in base["layers"])
    err_x = 0.0
    for tag, trunk in (("random-init", base), ("offset head x90", hard)):
        warm = None
        for budget in (15, 3):
            x0, j0 = (obs, eye) if warm is None else (warm["result"], warm["j_inv"])
            k = broyden_search(trunk, tcfg, cond, obs, x0, j0, budget)
            k2 = broyden_search(trunk, tcfg, cond, obs, x0, j0, budget)
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
                f"(tol {TOL_K2_J:g}); two calls bit-identical")
            expect(bool(torch.isfinite(k["diff"]).all()), "K2 non-finite residuals")
            expect(ex <= TOL_K2_X and eb <= TOL_K2_X and ej <= TOL_K2_J,
                   "K2 disagrees with its plain version")
            expect(abs(nk - np_) <= TOL_K2_NVALID * B * N, "K2 n_valid disagrees")
            expect(abs(int(k["iters"]) - int(p["iters"])) <= 1,
                   "K2's iterations differ from the plain search's by more than one")
            expect(all(torch.equal(k[key], k2[key]) for key in k),
                   "two K2 calls on the same inputs differ")
            err_x = max(err_x, ex, eb)
            # trunk evaluations the search ran: one per lane, plus one per
            # lane and iteration of its tile
            its = k["tile_iters"].cpu().tolist()
            real = [min(TILE, B * N - t * TILE) for t in range(len(its))]
            evals = sum(r * (1 + i) for r, i in zip(real, its))
            ms = cuda_ms(lambda: broyden_search(trunk, tcfg, cond, obs, x0, j0, budget), 5)
            plain_ms = cuda_ms(
                lambda: broyden_search_plain(trunk, tcfg, cond, obs, x0, j0, budget), 3)
            flops = 2.0 * fmas * evals
            b = bound(flops, B * N * 4 * (15 + 14) + wbytes)
            chain_ms = addmm_chain_ms(tcfg, evals, device, 5)
            log(f"[K2] {tag}, budget {budget}, B=5 N=1000: kernel {ms:.3f} ms, plain "
                f"{plain_ms:.3f} ms, addmm chain over as many trunk evaluations "
                f"{chain_ms:.3f} ms (information only: no library call runs the search); "
                f"iterations per {TILE}-lane tile mean {sum(its) / len(its):.2f} max "
                f"{max(its)}, {evals} trunk evaluations of {fmas} FMAs, "
                f"{bound_note(flops, b)}")
            if tag == "random-init" and budget == 15:
                rows["broyden_search"] = dict(ms=ms, plain_ms=plain_ms, **b)
            warm = p
    rows["broyden_search"]["max_abs_err"] = err_x


def check_k3_k4(shape, params, gen, device, rows, B: int = 5, subjects: int = 1,
                suffix: str = ""):
    """K3 and K4 on B rows of N = 1000 points (Morton-sorted, padded to the
    512-point tile), ``subjects`` shape codes each conditioning B / subjects
    rows, against their plain versions; rows ``fit_fwd{suffix}`` and
    ``fit_bwd{suffix}``."""
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
    N, tile = 1000, 512
    xyz = torch.tensor(np.stack(observations(B, N, SEED + 2)), device=device)
    lat = (torch.randn((subjects, cfg.lat_dim), generator=gen) * 0.01).to(device)
    lat = lat.repeat_interleave(B // subjects, dim=0).contiguous().requires_grad_(True)
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
    b3 = bound(flops3, pairs * 16 + wb)
    flops4 = 4.0 * nphm_fmas(cfg) * pairs
    b4 = bound(flops4, pairs * 28 + wb)
    M = B * Np
    lib3 = baddbmm_chain_ms(cfg, A, M, "f", device, 10)
    lib4 = baddbmm_chain_ms(cfg, A, M, "fr", device, 10)
    log(f"[K3] M={B}x{Np}: kernel {ms3:.3f} ms, plain {plain3:.3f} ms, baddbmm chain "
        f"{lib3:.3f} ms; {pairs} live (point, member) pairs, {bound_note(flops3, b3)}")
    log(f"[K4] M={B}x{Np}: kernel {ms4:.3f} ms, plain backward {plain4:.3f} ms, baddbmm "
        f"forward + reverse chains {lib4:.3f} ms; {bound_note(flops4, b4)}")
    rows["fit_fwd" + suffix] = dict(max_abs_err=e3, ms=ms3, plain_ms=plain3,
                                    library_ms=lib3, **b3)
    rows["fit_bwd" + suffix] = dict(max_abs_err=e4, ms=ms4, plain_ms=plain4,
                                    library_ms=lib4, **b4)
    del Fk, Fp, gk, gp
    torch.cuda.empty_cache()


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
            b5 = bound(flops5, pairs * 28 + wb)
            flops6 = 2.0 * 6 * nphm_fmas(cfg) * pairs
            b6 = bound(flops6, pairs * 40 + 2 * wb)
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


def k6_scratch_bytes(cfg, M: int, name: str = "default") -> int:
    """Bytes K6's scratch moves for one member over M lanes in the layout of
    precision ``name`` (``train_fields.scratch_traffic``): its first pass
    writes the [h | q] rows of every hidden layer, the second reads them and
    writes the [zbar | pbar] rows of every hidden product, the contraction
    reads all of them; each row holds 2M floats (bf16 for [zbar | pbar] at
    "bfloat16")."""
    from nphm_tpu_torch.ops import precision
    from nphm_tpu_torch.ops.train_fields import scratch_traffic

    return scratch_traffic(cfg, M, precision.resolve(name))


def baddbmm_chain_ms(cfg, n_members: int, M: int, passes: str, device, reps: int,
                     dtype=None) -> float:
    """One ``torch.baddbmm`` per layer and pass over the member axis at the
    NPHM ensemble's shapes (conditioning folded: layer 0 reads the 3 point
    inputs, the skip layer hidden + 3), M points a member, TF32 off (or as
    the caller set it), random operands of ``dtype`` (default fp32), no
    activations.  Passes: "f" a forward chain (each layer's
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
    t = dict(device=device, dtype=dtype)
    W = [torch.randn(A, k, n, **t) / k**0.5 for k, n in kn]
    bias = [torch.zeros(A, 1, n, **t) for _, n in kn]
    zero = torch.zeros(1, 1, 1, **t)
    x0 = torch.randn(A, M, ds, **t)
    x_skip = torch.randn(A, M, kn[skip][0], **t)
    d0 = torch.randn(A, M, kn[-1][1], **t)
    if "w" in passes:
        X = torch.randn(A, M, max(k for k, _ in kn), **t)
        D = torch.randn(A, M, max(n for _, n in kn), **t)

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
    return bound(trunk_flops(cfg, n), n * 4 * (cfg.d_in_spatial + cfg.out_dim) + wbytes)


def k7_error(kernel, plain, head_bias):
    """(max |kernel - plain|, the plain head product's max magnitude)."""
    return (float((kernel - plain).abs().max()),
            float((plain - head_bias).abs().max()))


def check_k7(models, npm, device, rows):
    """K7 on the three trunks the main paths run, each through
    ``k7_launch_row`` (against its plain version, both timed with CUDA
    events after a warm-up, beside the addmm chain): (a) the NPM identity
    trunk on 2^20 points of the res-256 grid (its middle x-slabs), (b) the
    NPM offsets trunk and (c) the NPHM compress trunk on 2^19 points of a
    warped sphere (a mesh's vertices).  The table row is (a), the res-256
    NPM grid's trunk, with the largest error of the three."""
    import torch

    from nphm_tpu_torch.models.deformation import conditioning
    from nphm_tpu_torch.models.ensemble import predict_anchors

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
    found = [k7_launch_row(params, cfg, pts, cond, tag, reps)
             for tag, params, cfg, pts, cond, reps in cases]
    rows["deepsdf_trunk"] = dict(found[0], max_abs_err=max(r["max_abs_err"] for r in found))


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
    return counts, steady, (lat_expr, lat_shape, anchors)


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
    return counts, lat_shape


# ---------------------------------------------------------------------------
# Phase 7: the batched fit and the fitting CLI
# ---------------------------------------------------------------------------


def batch_observations():
    """BATCH_SUBJECTS subjects, each 20 scans x 2500 points from its own seed."""
    return [observations(20, 2500, SEED + 100 + s) for s in range(BATCH_SUBJECTS)]


def check_batched_kernels(models, device, rows):
    """K2, K3 and K4 at the batched fit's launch shapes: 8 subjects x 5
    scans = 40 rows of 1000 points, each subject's shape code conditioning
    its 5 rows (``check_k2_batched``, then ``check_k3_k4``)."""
    check_k2_batched(models, device, rows, "broyden_search@S8")
    check_k3_k4(models[0], models[1], models[4], device, rows, B=5 * BATCH_SUBJECTS,
                subjects=BATCH_SUBJECTS, suffix="@S8")


def check_k2_batched(models, device, rows, key, tag=""):
    """K2 at the batched fit's launch shape, row ``key``: 8 subjects x 5
    scans = 40 rows of 1000 points, each subject's shape code conditioning
    its 5 rows through the field's row-constant conditioning; K2's lanes in
    8 per-subject groups of 5000, each padded to 5024 (157 tiles).  Cold at
    budget 15 (the row's time, as in phase 3) then warm at budget 3 from
    the plain result (the fit's launch after its first step), each against
    its plain version with phase 3's tolerances, per-subject iterations
    within one, two calls bit-identical."""
    import torch

    from nphm_tpu_torch.ops.search import (
        TILE,
        broyden_search,
        broyden_search_plain,
        lane_layout,
    )

    shape, params_shape, expr, params_expr, gen = models
    S, N = BATCH_SUBJECTS, 1000
    B = 5 * S
    obs, cond, eye = search_inputs(shape, params_shape, expr, params_expr, gen, device,
                                   B, N, subjects=S)
    tcfg = expr.cfg.trunk_cfg
    trunk = params_expr["trunk"]
    shapes, skip = tcfg.layer_shapes
    fmas = trunk_fmas(shapes, skip, tcfg.d_in_spatial, tcfg.d_in)
    wbytes = 4 * sum(lay["w"].numel() + lay["b"].numel() for lay in trunk["layers"])
    n_pad, g_pad, g_real = lane_layout(B * N, S)
    real = [min(TILE, max(0, g_real - (t * TILE) % g_pad)) for t in range(n_pad // TILE)]
    name = f"[K2x{S}{tag}]"
    err, warm = 0.0, None
    for budget in (15, 3):
        x0, j0 = (obs, eye) if warm is None else (warm["result"], warm["j_inv"])

        def run(fn=broyden_search):
            return fn(trunk, tcfg, cond, obs, x0, j0, budget, groups=S)

        k, k2, p = run(), run(), run(broyden_search_plain)
        both = k["valid_ids"] & p["valid_ids"]
        ex = float((k["result"] - p["result"]).abs()[both].max()) if both.any() else 0.0
        eb = float((k["diff"] - p["diff"]).abs()[both].max()) if both.any() else 0.0
        ej = float((k["j_inv"] - p["j_inv"]).abs()[both].max()) if both.any() else 0.0
        nk, np_ = int(k["valid_ids"].sum()), int(p["valid_ids"].sum())
        gk, gp = k["group_iters"].tolist(), p["group_iters"].tolist()
        log(f"{name} budget {budget}, {B} rows x {N} (8 groups of {g_real} lanes padded "
            f"to {g_pad}): n_valid kernel {nk} plain {np_}; per-subject iterations kernel "
            f"{gk} plain {gp}; valid-in-both max|dx| {ex:.3e} max|dbn| {eb:.3e} (tol "
            f"{TOL_K2_X:g}) max|dJ| {ej:.3e} (tol {TOL_K2_J:g}); two calls bit-identical")
        expect(bool(torch.isfinite(k["diff"]).all()), f"{name} non-finite residuals")
        expect(ex <= TOL_K2_X and eb <= TOL_K2_X and ej <= TOL_K2_J,
               f"{name} disagrees with its plain version")
        expect(abs(nk - np_) <= TOL_K2_NVALID * B * N, f"{name} n_valid disagrees")
        expect(all(abs(a - b) <= 1 for a, b in zip(gk, gp)),
               f"{name}'s per-subject iterations differ from the plain search's by more "
               "than one")
        expect(all(torch.equal(k[key_], k2[key_]) for key_ in k),
               f"two {name} calls on the same inputs differ")
        err = max(err, ex, eb)
        evals = sum(r * (1 + i) for r, i in zip(real, k["tile_iters"].cpu().tolist()))
        ms = cuda_ms(run, 5)
        plain_ms = cuda_ms(lambda: run(broyden_search_plain), 3)
        flops = 2.0 * fmas * evals
        b = bound(flops, B * N * 4 * (15 + 14) + wbytes)
        log(f"{name} budget {budget}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; "
            f"{n_pad // TILE} tiles, {evals} trunk evaluations, {bound_note(flops, b)}")
        if budget == 15:
            rows[key] = dict(ms=ms, plain_ms=plain_ms, **b)
        else:
            rows[key]["warm_budget3_ms"] = ms
        warm = p
    rows[key]["max_abs_err"] = err
    del obs, cond, eye, k, k2, p, warm
    torch.cuda.empty_cache()


def batch_path(models, device, serial_it_s: float):
    """``fit_joint_batch`` on BATCH_SUBJECTS subjects for FIT_STEPS steps,
    then the 5-step batched fit against the plain path and per-subject
    ``fit_joint``."""
    import numpy as np
    import torch

    from nphm_tpu_torch.fitting import FittingConfig, fit_joint_batch

    shape, params_shape, expr, params_expr, _gen = models
    subjects = batch_observations()
    cfg = FittingConfig(n_steps=FIT_STEPS, seed=SEED)
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lat_exprs, lat_shapes, anchors, hist = fit_joint_batch(
        shape, params_shape, expr, params_expr, subjects, cfg=cfg, device=device,
        verbose=False)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    counts = read_counters()
    loss = hist["loss"]
    sss = hist["steady_subject_steps_s"]
    log(f"[batch-fit] {BATCH_SUBJECTS} subjects x {FIT_STEPS} steps in {t_fit:.2f} s; "
        f"steady {sss:.2f} subject-steps/s, {1e3 * BATCH_SUBJECTS / sss:.2f} ms a step "
        f"(first step {hist['first_step_s']:.2f} s excluded), against {serial_it_s:.2f} "
        f"it/s of phase 4's serial fit ({sss / serial_it_s:.2f}x); loss mean "
        f"{float(loss[0].mean()):.5f} -> {float(loss[-1].mean()):.5f}; executed Broyden "
        f"iterations mean {float(hist['broyden_iters'].mean()):.2f}, per subject "
        f"{np.round(hist['broyden_iters'].mean(axis=0), 2).tolist()}")
    log(f"[counters] batched fit: {json.dumps(counts)}")
    expect(bool(np.isfinite(loss).all()), "batched fit loss history is not finite")
    expect(all(np.isfinite(x).all() for x in lat_exprs + lat_shapes + anchors),
           "batched fit latents are not finite")
    for name in ("broyden_search", "fit_fwd", "fit_bwd"):
        expect(counts[name] > 0, f"kernel {name} was not launched by the batched fit")
    check_batch_reference(models, subjects, device)
    return counts


def fit_batch(models, subjects, device, mode, n, start, draws):
    """``fit_joint_batch`` for n steps on the given (sel, idx) draws from the
    shape codes ``start`` (None: zero), kernels "auto" or plain "off"."""
    from nphm_tpu_torch.fitting import FittingConfig, fit_joint_batch

    shape, params_shape, expr, params_expr, _gen = models
    cfg = FittingConfig(n_steps=n, fused_search=mode, fused_shape_fields=mode)
    return fit_joint_batch(shape, params_shape, expr, params_expr, subjects, cfg=cfg,
                           device=device, verbose=False,
                           sample_draws=tuple(d[:n] for d in draws), lat_shape_init=start)


def fit_diffs(x, y):
    """({term: max |x - y|}, all within TOL_FIT_*) of two batched fits."""
    import numpy as np

    (le, ls, _, h), (rle, rls, _, rh) = x, y
    pairs = [("lat_shape", a, b) for a, b in zip(ls, rls)]
    pairs += [("lat_expr", a, b) for a, b in zip(le, rle)]
    pairs.append(("loss", h["loss"], rh["loss"]))
    errs = {}
    for key, a, b in pairs:
        errs[key] = max(errs.get(key, 0.0), float(np.abs(a - b).max()))
    close = all(np.allclose(a, b, rtol=TOL_FIT_RTOL, atol=TOL_FIT_ATOL) for _, a, b in pairs)
    return errs, close


def check_batch_reference(models, subjects, device):
    """5 batched steps through K2-K4 against the plain path (``"off"``) on
    the same draws, then the same draws through ``fit_joint`` for two
    subjects; then the zero start that users run.

    The 5-step checks start the shape codes from a seeded draw (std
    LAT_INIT_STD), not zero.  At zero the codes of each symmetric member
    pair coincide, and symm_dist's gradient, the direction of their
    difference, is then set by rounding: from zero, five steps of two fits
    whose sums differ only in order put a code up to 2.8e-3 apart on an
    H100 (kernels against the plain path, and batched against
    per-subject ``fit_joint`` alike; largest in the symmetric pairs 12/13
    and 20/21), where one step agrees within 2.4e-5.  So from zero one
    step of the kernels is held against the plain path under the same
    tolerance, and the 5-step readings from zero are logged beside a
    witness with no kernel in it: the plain path against itself with
    each subject's rows in another order."""
    import numpy as np

    from nphm_tpu_torch.fitting import FittingConfig, fit_joint

    shape, params_shape, expr, params_expr, _gen = models
    steps, nb, npp, S = 5, 5, 1000, len(subjects)
    rng = np.random.default_rng(SEED + 7)
    sel = rng.integers(0, len(subjects[0]), size=(steps, S, nb))
    idx = rng.integers(0, len(subjects[0][0]), size=(steps, S, nb, npp))
    init = (rng.normal(size=(S, shape.lat_dim)) * LAT_INIT_STD).astype(np.float32)
    perm = rng.permutation(nb)

    def batch(mode, n=steps, start=init, draws=(sel, idx)):
        return fit_batch(models, subjects, device, mode, n, start, draws)

    out = {mode: batch(mode) for mode in ("auto", "off")}
    (le, ls, _, h), (_, _, _, rh) = out["auto"], out["off"]
    errs, close = fit_diffs(out["auto"], out["off"])
    log(f"[batch-check] {steps} steps x {S} subjects, kernels vs plain path: max|diff| "
        f"{json.dumps(errs)}; n_valid {h['n_valid'].sum(axis=1).tolist()} vs "
        f"{rh['n_valid'].sum(axis=1).tolist()}; iterations kernel "
        f"{h['broyden_iters'].tolist()} plain {rh['broyden_iters'].tolist()} (rtol "
        f"{TOL_FIT_RTOL:g}, atol {TOL_FIT_ATOL:g})")
    expect(close, "the batched kernel fit disagrees with the plain-path batched fit")
    expect(bool(np.all(np.abs(h["n_valid"] - rh["n_valid"]) <= TOL_K2_NVALID * nb * npp)),
           "the batched kernel fit's n_valid disagrees with the plain path's")
    cfg = FittingConfig(n_steps=steps)
    for s in (0, S - 3):
        sle, sls, _, sh = fit_joint(shape, params_shape, expr, params_expr, subjects[s],
                                    cfg=cfg, device=device, verbose=False,
                                    sample_draws=(sel[:, s], idx[:, s]),
                                    lat_shape_init=init[s])
        e = {"lat_shape": float(np.abs(sls - ls[s]).max()),
             "lat_expr": float(np.abs(sle - le[s]).max()),
             "loss": float(np.abs(sh["loss"] - h["loss"][:, s]).max())}
        log(f"[batch-check] subject {s} through fit_joint on its draws vs the batched fit: "
            f"max|diff| {json.dumps(e)}; iterations {sh['broyden_iters'].tolist()} vs "
            f"{h['broyden_iters'][:, s].tolist()}")
        for a, b in ((sls, ls[s]), (sle, le[s]), (sh["loss"], h["loss"][:, s])):
            expect(bool(np.allclose(a, b, rtol=TOL_FIT_RTOL, atol=TOL_FIT_ATOL)),
                   f"subject {s}'s fit_joint disagrees with the batched fit")

    # the zero start: one step checked, five logged beside the witness
    reordered = (sel[:, :, perm], idx[:, :, perm])
    for n in (1, steps):
        plain = batch("off", n, None)
        k_vs_p, close = fit_diffs(batch("auto", n, None), plain)
        p_vs_p, _ = fit_diffs(plain, batch("off", n, None, reordered))
        log(f"[batch-check] zero start, {n} step(s) x {S} subjects: kernels vs plain path "
            f"max|diff| {json.dumps(k_vs_p)}; plain vs plain with each subject's rows "
            f"reordered {perm.tolist()} max|diff| {json.dumps(p_vs_p)}")
        if n == 1:
            expect(close, "one batched kernel step from zero disagrees with the plain path")


def write_experiments(models, env):
    """Port-format checkpoints (epoch 1) and ``configs.yaml`` of the phase-2
    NPHM models, and a latent prior for ``-sample``, into a dummy tree's
    experiment and asset folders; returns the fitting config's path."""
    import shutil

    import numpy as np
    import yaml

    from nphm_tpu_torch.training.checkpoints import save_checkpoint
    from nphm_tpu_torch.utils.params import to_numpy_pytree

    shape, params_shape, _expr, params_expr, _gen = models
    exp = env["NPHM_EXPERIMENT_DIR"]
    for name, cfg_file, params in (("smoke_shape", "nphm.yaml", params_shape),
                                   ("smoke_expr", "nphm_def.yaml", params_expr)):
        os.makedirs(os.path.join(exp, name))
        shutil.copy(os.path.join(ROOT, "configs", cfg_file),
                    os.path.join(exp, name, "configs.yaml"))
        save_checkpoint(os.path.join(exp, name, "checkpoints"), 1,
                        {"params": to_numpy_pytree(params)})
    np.save(os.path.join(env["NPHM_ASSETS"], "nphm_lat_mean.npy"),
            np.zeros(shape.lat_dim, np.float32))
    np.save(os.path.join(env["NPHM_ASSETS"], "nphm_lat_std.npy"),
            np.full(shape.lat_dim, 0.01, np.float32))
    path = os.path.join(exp, "fitting_smoke.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({"exp_name_shape": "smoke_shape", "checkpoint_shape": 1,
                        "mode": "compress", "local_shape": True, "local_expr": False,
                        "exp_name_expr": "smoke_expr", "checkpoint_expr": 1}, f)
    return path


def cli_path(models):
    """``python -m nphm_tpu_torch.fitting_pointclouds``'s ``main`` in a child
    process whose environment names a dummy tree: ``-demo -batch_subjects 2
    -n_steps 50 -resolution 256``, then ``-sample -n_samples 1``."""
    import numpy as np

    from nphm_tpu_torch.data.dummy import dummy_env, generate_dummy_data
    from nphm_tpu_torch.utils.mesh_io import read_ply

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "dummy")
        generate_dummy_data(root, n_supervision=2000)
        env = dummy_env(root)
        cfg_path = write_experiments(models, env)
        base = ["-cfg_file", cfg_path, "-exp_name", "smoke", "-resolution", str(EXTRACT_RES)]
        argvs = [base + ["-exp_tag", "demo", "-demo", "-batch_subjects", "2", "-n_steps",
                         str(CLI_STEPS)],
                 base + ["-exp_tag", "sample", "-sample", "-n_samples", "1"]]
        code = (f"import json, sys\nsys.path.insert(0, {ROOT!r})\nimport chip_smoke as c\n"
                f"from nphm_tpu_torch.fitting_pointclouds import main\nc.reset_counters()\n"
                f"for argv in {argvs!r}:\n    main(argv)\n"
                f"print('CLI_COUNTERS ' + json.dumps(c.read_counters()), flush=True)\n")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], cwd=tmp, capture_output=True,
                              text=True, env={**os.environ, **env}, timeout=900)
        wall = time.perf_counter() - t0
        lines = proc.stdout.splitlines()
        for line in lines:
            if line.startswith(("[fit_joint_batch]", "FIT_PHASE_TIMINGS", "sample ",
                                "exported ", "screenshot")):
                log(f"[cli] {line}")
        expect(proc.returncode == 0, f"the fitting CLI failed (exit {proc.returncode}):\n"
               f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        timings = [json.loads(ln.split(" ", 1)[1]) for ln in lines
                   if ln.startswith("FIT_PHASE_TIMINGS ")]
        counts = [json.loads(ln.split(" ", 1)[1]) for ln in lines
                  if ln.startswith("CLI_COUNTERS ")]
        expect(len(timings) == 1 and len(timings[0]["fit_group_walls_s"]) == 1,
               "the CLI printed no FIT_PHASE_TIMINGS line of one batched group")
        expect(len(counts) == 1, "the CLI child printed no launch counters")
        out_dir = os.path.join(env["NPHM_FITTING_DIR"], "forward_smoke", "demo")
        expect(os.path.exists(os.path.join(out_dir, "configs.yaml")), "no configs.yaml")
        n_verts = []
        for subj in (351, 365):
            for e in (0, 1):
                mesh = read_ply(os.path.join(out_dir, f"{subj}_{e}.ply"))
                expect(len(mesh.vertices) > 0 and len(mesh.faces) > 0
                       and bool(np.isfinite(mesh.vertices).all()),
                       f"empty or non-finite mesh {subj}_{e}.ply")
                n_verts.append(len(mesh.vertices))
                for kind in ("lat_shape", "lat_expr"):
                    lat = np.load(os.path.join(out_dir, f"{subj}_{e}_{kind}.npy"))
                    expect(bool(np.isfinite(lat).all()), f"{subj}_{e}_{kind}.npy not finite")
        samples = os.path.join(tmp, "nphm_shape_space_samples_085")
        sample = read_ply(os.path.join(samples, "mesh_0000.ply"))
        expect(len(sample.vertices) > 0, "the -sample mesh is empty")
        expect(os.path.getsize(os.path.join(samples, "step_0000.png")) > 0,
               "the -sample screenshot step_0000.png is missing")
        expect(np.load(os.path.join(samples, "lat_0000.npy")).shape == (1, models[0].lat_dim),
               "the -sample latent has the wrong shape")
    log(f"[cli] demo (2 subjects x 2 expressions, one batched group) and one sample in "
        f"{wall:.2f} s (child process included); posed meshes {n_verts} vertices, sample "
        f"{len(sample.vertices)}; FIT_PHASE_TIMINGS {json.dumps(timings[0])}")
    log(f"[counters] CLI: {json.dumps(counts[0])}")
    for name in ("ensemble_sdf", "broyden_search", "fit_fwd", "fit_bwd", "deepsdf_trunk"):
        expect(counts[0][name] > 0, f"kernel {name} was not launched by the CLI")
    return counts[0]


# ---------------------------------------------------------------------------
# Phase 8: streamed, sparse and backward-warp extraction
# ---------------------------------------------------------------------------


def _sorted_vertices(mesh):
    import numpy as np

    v = mesh.vertices
    return v[np.lexsort(v.T)]


def _add(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


@contextlib.contextmanager
def launches_by_shape(launches, fine: str = "sparse_fine"):
    """Count K1's and K7's launches at phase 8's launch shapes where they
    are made: the streamed path's ``slab_logits`` (``slab_tile`` and the
    tile, 1024 or 2048) and the sparse path's
    ``probe_lip``, ``coarse_pass`` and ``fine_pass`` (rows ``lip_probe``,
    ``sparse_coarse``, ``sparse_fine``; ``npm_`` before them for an NPM
    decoder, whose passes run K7; ``fine`` names the fine pass's row) are
    wrapped, and each outermost call adds its kernel counter's change to
    ``launches`` (the probe's own fine pass counts as the probe)."""
    from nphm_tpu_torch.ops.ensemble import nphm_sdf
    from nphm_tpu_torch.ops.trunk import deepsdf_trunk
    from nphm_tpu_torch.reconstruction import extract, sparse

    depth = [0]

    def counted(fn, shape_of):
        def call(*args, **kw):
            row, counter = shape_of(*args)
            before = counter.launches
            depth[0] += 1
            try:
                return fn(*args, **kw)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    launches[row] = launches.get(row, 0) + counter.launches - before
        return call

    def slab(params, cfg, lat, axes, res, n_slabs, brick, tile, *_):
        return f"ensemble_sdf@slab_tile{tile}", nphm_sdf

    def sparse_pass(name):
        def shape_of(decoder, *_):
            if decoder.kind == "nphm":
                return f"ensemble_sdf@{name}", nphm_sdf
            return f"deepsdf_trunk@npm_{name}", deepsdf_trunk
        return shape_of

    wrapped = [(extract, "slab_logits", slab)] + [
        (sparse, fn, sparse_pass(name)) for fn, name in
        (("probe_lip", "lip_probe"), ("coarse_pass", "sparse_coarse"),
         ("fine_pass", fine))]
    saved = [(mod, fn, getattr(mod, fn)) for mod, fn, _ in wrapped]
    for mod, fn, shape_of in wrapped:
        setattr(mod, fn, counted(getattr(mod, fn), shape_of))
    try:
        yield launches
    finally:
        for mod, fn, orig in saved:
            setattr(mod, fn, orig)


def dense_meshes(decoder, params, lat, device, res, total):
    """The dense reference as the CPU tests build it: ``nphm_grid_sdf`` at
    tile 1024 (NPHM) or ``npm_grid_sdf`` (NPM), copied once, then
    ``mesh_from_logits`` on the f32 logits and on their f16 cast on the
    host.  Returns {None: f32 mesh, np.float16: f16 mesh}."""
    import numpy as np
    import torch

    from nphm_tpu_torch.ops.ensemble import nphm_grid_sdf
    from nphm_tpu_torch.ops.marching import mesh_from_logits
    from nphm_tpu_torch.ops.trunk import npm_grid_sdf

    lat_t = torch.tensor(np.asarray(lat, np.float32), device=device).reshape(-1)
    reset_counters()
    if decoder.kind == "nphm":
        logits = nphm_grid_sdf(params, decoder.cfg, lat_t, GRID_MIN, GRID_MAX, res, tile=1024)
    else:
        logits = npm_grid_sdf(params, decoder.cfg, lat_t, GRID_MIN, GRID_MAX, res)
    logits = logits.cpu().numpy()
    _add(total, read_counters())
    return {dt: mesh_from_logits(logits if dt is None else logits.astype(dt).astype(np.float32),
                                 GRID_MIN, GRID_MAX, res)
            for dt in (None, np.float16)}


def three_paths(decoder, params, lat, device, tag, total, launches):
    """Dense (tile 1024), streamed (8 slabs, tile 1024) and sparse (lip
    "auto") extraction at res 256 must emit array-equal vertex sets, with
    f32 and f16 copies to the host.  An NPM decoder's streamed call falls
    back to the float32 dense path, as in the JAX package, so it is held
    against the f32 dense mesh.  Counts each call's launches (by shape in
    ``launches``); returns the f16 sparse call's stats and the dense meshes
    by copy dtype."""
    import warnings

    import numpy as np

    from nphm_tpu_torch.ops.ensemble import grid_tile
    from nphm_tpu_torch.reconstruction.extract import _pick_n_slabs, extract_mesh_streamed
    from nphm_tpu_torch.reconstruction.sparse import extract_mesh_sparse

    dense = dense_meshes(decoder, params, lat, device, EXTRACT_RES, total)
    stats = {}
    for dt, name in ((None, "f32"), (np.float16, "f16")):
        reset_counters()
        with launches_by_shape(launches):
            streamed = extract_mesh_streamed(decoder, params, lat, GRID_MIN, GRID_MAX,
                                             EXTRACT_RES, n_slabs=8, transfer_dtype=dt,
                                             tile=1024, device=device)
        c_streamed = read_counters()
        _add(total, c_streamed)
        reset_counters()
        stats = {}
        with warnings.catch_warnings(record=True) as caught, launches_by_shape(launches):
            warnings.simplefilter("always")
            sparse = extract_mesh_sparse(decoder, params, lat, GRID_MIN, GRID_MAX,
                                         EXTRACT_RES, lip="auto", transfer_dtype=dt,
                                         stats=stats, device=device)
        c_sparse = read_counters()
        _add(total, c_sparse)
        if decoder.kind == "nphm":
            slabs = _pick_n_slabs(EXTRACT_RES, grid_tile(EXTRACT_RES, 1024)[1][0], 8)
            expect(c_streamed["ensemble_sdf"] == slabs, "the streamed path did not launch "
                   "K1 once per slab")
            expect(c_sparse["ensemble_sdf"] == 3, "the sparse path did not launch K1 for "
                   "its probe, coarse and fine passes")
            ref_streamed = dense[dt]
        else:
            expect(c_sparse["deepsdf_trunk"] == 3, "the NPM sparse path did not launch K7 "
                   "for its probe, coarse and fine passes")
            ref_streamed = dense[None]
        d, n = dense[dt], [len(m.vertices) for m in (dense[dt], streamed, sparse)]
        same_streamed = (len(ref_streamed.vertices) == n[1] and np.array_equal(
            _sorted_vertices(ref_streamed), _sorted_vertices(streamed)))
        same_sparse = n[0] == n[2] and np.array_equal(_sorted_vertices(d),
                                                      _sorted_vertices(sparse))
        log(f"[{tag}] res {EXTRACT_RES} {name}: dense / streamed / sparse vertices {n}, "
            f"faces {[len(m.faces) for m in (d, streamed, sparse)]}; array-equal sorted "
            f"vertex sets: streamed {same_streamed} (against the "
            f"{'f32 dense mesh, a fallback' if ref_streamed is not d else 'dense mesh'}), "
            f"sparse {same_sparse}; sparse stats {json.dumps(stats)}; warnings "
            f"{[str(w.message)[:120] for w in caught]}")
        expect(n[0] > 0, f"{tag}: the dense mesh is empty")
        expect(same_streamed and same_sparse,
               f"{tag}: dense, streamed and sparse extraction differ ({name})")
    return stats, dense


def k1_launch_row(shape, params, lat, pts, tile, operands, what, reps=3):
    """K1 at one of phase 8's launch shapes against its plain version on the
    same points (the plain one in 2^18-point chunks of whole tiles), both
    timed, beside the ``baddbmm`` chain over the same chunks and the bound
    from the live (point, member) pairs of these points."""
    import torch

    from nphm_tpu_torch.ops.ensemble import CULL_EPS, _prepare, nphm_sdf, nphm_sdf_plain

    cfg = shape.cfg
    n, chunk = pts.shape[0], 1 << 18
    kern = nphm_sdf(params, cfg, pts, lat, tile=tile, operands=operands)
    err = torch.zeros((), device=pts.device)

    def plain_chunks():
        nonlocal err
        for c0 in range(0, n, chunk):
            p = nphm_sdf_plain(params, cfg, pts[c0 : c0 + chunk], lat, tile=tile,
                               operands=operands)
            err = torch.maximum(err, (p - kern[c0 : c0 + chunk]).abs().max())

    plain_ms = cuda_ms(plain_chunks, 1)
    err = float(err)
    expect(bool(torch.isfinite(kern).all()), f"K1 non-finite at {what}")
    ms = cuda_ms(lambda: nphm_sdf(params, cfg, pts, lat, tile=tile, operands=operands), reps)
    n_chunks = -(-n // chunk)
    lib_ms = baddbmm_chain_ms(cfg, cfg.n_members, min(n, chunk), "f", device=pts.device,
                              reps=1) * n_chunks
    with torch.no_grad():
        _, _, _, active = _prepare(params, cfg, pts, lat, tile, CULL_EPS, operands)
    pairs = int(active.sum()) * tile
    flops = 2.0 * nphm_fmas(cfg) * pairs
    wb = weight_bytes(params["ensemble"], cfg) // cfg.n_members * cfg.n_loc
    b = bound(flops, n * 16 + wb)
    log(f"[K1@{what}] {n} points, tile {tile}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"baddbmm chain {lib_ms:.3f} ms; {pairs} live (point, member) pairs, "
        f"{bound_note(flops, b)}; max|err| {err:.3e} (tol {TOL_K1:g})")
    expect(err <= TOL_K1, f"K1 disagrees with its plain version at {what}")
    del kern
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **b)


def k7_launch_row(params, cfg, pts, cond, what, reps=3, chunk=1 << 20):
    """K7 at one of phase 8's launch shapes against its plain version on the
    same points (in 2^20-point chunks), both timed, beside the ``addmm``
    chain over the same chunks; error relative to the plain head
    product's magnitude."""
    import torch

    from nphm_tpu_torch.ops.trunk import deepsdf_trunk, deepsdf_trunk_plain, prepare_trunk_operands

    n = pts.shape[0]
    kern = deepsdf_trunk(params, cfg, pts, cond)
    head_bias = params["layers"][-1]["b"]
    err = torch.zeros((), device=pts.device)
    scale = torch.zeros((), device=pts.device)

    def plain_chunks():
        nonlocal err, scale
        for c0 in range(0, n, chunk):
            p = deepsdf_trunk_plain(params, cfg, pts[c0 : c0 + chunk], cond)
            err = torch.maximum(err, (p - kern[c0 : c0 + chunk]).abs().max())
            scale = torch.maximum(scale, (p - head_bias).abs().max())

    plain_ms = cuda_ms(plain_chunks, 1)
    err, scale = float(err), float(scale)
    expect(bool(torch.isfinite(kern).all()), f"K7 non-finite at {what}")
    ms = cuda_ms(lambda: deepsdf_trunk(params, cfg, pts, cond), reps)
    lib_ms = addmm_chain_ms(cfg, min(n, chunk), pts.device, 1) * -(-n // chunk)
    with torch.no_grad():
        b = trunk_bound(cfg, n, prepare_trunk_operands(params, cfg, cond))
    flops = trunk_flops(cfg, n)
    log(f"[K7@{what}] {n} points: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, addmm chain "
        f"{lib_ms:.3f} ms; {bound_note(flops, b)}; max|err| {err:.3e}, relative "
        f"{err / max(scale, 1e-30):.3e} (tol {TOL_K7:g}) to the head product's max "
        f"magnitude {scale:.4f}")
    expect(err <= TOL_K7 * scale, f"K7 disagrees with its plain version at {what}")
    del kern
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **b)


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def extraction_path(models, npm, fitted, npm_lat, device, rows):
    """Phase 8 on the fitted codes of phases 4 and 6: the three extraction
    paths' vertex parity at res 256 (NPHM and NPM, f32 and f16), the NPHM
    sparse path at the CLI's lip 2.0, their times beside dense
    ``extract_mesh`` in this run, K1's and K7's new launch shapes against
    their plain versions, and the backward-warp grid against the plain path
    on one slab's points."""
    import warnings

    import numpy as np
    import torch

    from nphm_tpu_torch.models.deformation import conditioning
    from nphm_tpu_torch.ops.ensemble import (
        _brick_points,
        grid_axes,
        grid_tile,
        nphm_sdf_plain,
        prepare_ensemble_operands,
    )
    from nphm_tpu_torch.ops.trunk import deepsdf_trunk_plain
    from nphm_tpu_torch.reconstruction import sparse as sp
    from nphm_tpu_torch.reconstruction.extract import (
        _pick_n_slabs,
        backward_grid_logits,
        extract_mesh,
        extract_mesh_streamed,
        get_logits_backward,
        make_point_evaluator,
    )

    shape, params_shape, expr, params_expr, _gen = models
    lat_expr, lat_shape, anchors = fitted
    total, launches = {}, {}
    res = EXTRACT_RES
    own_rows = set(rows)
    stats, dense = three_paths(shape, params_shape, lat_shape, device, "nphm-extract", total,
                               launches)

    # the fitting CLI's sparse setting (lip 2.0, f16): the coarse pass must
    # skip blocks, the field must stay within lip, and the mesh must be the
    # dense one
    lstats = {}
    reset_counters()
    with warnings.catch_warnings(record=True) as caught, \
            launches_by_shape(launches, fine="sparse_fine_lip2"):
        warnings.simplefilter("always")
        lmesh, t_lip2 = _timed(lambda: sp.extract_mesh_sparse(
            shape, params_shape, lat_shape, GRID_MIN, GRID_MAX, res, lip=2.0,
            transfer_dtype=np.float16, stats=lstats, device=device))
    _add(total, read_counters())
    same = (len(lmesh.vertices) == len(dense[np.float16].vertices) and np.array_equal(
        _sorted_vertices(lmesh), _sorted_vertices(dense[np.float16])))
    log(f"[nphm-extract] res {res}, lip 2.0 (the CLI's), f16: {t_lip2:.3f} s with "
        f"{lstats['n_candidates']} of {lstats['n_blocks']} blocks candidates "
        f"({lstats['n_candidates'] / lstats['n_blocks']:.4f}), {lstats['n_transferred']} "
        f"transferred, lip_observed {lstats['lip_observed']:.3f}; {len(lmesh.vertices)} "
        f"vertices, array-equal to the dense f16 mesh: {same}; warnings "
        f"{[str(w.message)[:120] for w in caught]}")
    expect(not caught, "the field exceeds lip 2.0 on the fitted code")
    expect(lstats["n_candidates"] < lstats["n_blocks"], "the coarse pass at lip 2.0 skipped "
           "no block")
    expect(same, "sparse extraction at lip 2.0 differs from the dense mesh")
    del dense

    # the CLI's choices against the dense path, in this run
    reset_counters()
    (mesh, timing), t_dense = _timed(lambda: extract_mesh(
        shape, params_shape, lat_shape, GRID_MIN, GRID_MAX, res, device=device,
        return_timing=True))
    _add(total, read_counters())
    streamed, t_stream = {}, {}
    for dt, name in ((None, "f32"), (np.float16, "f16")):
        reset_counters()
        with launches_by_shape(launches):
            streamed[name], t_stream[name] = _timed(lambda: extract_mesh_streamed(
                shape, params_shape, lat_shape, GRID_MIN, GRID_MAX, res, transfer_dtype=dt,
                device=device))
        _add(total, read_counters())
    tstats = {}
    reset_counters()
    with launches_by_shape(launches):
        _, t_sparse = _timed(lambda: sp.extract_mesh_sparse(
            shape, params_shape, lat_shape, GRID_MIN, GRID_MAX, res, lip="auto",
            transfer_dtype=np.float16, stats=tstats, device=device))
    _add(total, read_counters())
    log(f"[nphm-extract] res {res}, this run: dense extract_mesh {t_dense:.3f} s (grid "
        f"{timing['grid_s']:.3f} + marching {timing['march_s']:.3f}), streamed (8 slabs, tile "
        f"2048) f32 {t_stream['f32']:.3f} s, f16 {t_stream['f16']:.3f} s; sparse (lip auto, "
        f"f16) {t_sparse:.3f} s with {tstats['n_candidates']} of {tstats['n_blocks']} blocks "
        f"candidates ({tstats['n_candidates'] / tstats['n_blocks']:.4f}), "
        f"{tstats['n_transferred']} transferred, lip_auto {tstats['lip_auto']:.3f}, "
        f"lip_observed {tstats['lip_observed']:.3f}; vertices dense {len(mesh.vertices)}, "
        f"streamed f32 {len(streamed['f32'].vertices)}, f16 {len(streamed['f16'].vertices)}")
    expect(np.array_equal(_sorted_vertices(mesh), _sorted_vertices(streamed["f32"])),
           "streamed f32 at tile 2048 differs from extract_mesh")

    # K1 at its new launch shapes against the plain version
    cfg = shape.cfg
    lat = torch.tensor(lat_shape, device=device).reshape(-1)
    with torch.no_grad():
        operands = prepare_ensemble_operands(params_shape, cfg, lat)
    tile, brick = grid_tile(res, 2048)
    n_slabs = _pick_n_slabs(res, brick[0], 8)
    per = res**3 // n_slabs
    axes = grid_axes(GRID_MIN, GRID_MAX, res, device)
    slab = _brick_points(axes, torch.arange(per, device=device) + 3 * per, res, brick, tile)
    rows["ensemble_sdf@slab"] = k1_launch_row(shape, params_shape, lat, slab, tile, operands,
                                              f"slab (x-slab 3 of {n_slabs}, tile {tile})")
    del slab
    nb = sp._block_grid(res)
    ids = torch.arange(nb[0] * nb[1] * nb[2], device=device)
    coarse = sp._block_points(axes, ids, nb, sp._coarse_offsets(device))
    rows["ensemble_sdf@sparse_coarse"] = k1_launch_row(
        shape, params_shape, lat, coarse, sp._TILE, operands, "sparse_coarse")
    cmm = sp.coarse_pass(shape, params_shape, lat, axes, res, operands=operands)
    h = (np.asarray(GRID_MAX) - np.asarray(GRID_MIN)) / (res - 1)
    cand = sp.candidates(cmm.cpu().numpy(), stats["lip_auto"], h)
    expect(len(cand) == stats["n_candidates"], "the sparse candidate count differs")
    fine = sp._block_points(axes, torch.as_tensor(cand, device=device), nb,
                            sp._fine_offsets(device))
    rows["ensemble_sdf@sparse_fine"] = k1_launch_row(
        shape, params_shape, lat, fine, sp._TILE, operands,
        f"sparse_fine ({len(cand)} candidate blocks)")
    del fine
    cand2 = sp.candidates(cmm.cpu().numpy(), 2.0, h)
    expect(len(cand2) == lstats["n_candidates"], "the lip-2.0 candidate count differs")
    fine = sp._block_points(axes, torch.as_tensor(cand2, device=device), nb,
                            sp._fine_offsets(device))
    rows["ensemble_sdf@sparse_fine_lip2"] = k1_launch_row(
        shape, params_shape, lat, fine, sp._TILE, operands,
        f"sparse_fine_lip2 ({len(cand2)} of {len(ids)} blocks, lip 2.0)")
    del fine
    nb64 = sp._block_grid(64)
    probe = sp._block_points(grid_axes(GRID_MIN, GRID_MAX, 64, device),
                             torch.arange(nb64[0] * nb64[1] * nb64[2], device=device), nb64,
                             sp._fine_offsets(device))
    rows["ensemble_sdf@lip_probe"] = k1_launch_row(shape, params_shape, lat, probe, sp._TILE,
                                                   operands, "lip_probe (res 64)")

    # backward warp: K7 warps the brick-ordered grid, K1 evaluates it
    lat_full = np.concatenate([lat_shape.reshape(-1), lat_expr[0].reshape(-1)])
    reset_counters()
    bw, t_bw = _timed(lambda: backward_grid_logits(
        shape, expr, params_shape, params_expr, lat_shape, lat_full, GRID_MIN, GRID_MAX, res,
        anchors=anchors, device=device))
    c_bw = read_counters()
    _add(total, c_bw)
    launches["deepsdf_trunk@warp"] = c_bw["deepsdf_trunk"]
    anc = torch.tensor(anchors, device=device).reshape(1, -1, 3)
    lat_full_t = torch.tensor(lat_full, device=device)
    with torch.no_grad():
        cond = conditioning(params_expr, expr.cfg, lat_full_t[None], anc)[0]

    def plain_point_fn(ctx, pts):
        warped = pts + deepsdf_trunk_plain(params_expr["trunk"], expr.cfg.trunk_cfg, pts,
                                           cond)[:, :3]
        return nphm_sdf_plain(params_shape, cfg, warped, lat)

    lin = torch.arange(per, device=device) + 3 * per
    natural = torch.stack([axes[0][lin // res**2], axes[1][(lin // res) % res],
                           axes[2][lin % res]], dim=-1).cpu().numpy()
    plain_eval = make_point_evaluator(plain_point_fn, 1 << 18, 1, device)
    ref, t_plain = _timed(lambda: get_logits_backward(
        shape, expr, params_shape, params_expr, lat_shape, lat_full, natural,
        anchors=anchors, evaluator=plain_eval, device=device))
    err_bw = float(np.abs(bw[3 * per : 4 * per] - ref).max())
    log(f"[backward-warp] res {res}: {t_bw:.3f} s ({c_bw['deepsdf_trunk']} K7 warp chunks, "
        f"{c_bw['ensemble_sdf']} K1 launch); against get_logits_backward's plain path on "
        f"x-slab 3's {per} points ({t_plain:.3f} s): max|err| {err_bw:.3e} (tol {TOL_K1:g}); "
        f"{int((bw < 0).sum())} points inside")
    expect(bool(np.isfinite(bw).all()), "backward-warp logits are not finite")
    expect(err_bw <= TOL_K1, "backward-warp logits disagree with the plain path")
    del natural, ref, bw
    grid = _brick_points(axes, torch.arange(1 << 16, device=device), res, brick, tile)
    rows["deepsdf_trunk@warp"] = k7_launch_row(params_expr["trunk"], expr.cfg.trunk_cfg, grid,
                                               cond, "warp (one 65536-point chunk)", reps=5)

    # the NPM family through the same three paths
    n_shape, n_ps = npm[0], npm[1]
    nstats, _ = three_paths(n_shape, n_ps, npm_lat, device, "npm-extract", total, launches)
    reset_counters()
    (nmesh, ntiming), t_ndense = _timed(lambda: extract_mesh(
        n_shape, n_ps, npm_lat, GRID_MIN, GRID_MAX, res, device=device, return_timing=True))
    ntstats = {}
    with launches_by_shape(launches):
        nsparse, t_nsparse = _timed(lambda: sp.extract_mesh_sparse(
            n_shape, n_ps, npm_lat, GRID_MIN, GRID_MAX, res, lip="auto",
            transfer_dtype=np.float16, stats=ntstats, device=device))
    _add(total, read_counters())
    log(f"[npm-extract] res {res}, this run: dense extract_mesh {t_ndense:.3f} s (grid "
        f"{ntiming['grid_s']:.3f} + marching {ntiming['march_s']:.3f}); sparse (lip auto, f16) "
        f"{t_nsparse:.3f} s with {ntstats['n_candidates']} of {ntstats['n_blocks']} blocks "
        f"candidates ({ntstats['n_candidates'] / ntstats['n_blocks']:.4f}), "
        f"{ntstats['n_transferred']} transferred; vertices {len(nmesh.vertices)} and "
        f"{len(nsparse.vertices)}")
    n_lat = torch.tensor(npm_lat, device=device).reshape(-1)
    ncmm = sp.coarse_pass(n_shape, n_ps, n_lat, axes, res).cpu().numpy()
    ncand = sp.candidates(ncmm, nstats["lip_auto"], h)
    expect(len(ncand) == nstats["n_candidates"], "the NPM sparse candidate count differs")
    nfine = sp._block_points(axes, torch.as_tensor(ncand, device=device), nb,
                             sp._fine_offsets(device))
    rows["deepsdf_trunk@npm_sparse_fine"] = k7_launch_row(
        n_ps, n_shape.cfg, nfine, n_lat, f"npm_sparse_fine ({len(ncand)} candidate blocks)",
        reps=1)
    del nfine
    torch.cuda.empty_cache()
    log(f"[counters] extraction variants: {json.dumps(total)}; by launch shape "
        f"{json.dumps(launches)}")
    # the slab row times the streamed path's default tile
    counted_as = {"ensemble_sdf@slab": f"ensemble_sdf@slab_tile{tile}"}
    for key in sorted(set(rows) - own_rows):
        rows[key]["launches"] = launches.get(counted_as.get(key, key), 0)
        expect(rows[key]["launches"] > 0, f"{key}: no launch at this shape in phase 8")
    return total, {"dense": mesh, "streamed": streamed["f32"], "sparse_lip2": lmesh}


# ---------------------------------------------------------------------------
# Phase 9: the training pipeline through the CLIs
# ---------------------------------------------------------------------------

TRAIN_SUBJECTS = (351, 365) + tuple(range(400, 430))  # 32 training subjects
CHILD = """
import importlib, json, sys
sys.path.insert(0, {root!r})
import chip_smoke as c
import nphm_tpu_torch.training.trainer as T
train_model = T.AutoDecoderTrainer.train_model
def timed(self, epochs):
    train_model(self, epochs)
    print("STEP_MS " + json.dumps([1e3 * t for t in self._timer.times]), flush=True)
T.AutoDecoderTrainer.train_model = timed
c.reset_counters()
importlib.import_module({module!r}).main({argv!r})
print("CHILD_COUNTERS " + json.dumps(c.read_counters()), flush=True)
"""


def run_child(module, argv, env, cwd):
    """One CLI in a child process; returns (stdout lines, counters, step ms)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CHILD.format(root=ROOT, module=module,
                                                               argv=argv)],
                          cwd=cwd, capture_output=True, text=True,
                          env={**os.environ, **env}, timeout=900)
    wall = time.perf_counter() - t0
    expect(proc.returncode == 0, f"{module} failed (exit {proc.returncode}):\n"
           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    counts = [json.loads(ln.split(" ", 1)[1]) for ln in lines if ln.startswith("CHILD_COUNTERS ")]
    steps = [json.loads(ln.split(" ", 1)[1]) for ln in lines if ln.startswith("STEP_MS ")]
    expect(len(counts) == 1, f"{module} printed no launch counters")
    warned = [ln.strip() for ln in proc.stderr.splitlines() if "Warning" in ln]
    log(f"[train-cli] python -m {module} {' '.join(argv)}: exit 0 in {wall:.2f} s (child "
        f"process included); counters {json.dumps(counts[0])}; warnings {warned[:4]}")
    for line in lines:
        if line.startswith(("Epoch", "FIT_PHASE_TIMINGS", "exported ", "[fit_joint_batch]")):
            log(f"[train-cli]   {line}")
    return lines, counts[0], steps[0] if steps else []


def training_cli_path(tmp):
    """``python -m nphm_tpu_torch.train -local`` -> ``train_corresp -mode
    compress`` -> ``fitting_pointclouds -demo -sparse -batch_subjects 2
    -n_steps 50 -resolution 256``, each in a child process on a dummy tree
    of 32 training subjects and one validation subject (2 expressions
    each), at the widths of configs/nphm.yaml and configs/nphm_def.yaml,
    2 epochs, a checkpoint every epoch.  The tree, the experiments and the
    configs stay in the directory ``tmp`` for phase 12; returns (the
    children's counters, {"env", "def"}: the tree's environment and the
    stage-2 config's path)."""
    import numpy as np
    import yaml

    from nphm_tpu_torch.config import load_yaml
    from nphm_tpu_torch.data.dummy import dummy_env, generate_dummy_data
    from nphm_tpu_torch.utils.mesh_io import read_ply

    total = {}
    root = os.path.join(tmp, "dummy")
    generate_dummy_data(root, subjects=TRAIN_SUBJECTS + (199,), n_expressions=2,
                        n_supervision=4000)
    env = dummy_env(root)
    exp = env["NPHM_EXPERIMENT_DIR"]
    id_cfg = load_yaml(os.path.join(ROOT, "configs", "nphm.yaml"))
    id_cfg["training"].update(nepochs=2, ckpt_interval=1)
    def_cfg = load_yaml(os.path.join(ROOT, "configs", "nphm_def.yaml"))
    # the stage-1 model's own decoder block (configs/nphm_def.yaml's
    # id_decoder has another anchor-MLP width than configs/nphm.yaml)
    def_cfg["id_decoder"] = dict(id_cfg["decoder"])
    def_cfg["training"].update(nepochs=2, ckpt_interval=1, shape_exp_name="smoke_id",
                               shape_ckpt=1)
    fit_cfg = {"exp_name_shape": "smoke_id", "checkpoint_shape": 1, "mode": "compress",
               "local_shape": True, "local_expr": False, "exp_name_expr": "smoke_def",
               "checkpoint_expr": 1}
    paths = {}
    for name, cfg in (("id", id_cfg), ("def", def_cfg), ("fit", fit_cfg)):
        paths[name] = os.path.join(tmp, f"{name}.yaml")
        with open(paths[name], "w") as f:
            yaml.safe_dump(cfg, f)

    _, c1, steps1 = run_child("nphm_tpu_torch.train",
                              ["-exp_name", "smoke_id", "-cfg_file", paths["id"], "-local"],
                              env, tmp)
    for name in ("train_fwd", "train_bwd", "ensemble_sdf"):
        expect(c1[name] > 0, f"kernel {name} was not launched by the stage-1 CLI")
    _, c2, steps2 = run_child("nphm_tpu_torch.train_corresp",
                              ["-exp_name", "smoke_def", "-cfg_file", paths["def"],
                               "-mode", "compress"], env, tmp)
    for name in ("deepsdf_trunk", "ensemble_sdf"):
        expect(c2[name] > 0, f"kernel {name} was not launched by the stage-2 CLI")
    lines, c3, _ = run_child("nphm_tpu_torch.fitting_pointclouds",
                             ["-cfg_file", paths["fit"], "-exp_name", "smoke_train",
                              "-exp_tag", "demo", "-demo", "-sparse", "-batch_subjects",
                              "2", "-n_steps", str(CLI_STEPS), "-resolution",
                              str(EXTRACT_RES)], env, tmp)
    for name in ("broyden_search", "fit_fwd", "fit_bwd", "deepsdf_trunk"):
        expect(c3[name] > 0, f"kernel {name} was not launched by the sparse fitting CLI")
    expect(c3["ensemble_sdf"] >= 4, "the sparse fitting CLI did not launch K1's coarse "
           "and fine passes for both subjects")
    for name in ("smoke_id", "smoke_def"):
        ckpts = sorted(os.listdir(os.path.join(exp, name, "checkpoints")))
        expect(ckpts == ["checkpoint_epoch_0.pkl", "checkpoint_epoch_1.pkl"],
               f"{name}: checkpoints {ckpts}")
    recs = {}
    for name, sub in (("smoke_id", "epoch_1"), ("smoke_def", "val_epoch_1")):
        d = os.path.join(exp, name, "recs", sub)
        recs[name] = {f: len(read_ply(os.path.join(d, f)).vertices)
                      for f in sorted(os.listdir(d))}
        expect(bool(recs[name]) and all(n > 0 for n in recs[name].values()),
               f"{name}: empty reconstruction logs {recs[name]}")
    out_dir = os.path.join(env["NPHM_FITTING_DIR"], "forward_smoke_train", "demo")
    n_verts = []
    for subj in (351, 365):
        for e in (0, 1):
            mesh = read_ply(os.path.join(out_dir, f"{subj}_{e}.ply"))
            expect(len(mesh.vertices) > 0 and bool(np.isfinite(mesh.vertices).all()),
                   f"empty or non-finite sparse-extracted mesh {subj}_{e}.ply")
            n_verts.append(len(mesh.vertices))
    for c in (c1, c2, c3):
        _add(total, c)
    mean2 = float(np.mean(steps2[1:])) if len(steps2) > 1 else float("nan")
    log(f"[train-cli] stage-1 step ms {[round(t, 3) for t in steps1]}; stage-2 step ms at "
        f"batch 32 {[round(t, 3) for t in steps2]} (steady mean {mean2:.3f} ms, first step "
        f"excluded); reconstruction logs (vertices) {json.dumps(recs)}; sparse-extracted "
        f"posed meshes {n_verts} vertices")
    log(f"[counters] training CLIs: {json.dumps(total)}")
    return total, {"env": env, "def": paths["def"]}


# ---------------------------------------------------------------------------
# Phase 10: evaluation and the protocol
# ---------------------------------------------------------------------------

NN_POINTS = 250_000  # the reference's eval draws
NN_TIE = 1e-6  # two reference points this close in distance may swap
NN_TOL = 1e-5  # max |dist - scipy|
PROTOCOL_ARGS = ["--fit_subjects", "2", "--n_train_subjects", "4", "--train_epochs", "2",
                 "--def_epochs", "2", "--fit_steps", "100", "--resolution", "256",
                 "--num_samps", "25000"]
# At its config's lr the NPM field of 4 subjects first has a zero set by
# epoch 51-101, depending on the init draw (PERF.md, section 6); 151
# epochs take ~9 s on the card.
NPM_TRAIN_EPOCHS = 151
PROTOCOL_CHILD = """
import json, subprocess, sys
sys.path.insert(0, {root!r})
import chip_smoke as c
import nphm_tpu_torch.protocol_e2e as p

def run_cli(module, argv, env, timeout=7200):
    code = c.CHILD.format(root={root!r}, module=module, argv=list(argv))
    proc = subprocess.run([sys.executable, "-c", code], cwd={root!r}, env=env,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"CLI failed: {{module}}\\n{{proc.stdout[-3000:]}}\\n"
                           f"{{proc.stderr[-3000:]}}")
    counts = [ln.split(" ", 1)[1] for ln in proc.stdout.splitlines()
              if ln.startswith("CHILD_COUNTERS ")]
    print("STAGE_COUNTERS " + module + " " + counts[-1], flush=True)
    return proc.stdout

p.run_cli = run_cli
p.main({argv!r})
"""


def nn_clouds(seed: int, n: int):
    """A noisy sphere of radius 10 (a head's scale in millimetres / 10)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (d * (10.0 + rng.normal(size=(n, 1)) * 0.05)).astype(np.float32)


def nn_check():
    """``nearest_neighbors(backend="device")`` on two seeded 250k-point
    clouds, both directions, against scipy's cKDTree: indices equal but for
    near-ties, distances within NN_TOL; the same result with the caller's
    TF32 flag on, which the function neither reads nor sets."""
    import numpy as np
    import torch
    from scipy.spatial import cKDTree

    from nphm_tpu_torch.evaluation.nn import nearest_neighbors

    a, b = nn_clouds(1, NN_POINTS), nn_clouds(2, NN_POINTS)
    out = {}
    for tag, (q, r) in (("a->b", (a, b)), ("b->a", (b, a))):
        t0 = time.perf_counter()
        d_sp, i_sp = cKDTree(r).query(q)
        scipy_s = time.perf_counter() - t0
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        d, i = nearest_neighbors(q, r, backend="device")
        stop.record()
        torch.cuda.synchronize()
        card_s = start.elapsed_time(stop) / 1e3
        flag = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            d32, i32 = nearest_neighbors(q, r, backend="device")
            expect(torch.backends.cuda.matmul.allow_tf32, "nearest_neighbors reset the TF32 flag")
        finally:
            torch.backends.cuda.matmul.allow_tf32 = flag
        expect(np.array_equal(d32, d) and np.array_equal(i32, i),
               f"{tag}: the caller's TF32 flag changed the result")
        expect(d.dtype == np.float64 and i.dtype == np.int64, f"{tag}: dtypes {d.dtype}, {i.dtype}")
        diff = np.flatnonzero(i != i_sp)
        ties = np.abs(np.linalg.norm(q[diff].astype(np.float64) - r[i[diff]], axis=-1)
                      - np.linalg.norm(q[diff].astype(np.float64) - r[i_sp[diff]], axis=-1))
        expect(bool((ties <= NN_TIE).all()), f"{tag}: {int((ties > NN_TIE).sum())} indices "
               f"differ from scipy's beyond a {NN_TIE:g} tie")
        err = float(np.abs(d - d_sp).max())
        expect(err <= NN_TOL, f"{tag}: max |dist - scipy| {err:.3e} > {NN_TOL:g}")
        out[tag] = {"max_abs_err": err, "index_ties": int(len(diff)), "card_s": card_s,
                    "scipy_s": scipy_s, "pairs_per_s_card": len(q) * len(r) / card_s,
                    "pairs_per_s_scipy": len(q) * len(r) / scipy_s}
        log(f"[nn] {tag} {len(q)} x {len(r)}: max |dist - scipy| {err:.3e} (<= {NN_TOL:g}), "
            f"{len(diff)} indices differ at ties <= {NN_TIE:g}; card {card_s:.4f} s (CUDA "
            f"events, transfers included), scipy cKDTree {scipy_s:.4f} s (host clock, build "
            f"and query); TF32 flag on: identical")
    return out


def raster_check():
    """Render samples of a res-128 mesh: bit-identical at one rasterizer
    thread and at the default count."""
    import numpy as np

    from nphm_tpu_torch.evaluation.render import gen_render_samples
    from nphm_tpu_torch.ops.marching import marching_tets
    from nphm_tpu_torch.utils.mesh_io import Mesh

    res = 128
    ax = np.linspace(-1, 1, res, dtype=np.float32)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    sdf = np.linalg.norm(np.stack([X / 0.45, Y / 0.5, Z / 0.4], -1), axis=-1) - 1.0
    v, f = marching_tets(-sdf, 0.0)
    mesh = Mesh((v * (2.0 / (res - 1)) - 1.0).astype(np.float32), f.astype(np.int64))
    outs = {}
    saved = os.environ.pop("NPHM_RASTER_THREADS", None)
    try:
        for threads in ("1", None):
            if threads:
                os.environ["NPHM_RASTER_THREADS"] = threads
            else:
                os.environ.pop("NPHM_RASTER_THREADS", None)
            t0 = time.perf_counter()
            pts, nrm = gen_render_samples(mesh, 10)
            outs[threads or "default"] = (pts.copy(), nrm.copy(), time.perf_counter() - t0)
    finally:
        os.environ.pop("NPHM_RASTER_THREADS", None)
        if saved is not None:
            os.environ["NPHM_RASTER_THREADS"] = saved
    (p1, n1, s1), (pd, nd, sd) = outs["1"], outs["default"]
    expect(len(p1) > 0 and np.array_equal(p1, pd) and np.array_equal(n1, nd),
           "render samples differ between 1 rasterizer thread and the default count")
    log(f"[raster] res-{res} mesh ({len(mesh.faces)} faces), 10 views: {len(p1)} samples, "
        f"bit-identical at 1 thread ({s1:.3f} s) and {os.cpu_count()} ({sd:.3f} s)")
    return {"samples": len(p1), "one_thread_s": s1, "default_s": sd}


def protocol_run(family: str):
    """``python -m nphm_tpu_torch.protocol_e2e --family F`` in a child, each
    stage a grandchild that reports its launch counters; returns the JSON
    line and the counters by stage."""
    import csv
    import math

    from nphm_tpu_torch import env_paths

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "proto")
        argv = ["--family", family, "--root", root] + PROTOCOL_ARGS
        if family == "npm":
            argv += ["--train_epochs", str(NPM_TRAIN_EPOCHS)]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", PROTOCOL_CHILD.format(root=ROOT, argv=argv)],
                              cwd=tmp, capture_output=True, text=True, timeout=1200)
        wall = time.perf_counter() - t0
        expect(proc.returncode == 0, f"protocol {family} failed (exit {proc.returncode}):\n"
               f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        lines = proc.stdout.splitlines()
        stages = {}
        for ln in lines:
            if ln.startswith("STAGE_COUNTERS "):
                _, module, counts = ln.split(" ", 2)
                stages[module.rsplit(".", 1)[1]] = json.loads(counts)
        out = json.loads(lines[-1])
        log(f"[protocol] {family}: {lines[-1]}")
        log(f"[protocol] {family}: {wall:.2f} s (child process included); phase walls: "
            + ", ".join(f"{k} {out.get(k)} s" for k in ("dataset_s", "train_s", "def_train_s",
                                                       "fit_extract_s", "eval_s", "gather_s")))
        log(f"[protocol] {family}: counters by stage {json.dumps(stages)}")
        expect(sorted(stages) == ["eval", "fitting_pointclouds", "gather", "train",
                                  "train_corresp"], f"stages run: {sorted(stages)}")
        expect(out["crashes"] == 0, f"{family}: {out['crashes']} crashes")
        result_dir = os.path.join(root, "fitting", "forward_proto", "protocol")
        scans = [(s, e) for s in env_paths.subjects_test[:2]
                 for e in range(4) if e not in env_paths.invalid_expressions_test.get(s, [])]
        expect(out["n_fitted_meshes"] == len(scans) and out["n_empty_meshes"] == 0,
               f"{family}: {out['n_fitted_meshes']} meshes, {out['n_empty_meshes']} empty; "
               f"expected {len(scans)} non-empty")
        for s, e in scans:
            head = open(os.path.join(result_dir, f"{s}_{e}.ply"), "rb").read(512)
            expect(b"element vertex 0\n" not in head, f"{family}: {s}_{e}.ply is empty")
            for name in ("metrics.json", "metrics_face.json"):
                path = os.path.join(result_dir, "evaluation", str(s), f"expression_{e}", name)
                expect(os.path.exists(path), f"{family}: no {path}")
        for name in ("total_merics.csv", "total_metrics_face.csv"):
            with open(os.path.join(result_dir, "evaluation", name)) as f:
                rows = list(csv.DictReader(f))
            expect(len(rows) == 1 and all(math.isfinite(float(v)) for v in rows[0].values()),
                   f"{family}: {name} does not parse to one finite row")
    moved = [("train", "train_fwd"), ("train", "train_bwd"),
             ("fitting_pointclouds", "deepsdf_trunk")]
    if family == "nphm":
        moved += [("train", "ensemble_sdf"), ("fitting_pointclouds", "broyden_search"),
                  ("fitting_pointclouds", "fit_fwd"), ("fitting_pointclouds", "fit_bwd"),
                  ("fitting_pointclouds", "ensemble_sdf"), ("train_corresp", "deepsdf_trunk")]
    else:  # the NPM family: its grids and posing run K7, its fit no K2
        moved = [("train", "deepsdf_trunk"), ("train_corresp", "deepsdf_trunk"),
                 ("fitting_pointclouds", "deepsdf_trunk")]
        expect(stages["fitting_pointclouds"]["broyden_search"] == 0,
               "K2 was launched on the NPM family's offsets trunk")
    for stage, name in moved:
        expect(stages[stage][name] > 0, f"{family}: {stage} did not launch {name}")
    total = {}
    for counts in stages.values():
        _add(total, counts)
    return out, stages, total, wall


def evaluation_path():
    """Phase 10: nearest neighbours on the card, the rasterizer's thread
    invariance and the protocol of both families."""
    nn = nn_check()
    raster = raster_check()
    total, runs = {}, {}
    # the two children share the card and the host; each is a chain of
    # short processes that leaves both mostly idle
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        results = dict(zip(("nphm", "npm"), pool.map(protocol_run, ("nphm", "npm"))))
    for family, (out, _stages, counts, wall) in results.items():
        runs[family] = {"wall_s": wall, **out}
        _add(total, counts)
    log(f"[counters] protocol children: {json.dumps(total)}")
    return total, {"nn": nn, "raster": raster, "protocol": runs}


# ---------------------------------------------------------------------------
# Phase 11: the synthetic quality run at production widths
# ---------------------------------------------------------------------------

# The full run is 1500 / 300 epochs and 500 fit steps; cut here to keep the
# phase near a minute.  Stage 2 keeps a third of its epochs: the posed mesh
# must already be closer to the posed surface than the neutral one.
SYNTH_ARGS = ["--epochs", "200", "--def_epochs", "100", "--fit_steps", "100"]
SYNTH_KEYS = ("backend", "production_dims", "train_s", "train_steps", "recon_extract_s",
              "recon_chamfer", "fit_s", "heldout_fit_chamfer", "def_train_s",
              "def_neutral_chamfer_vs_posed", "def_deformed_chamfer_vs_posed",
              "joint_fit_s", "joint_canonical_chamfer", "joint_posed_chamfer", "total_s")


def synthetic_path():
    """Phase 11: ``synthetic_e2e`` at production widths in a child that
    reports its launch counters."""
    import math

    with tempfile.TemporaryDirectory() as tmp:
        lines, counts, steps = run_child("nphm_tpu_torch.synthetic_e2e", SYNTH_ARGS, {}, tmp)
    rows = [ln for ln in lines if ln.startswith("{")]
    expect(len(rows) == 1, f"synthetic_e2e printed {len(rows)} JSON lines")
    out = json.loads(rows[0])
    log(f"[synthetic] {rows[0]}")
    expect(sorted(out) == sorted(SYNTH_KEYS), f"synthetic_e2e keys {sorted(out)}")
    expect(out["production_dims"] is True, "synthetic_e2e did not run at production widths")
    chamfers = [k for k in SYNTH_KEYS if "chamfer" in k]
    expect(all(math.isfinite(out[k]) for k in chamfers),
           f"non-finite Chamfer: {[(k, out[k]) for k in chamfers]}")
    expect(out["def_deformed_chamfer_vs_posed"] < out["def_neutral_chamfer_vs_posed"],
           "the posed mesh is no closer to the posed surface than the neutral one")
    for name in KERNELS:
        expect(counts[name] > 0, f"synthetic_e2e did not launch {name}")
    log(f"[synthetic] stage-1 step ms: first {[round(t, 2) for t in steps[:3]]}, "
        f"last {[round(t, 2) for t in steps[-3:]]}")
    log(f"[counters] synthetic_e2e child: {json.dumps(counts)}")
    return counts


# ---------------------------------------------------------------------------
# Phase 12: the GNN and interpolate deformation modes
# ---------------------------------------------------------------------------

MODES = {"GNN": SEED + 20, "interpolate": SEED + 21}  # mode: its field's init seed
MODE_TRAIN_STEPS = 20
MODE_FIT_STEPS = 50
K7_POSE_POINTS = 1 << 16  # one posing chunk


def build_mode_models(models, device):
    """Phase 2's NPHM identity with a seeded GNN and interpolate field each,
    at the widths of configs/nphm_def.yaml; {mode: models tuple}."""
    import torch

    from nphm_tpu_torch.config import deformation_config_from_yaml, load_yaml
    from nphm_tpu_torch.models import make_deformation_decoder

    shape, params_shape = models[0], models[1]
    cfg = load_yaml(os.path.join(ROOT, "configs", "nphm_def.yaml"))
    out = {}
    for mode, seed in MODES.items():
        expr = make_deformation_decoder(deformation_config_from_yaml(cfg, mode))
        gen = torch.Generator().manual_seed(seed)
        out[mode] = (shape, params_shape, expr, expr.init(gen, device), gen)
        log(f"[models] {mode} deformation field: trunk layers "
            f"{expr.cfg.trunk_cfg.layer_shapes[0]}")
    return out


def check_gnn_kernels(models, device, rows):
    """K2 at the batched fit's shape (``check_k2_batched``, row
    ``broyden_search@gnn_batched``) and K7 on a 65 536-point posing chunk
    (row ``deepsdf_trunk@gnn_pose``) under a GNN field's conditioning,
    whose 400 columns make the trunk's third layer 109 wide."""
    import torch

    from nphm_tpu_torch.models.deformation import conditioning
    from nphm_tpu_torch.models.ensemble import predict_anchors

    check_k2_batched(models, device, rows, "broyden_search@gnn_batched", " GNN")
    shape, params_shape, expr, params_expr, gen = models
    pts = torch.tensor(observations(1, K7_POSE_POINTS, SEED + 22)[0], device=device)
    lat_s = (torch.randn((1, shape.lat_dim), generator=gen) * 0.01).to(device)
    lat_e = (torch.randn((1, expr.lat_dim), generator=gen) * 0.01).to(device)
    with torch.no_grad():
        anchors = predict_anchors(params_shape, shape.cfg, lat_s)
        cond = conditioning(params_expr, expr.cfg, torch.cat([lat_s, lat_e], -1), anchors)[0]
    rows["deepsdf_trunk@gnn_pose"] = k7_launch_row(
        params_expr["trunk"], expr.cfg.trunk_cfg, pts, cond, "GNN 6x512, posing chunk", 5)


def mode_train_steps(models, device, mode):
    """MODE_TRAIN_STEPS ``DeformationTrainer`` steps at B=32 scans x 1000
    points on ``SyntheticDeformationDataset`` (32 ellipsoid heads, one
    warp each: every step sees the same scans, the points drawn anew),
    frozen identity codes drawn from the seed.  The loss of one fixed batch
    must be finite and fall over the steps."""
    import numpy as np
    import torch

    from nphm_tpu_torch.config import load_yaml
    from nphm_tpu_torch.data.synthetic import (
        SyntheticDeformationDataset,
        SyntheticIdentityDataset,
    )
    from nphm_tpu_torch.training.trainer_corresp import DeformationTrainer

    shape, params_shape, expr, params_expr, gen = models
    train = SyntheticDeformationDataset(SyntheticIdentityDataset(n_subjects=32, seed=SEED),
                                        n_expressions=1, n_points=1000, batch_size=32,
                                        warp_scale=0.08)
    val = SyntheticDeformationDataset(SyntheticIdentityDataset(n_subjects=2, seed=SEED + 1),
                                      n_expressions=1, n_points=1000, batch_size=2, seed=9)
    cfg = load_yaml(os.path.join(ROOT, "configs", "nphm_def.yaml"))
    shape_state = {"params": params_shape,
                   "latents": torch.randn((32, shape.lat_dim), generator=gen) * 0.01,
                   "latents_val": torch.randn((2, shape.lat_dim), generator=gen) * 0.01}
    with tempfile.TemporaryDirectory() as tmp:
        tr = DeformationTrainer(expr, params_expr, shape, cfg, train, val, f"smoke_{mode}",
                                exp_dir=tmp, shape_state=shape_state, seed=SEED,
                                device=device)
        fixed = tr._batch(next(iter(train.batch_iter(seed=0))))

        def fixed_loss():
            with torch.no_grad():
                return float(tr._loss(tr.params, tr.latents, fixed, val=False)[0])

        before = fixed_loss()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [tr._train_step(tr._batch(b), tr.lr_at(0), tr.lr_lat_at(0))["loss"]
                  for epoch in range(MODE_TRAIN_STEPS) for b in train.batch_iter(seed=epoch)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = fixed_loss()
    losses = [float(x) for x in losses]
    log(f"[{mode}] {len(losses)} stage-2 steps at B=32 x 1000 in {wall:.2f} s: step losses "
        f"{[round(x, 6) for x in losses]}; loss of one fixed batch {before:.6f} -> "
        f"{after:.6f}")
    expect(len(losses) == MODE_TRAIN_STEPS and bool(np.isfinite(losses + [after]).all()),
           f"{mode}: stage-2 loss not finite")
    expect(after < before, f"{mode}: the stage-2 loss did not fall")


def mode_path(models, device, mode):
    """Phase 12 for one mode: ``mode_train_steps``; ``fit_joint_batch`` on
    8 subjects x 20 scans x 2500 points for MODE_FIT_STEPS steps;
    ``extract_mesh`` at res 256 of subject 0 and ``deform_mesh_batch`` over
    its 20 expressions.  GNN must launch K1-K4 and K7 and hold 5 batched
    steps through the kernels against the plain path; interpolate must
    launch K1, K3 and K4 and neither K2 nor K7 (its per-point conditioning
    runs the plain search and the plain posing, decided from the config).
    Returns the launch counters and, for GNN, K2's and K7's launches."""
    import numpy as np
    import torch

    from nphm_tpu_torch.fitting import FittingConfig, fit_joint_batch
    from nphm_tpu_torch.reconstruction.extract import deform_mesh_batch, extract_mesh

    shape, params_shape, expr, params_expr, _gen = models
    mode_train_steps(models, device, mode)
    subjects = batch_observations()
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lat_exprs, lat_shapes, anchors, hist = fit_joint_batch(
        shape, params_shape, expr, params_expr, subjects,
        cfg=FittingConfig(n_steps=MODE_FIT_STEPS, seed=SEED), device=device, verbose=False)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    fit_counts = read_counters()
    loss = hist["loss"]
    expect(bool(np.isfinite(loss).all()), f"{mode}: batched fit loss not finite")
    expect(all(np.isfinite(x).all() for x in lat_exprs + lat_shapes + anchors),
           f"{mode}: batched fit latents not finite")
    t0 = time.perf_counter()
    mesh = extract_mesh(shape, params_shape, lat_shapes[0], GRID_MIN, GRID_MAX, EXTRACT_RES,
                        device=device)
    t_ext = time.perf_counter() - t0
    expect(len(mesh.vertices) > 0, f"{mode}: extracted mesh is empty")
    before = read_counters()["deepsdf_trunk"]
    t0 = time.perf_counter()
    posed = deform_mesh_batch(mesh, expr, params_expr, lat_exprs[0], anchors=anchors[0],
                              lat_shape=lat_shapes[0], device=device)
    t_def = time.perf_counter() - t0
    counts = read_counters()
    moved = float(np.abs(posed[0].vertices - mesh.vertices).max())
    expect(len(posed) == len(subjects[0]) and all(np.isfinite(m.vertices).all()
                                                   for m in posed),
           f"{mode}: posed meshes missing or not finite")
    log(f"[{mode}] batched fit {BATCH_SUBJECTS} subjects x {MODE_FIT_STEPS} steps in "
        f"{t_fit:.2f} s (steady {hist['steady_subject_steps_s']:.2f} subject-steps/s); loss "
        f"mean {float(loss[0].mean()):.5f} -> {float(loss[-1].mean()):.5f}; Broyden "
        f"iterations mean {float(hist['broyden_iters'].mean()):.2f}; res-{EXTRACT_RES} "
        f"extraction {t_ext:.2f} s, {len(mesh.vertices)} vertices; {len(posed)} expressions "
        f"posed in {t_def:.2f} s (largest offset {moved:.4f})")
    log(f"[counters] {mode}: fit {json.dumps(fit_counts)}; fit, extraction and posing "
        f"{json.dumps(counts)}")
    if mode == "interpolate":
        for name in ("ensemble_sdf", "fit_fwd", "fit_bwd"):
            expect(counts[name] > 0, f"interpolate: kernel {name} was not launched")
        for name in ("broyden_search", "deepsdf_trunk"):
            expect(counts[name] == 0, f"interpolate: kernel {name} was launched "
                   f"{counts[name]} times on per-point conditioning")
        return counts, {}
    for name in ("ensemble_sdf", "broyden_search", "fit_fwd", "fit_bwd", "deepsdf_trunk"):
        expect(counts[name] > 0, f"GNN: kernel {name} was not launched")
    steps, nb, npp = 5, 5, 1000
    rng = np.random.default_rng(SEED + 23)
    draws = (rng.integers(0, len(subjects[0]), size=(steps, BATCH_SUBJECTS, nb)),
             rng.integers(0, len(subjects[0][0]), size=(steps, BATCH_SUBJECTS, nb, npp)))
    init = (rng.normal(size=(BATCH_SUBJECTS, shape.lat_dim)) * LAT_INIT_STD).astype(np.float32)
    out = {m: fit_batch(models, subjects, device, m, steps, init, draws)
           for m in ("auto", "off")}
    errs, close = fit_diffs(out["auto"], out["off"])
    h, rh = out["auto"][3], out["off"][3]
    log(f"[GNN] {steps} batched steps, kernels vs plain path: max|diff| {json.dumps(errs)}; "
        f"iterations kernel {h['broyden_iters'].tolist()} plain "
        f"{rh['broyden_iters'].tolist()} (rtol {TOL_FIT_RTOL:g}, atol {TOL_FIT_ATOL:g})")
    expect(close, "GNN: the batched kernel fit disagrees with the plain path")
    expect(bool(np.all(np.abs(h["n_valid"] - rh["n_valid"]) <= TOL_K2_NVALID * nb * npp)),
           "GNN: the batched kernel fit's n_valid disagrees with the plain path's")
    return counts, {"broyden_search@gnn_batched": fit_counts["broyden_search"],
                    "deepsdf_trunk@gnn_pose": counts["deepsdf_trunk"] - before}


def mode_cli_path(tmp, tree):
    """``train_corresp -mode GNN`` for 1 epoch on phase 9's tree and
    stage-1 experiment, then ``fitting_pointclouds -demo -batch_subjects 2
    -n_steps 20 -resolution 128`` on it, each in a child: exit 0, a config
    snapshot in GNN mode, non-empty ``log_recs`` and fitted meshes, and
    the children's K2 and K7 launched."""
    import numpy as np
    import yaml

    from nphm_tpu_torch.config import load_yaml
    from nphm_tpu_torch.utils.mesh_io import read_ply

    env = tree["env"]
    exp = env["NPHM_EXPERIMENT_DIR"]
    def_cfg = load_yaml(tree["def"])
    def_cfg["training"].update(nepochs=1)
    fit_cfg = {"exp_name_shape": "smoke_id", "checkpoint_shape": 1, "local_shape": True,
               "local_expr": False, "exp_name_expr": "smoke_gnn", "checkpoint_expr": 0}
    paths = {}
    for name, cfg in (("def_gnn", def_cfg), ("fit_gnn", fit_cfg)):
        paths[name] = os.path.join(tmp, f"{name}.yaml")
        with open(paths[name], "w") as f:
            yaml.safe_dump(cfg, f)
    _, c1, _ = run_child("nphm_tpu_torch.train_corresp",
                         ["-exp_name", "smoke_gnn", "-cfg_file", paths["def_gnn"], "-mode",
                          "GNN"], env, tmp)
    _, c2, _ = run_child("nphm_tpu_torch.fitting_pointclouds",
                         ["-cfg_file", paths["fit_gnn"], "-exp_name", "smoke_gnn_fit",
                          "-exp_tag", "demo", "-demo", "-batch_subjects", "2", "-n_steps",
                          "20", "-resolution", "128"], env, tmp)
    with open(os.path.join(exp, "smoke_gnn", "configs.yaml")) as f:
        expect(yaml.safe_load(f)["ex_decoder"]["mode"] == "GNN", "no GNN config snapshot")
    expect(os.listdir(os.path.join(exp, "smoke_gnn", "checkpoints"))
           == ["checkpoint_epoch_0.pkl"], "train_corresp -mode GNN wrote no checkpoint")
    d = os.path.join(exp, "smoke_gnn", "recs", "val_epoch_0")
    recs = {f: len(read_ply(os.path.join(d, f)).vertices) for f in sorted(os.listdir(d))}
    expect(bool(recs) and all(n > 0 for n in recs.values()), f"GNN log_recs empty: {recs}")
    out_dir = os.path.join(env["NPHM_FITTING_DIR"], "forward_smoke_gnn_fit", "demo")
    n_verts = []
    for subj in (351, 365):
        for e in (0, 1):
            mesh = read_ply(os.path.join(out_dir, f"{subj}_{e}.ply"))
            expect(len(mesh.vertices) > 0 and bool(np.isfinite(mesh.vertices).all()),
                   f"GNN fitting CLI: empty or non-finite mesh {subj}_{e}.ply")
            n_verts.append(len(mesh.vertices))
    expect(c1["deepsdf_trunk"] > 0, "train_corresp -mode GNN did not launch K7 (log_recs)")
    expect(c2["broyden_search"] > 0 and c2["deepsdf_trunk"] > 0,
           "the GNN fitting CLI did not launch K2 and K7")
    log(f"[GNN-cli] log_recs (vertices) {json.dumps(recs)}; fitted posed meshes {n_verts} "
        "vertices")
    total = {}
    for c in (c1, c2):
        _add(total, c)
    return total


def modes_path(models, device, rows, tree_dir, tree):
    """Phase 12: ``check_gnn_kernels``, ``mode_path`` per mode, then
    ``mode_cli_path``; returns the summed launch counters.  The GNN rows
    of the table carry their own launches (the GNN fit's K2, its posing's
    K7)."""
    mode_models = build_mode_models(models, device)
    check_gnn_kernels(mode_models["GNN"], device, rows)
    total = {}
    for mode in MODES:
        counts, own = mode_path(mode_models[mode], device, mode)
        _add(total, counts)
        for key, n in own.items():
            rows[key]["launches"] = n
    _add(total, mode_cli_path(tree_dir, tree))
    log(f"[counters] phase 12: {json.dumps(total)}")
    return total


# ---------------------------------------------------------------------------
# Phase 13: data parallelism
# ---------------------------------------------------------------------------

DP_STEPS = 3  # training steps of each trainer, DP against one process
DP_FIT_STEPS = 50
DP_FIT_CHECK_STEPS = 5  # phase 7's: the sharded fit held elementwise against one process
DP_DEVICE = "cuda"  # the ranks' device type ("cpu" rehearses phase 13 off the card)
DP_TRAIN_KEYS = ("params", "latents", "latents_val")


def _quiet_logger():
    from nphm_tpu_torch.utils.logging_utils import MetricsLogger

    return MetricsLogger(quiet=True)


def _replica_equal(flat, mesh) -> bool:
    """Is this rank's flat tensor bit-equal to rank 0's?"""
    import torch
    import torch.distributed as dist

    flat = flat.to(mesh.device)
    ref = flat.clone()
    dist.broadcast(ref, src=0, group=mesh.group)
    return bool(torch.equal(flat, ref))


def _state_flats(tr):
    import torch

    state = tr.state_dict()
    return {k: torch.as_tensor(_flat_leaves(state[k])) for k in DP_TRAIN_KEYS}


def _dp_steps(make, batches, val_batch, mesh):
    """DP_STEPS train steps and a validation step of the trainer ``make(mesh)``
    builds; (state flats before and after, one-device loss terms per step,
    step ms, launch counts)."""
    import torch

    from nphm_tpu_torch.parallel import all_reduce_mean

    with tempfile.TemporaryDirectory() as tmp:
        tr = make(mesh, tmp)
        before = _state_flats(tr)
        lr, lr_lat = tr.lr_at(0), tr.lr_lat_at(0)
        reset_counters()
        terms, times = [], []
        for b in batches + [val_batch]:
            batch = tr._batch(b)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if b is val_batch:
                t = tr._val_step(batch, lr_lat)
            else:
                t = tr._train_step(batch, lr, lr_lat)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            keys = sorted(t)
            vec = torch.stack([t[k].reshape(()) for k in keys])
            if mesh is not None:
                all_reduce_mean(vec, mesh)
            terms.append(dict(zip(keys, vec.tolist())))
        counts = read_counters()
        return before, _state_flats(tr), terms, times, counts


def _dp_against_single(make, batches, val_batch, mesh):
    """Every rank's DP steps, then rank 0's one-process steps from the same
    start: replicas bit-equal, the change of each state against the
    one-process change (|d_dp - d_1| / |d_1|), the loss terms."""
    import numpy as np

    before, after, terms, times, counts = _dp_steps(make, batches, val_batch, mesh)
    out = {"counts": counts, "step_ms": times,
           "replicas_equal": all(_replica_equal(after[k], mesh) for k in DP_TRAIN_KEYS)}
    if mesh.rank == 0:
        b1, a1, terms1, times1, _ = _dp_steps(make, batches, val_batch, None)
        out["same_start"] = all(bool((before[k] == b1[k]).all()) for k in DP_TRAIN_KEYS)
        out["rel_update"] = {k: float(np.linalg.norm((after[k] - before[k] - a1[k] + b1[k])
                                                     .numpy())
                                      / max(np.linalg.norm((a1[k] - b1[k]).numpy()), 1e-30))
                             for k in DP_TRAIN_KEYS}
        out["rel_terms"] = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                               for a, b in zip(terms, terms1) for k in b)
        out["single_step_ms"] = times1
    return out


def dp_identity(models, device, mesh):
    """DP_STEPS ``IdentityTrainer`` steps at B=32 (K5/K6 on each rank's 32/W
    rows) and a validation step at B=32, against one process."""
    from nphm_tpu_torch.training.trainer import IdentityTrainer

    shape, params_shape = models[0], models[1]
    train_ds, val_ds = identity_sets(64, 32, 32)
    batches = [next(iter(train_ds.batch_iter(seed=e))) for e in range(DP_STEPS)]
    val_batch = next(iter(val_ds.batch_iter(seed=0)))

    def make(m, tmp):
        tr = IdentityTrainer(shape, params_shape, train_config(ckpt_interval=10**9), train_ds,
                             val_ds, "dp", exp_dir=tmp, logger=_quiet_logger(),
                             recon_resolution=32, seed=SEED, device=device, mesh=m)
        expect(tr._fields_fn is not None, "the DP trainer did not route to K5/K6")
        return tr

    return _dp_against_single(make, batches, val_batch, mesh)


def dp_deformation(models, device, mesh):
    """DP_STEPS compress-mode ``DeformationTrainer`` steps at B=32 scans x
    1000 points (``mode_train_steps``'s data) and a validation step at
    B=32, against one process; the noise comes from the trainer's
    generator, drawn for the whole batch on every rank."""
    import torch

    from nphm_tpu_torch.config import load_yaml
    from nphm_tpu_torch.data.synthetic import (
        SyntheticDeformationDataset,
        SyntheticIdentityDataset,
    )
    from nphm_tpu_torch.training.trainer_corresp import DeformationTrainer

    shape, params_shape, expr, params_expr, _gen = models
    sets = [SyntheticDeformationDataset(SyntheticIdentityDataset(n_subjects=32, seed=seed),
                                        n_expressions=1, n_points=1000, batch_size=32,
                                        warp_scale=0.08, seed=seed + 1)
            for seed in (SEED, SEED + 5)]
    batches = [next(iter(sets[0].batch_iter(seed=e))) for e in range(DP_STEPS)]
    val_batch = next(iter(sets[1].batch_iter(seed=0)))
    cfg = load_yaml(os.path.join(ROOT, "configs", "nphm_def.yaml"))
    gen = torch.Generator().manual_seed(SEED + 30)
    shape_state = {"params": params_shape,
                   "latents": torch.randn((32, shape.lat_dim), generator=gen) * 0.01,
                   "latents_val": torch.randn((32, shape.lat_dim), generator=gen) * 0.01}

    def make(m, tmp):
        return DeformationTrainer(expr, params_expr, shape, cfg, *sets, "dp_def", exp_dir=tmp,
                                  logger=_quiet_logger(), shape_state=shape_state, seed=SEED,
                                  device=device, mesh=m)

    return _dp_against_single(make, batches, val_batch, mesh)


def dp_fit(models, device, mesh):
    """``fit_joint_batch(mesh=)`` on BATCH_SUBJECTS subjects x 20 scans x
    2500 points for DP_FIT_STEPS steps, each rank's subjects through its
    own K2-K4 launches, beside the one-process batched fit, from zero
    (what users run) and from phase 7's seeded shape codes: their
    divergence is logged; DP_FIT_CHECK_STEPS steps from the seeded codes
    are held elementwise (TOL_FIT_*), as phase 7 holds the kernels
    against the plain path.  The shards' launches round in another order
    than one launch, and over tens of steps Adam grows that noise (from
    zero the fastest: the codes of each symmetric member pair coincide
    and symm_dist's gradient direction is set by rounding,
    ``check_batch_reference``)."""
    import numpy as np
    import torch

    from nphm_tpu_torch.fitting import FittingConfig, fit_joint_batch

    shape, params_shape, expr, params_expr, _gen = models
    subjects = batch_observations()
    rng = np.random.default_rng(SEED + 7)
    init = list((rng.normal(size=(len(subjects), shape.lat_dim)) * LAT_INIT_STD)
                .astype(np.float32))

    def fit(m, start=None, steps=DP_FIT_STEPS):
        cfg = FittingConfig(n_steps=steps, seed=SEED)
        return _timed(lambda: fit_joint_batch(shape, params_shape, expr, params_expr,
                                              subjects, cfg=cfg, device=device,
                                              verbose=False, mesh=m, lat_shape_init=start))

    reset_counters()
    dp, wall = fit(mesh)
    out = {"counts": read_counters(), "wall_s": wall,
           "steady_subject_steps_s": dp[3]["steady_subject_steps_s"]}
    seeded, _ = fit(mesh, init)
    short, _ = fit(mesh, init, DP_FIT_CHECK_STEPS)
    runs = (dp, seeded, short)
    flat = torch.as_tensor(_flat_leaves([r[:2] + (r[3]["loss"],) for r in runs]))
    out["replicas_equal"] = _replica_equal(flat, mesh)
    out["finite"] = bool(np.isfinite(flat.numpy()).all())
    if mesh.rank == 0:
        single, out["single_wall_s"] = fit(None)
        out["errs_zero"], _ = fit_diffs(dp, single)
        out["errs_seeded"], _ = fit_diffs(seeded, fit(None, init)[0])
        d = np.abs(dp[3]["loss"] - single[3]["loss"]).max(axis=1)
        out["loss_diff_by_step"] = {j: float(d[j]) for j in (0, 4, 9, 24, DP_FIT_STEPS - 1)
                                    if j < DP_FIT_STEPS}
        out["errs"], out["close"] = fit_diffs(short, fit(None, init, DP_FIT_CHECK_STEPS)[0])
        out["single_subject_steps_s"] = single[3]["steady_subject_steps_s"]
        out["loss"] = [float(dp[3]["loss"][0].mean()), float(dp[3]["loss"][-1].mean())]
    return out


def _same_mesh(a, vertices, faces) -> bool:
    import numpy as np

    return (a.vertices.shape == vertices.shape and a.faces.shape == faces.shape
            and bool(np.array_equal(a.vertices, vertices))
            and bool(np.array_equal(a.faces, faces)))


def dp_extract(models, device, mesh, refs):
    """Sharded dense ``extract_mesh``, ``extract_mesh_streamed`` (8 slabs,
    f32) and ``extract_mesh_sparse`` (lip 2.0, f16) at res 256 on phase 4's
    fitted code, each held array-equal (vertices and faces) to phase 8's
    one-process mesh at the same tile; rank 0 also times one-process dense
    extraction here."""
    import numpy as np

    from nphm_tpu_torch.reconstruction.extract import extract_mesh, extract_mesh_streamed
    from nphm_tpu_torch.reconstruction.sparse import extract_mesh_sparse

    shape, params_shape = models[0], models[1]
    lat = refs["lat_shape"]
    box = (GRID_MIN, GRID_MAX, EXTRACT_RES)
    calls = {
        "dense": lambda m: extract_mesh(shape, params_shape, lat, *box, device=device,
                                        device_mesh=m),
        "streamed": lambda m: extract_mesh_streamed(shape, params_shape, lat, *box,
                                                    device=device, device_mesh=m),
        "sparse_lip2": lambda m: extract_mesh_sparse(shape, params_shape, lat, *box, lip=2.0,
                                                     transfer_dtype=np.float16, device=device,
                                                     device_mesh=m),
    }
    out = {"counts": {}, "wall_s": {}, "equal": {}, "vertices": {}}
    for name, call in calls.items():
        reset_counters()
        got, out["wall_s"][name] = _timed(lambda: call(mesh))
        out["counts"][name] = read_counters()
        out["equal"][name] = _same_mesh(got, refs[f"{name}_v"], refs[f"{name}_f"])
        out["vertices"][name] = len(got.vertices)
    if mesh.rank == 0:
        _, out["single_dense_wall_s"] = _timed(lambda: calls["dense"](None))
    return out


def dp_pose(models, device, mesh, refs):
    """``deform_mesh_batch(device_mesh=)`` of phase 4's 20 expressions on the
    dense mesh (each rank's vertices through K7), against the one-process
    posing: max |offset difference| over the largest offset."""
    import numpy as np
    import torch

    from nphm_tpu_torch.reconstruction.extract import deform_mesh_batch
    from nphm_tpu_torch.utils.mesh_io import Mesh as TriMesh

    _shape, _ps, expr, params_expr, _gen = models
    base = TriMesh(refs["dense_v"], refs["dense_f"])

    def pose(m):
        return _timed(lambda: deform_mesh_batch(base, expr, params_expr, refs["lat_expr"],
                                                anchors=refs["anchors"],
                                                lat_shape=refs["lat_shape"], device=device,
                                                device_mesh=m))

    reset_counters()
    posed, wall = pose(mesh)
    out = {"counts": read_counters(), "wall_s": wall, "expressions": len(posed)}
    flat = torch.as_tensor(np.stack([p.vertices for p in posed]))
    out["replicas_equal"] = _replica_equal(flat, mesh)
    if mesh.rank == 0:
        single, out["single_wall_s"] = pose(None)
        offsets = np.stack([p.vertices for p in single]) - base.vertices[None]
        diff = np.abs(flat.numpy() - np.stack([p.vertices for p in single])).max()
        out["err"] = float(diff / max(float(np.abs(offsets).max()), 1e-30))
    return out


def dp_rank(rank, world, backend, run_dir):
    """One rank of phase 13 (a ``torch.multiprocessing.spawn`` target): joins
    the group through a file store in ``run_dir``, runs every DP path and
    writes its results to ``run_dir/rank{rank}.json``.  Nothing is caught:
    a failure ends the rank, and the spawn raises it in the parent."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from nphm_tpu_torch.parallel import get_device_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(DP_DEVICE, rank if backend == "nccl" else 0)
    mesh = get_device_mesh(rank=rank, world_size=world, backend=backend, device=device,
                           init_method="file://" + os.path.join(run_dir, "store"))
    try:
        refs = dict(np.load(os.path.join(run_dir, "refs.npz")))
        models = build_models(device)
        torch.cuda.reset_peak_memory_stats(device)
        out = {"rank": rank, "device": str(device)}
        for name, fn in (("identity", dp_identity), ("deformation", dp_deformation),
                         ("fit", dp_fit)):
            t0 = time.perf_counter()
            out[name] = fn(models, device, mesh)
            out[name]["phase_s"] = time.perf_counter() - t0
        for name, fn in (("extract", dp_extract), ("pose", dp_pose)):
            t0 = time.perf_counter()
            out[name] = fn(models, device, mesh, refs)
            out[name]["phase_s"] = time.perf_counter() - t0
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    finally:
        dist.destroy_process_group()
    with open(os.path.join(run_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def dp_run(world, backend, refs):
    """Spawn ``world`` ranks of ``dp_rank``, check what they report; returns
    the launch counts of their DP paths summed over the ranks."""
    import numpy as np
    import torch

    with tempfile.TemporaryDirectory() as run_dir:
        np.savez(os.path.join(run_dir, "refs.npz"), **refs)
        t0 = time.perf_counter()
        torch.multiprocessing.spawn(dp_rank, args=(world, backend, run_dir), nprocs=world,
                                    join=True)
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(world):
            with open(os.path.join(run_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    tag = f"[dp {backend} W={world}]"
    log(f"{tag} {world} ranks on {[r['device'] for r in ranks]} in {wall:.2f} s (spawn, "
        f"imports and model builds included); peak device memory per rank (GiB) "
        f"{[round(r['peak_gib'], 3) for r in ranks]}; seconds per part on rank 0 "
        f"{json.dumps({k: round(v['phase_s'], 2) for k, v in ranks[0].items() if isinstance(v, dict)})}")
    r0 = ranks[0]
    for name in ("identity", "deformation"):
        got = r0[name]
        log(f"{tag} {name}: {DP_STEPS} steps + 1 validation step at B=32, DP step ms per "
            f"rank {[[round(t, 3) for t in r[name]['step_ms']] for r in ranks]} against one "
            f"process {[round(t, 3) for t in got['single_step_ms']]}; |d_dp - d_1| / |d_1| "
            + ", ".join(f"{k} {got['rel_update'][k]:.3e} (tol {TOL_TRAIN_UPDATE[k]:g})"
                        for k in DP_TRAIN_KEYS)
            + f"; loss terms max relative {got['rel_terms']:.3e} (tol {TOL_TRAIN_TERMS:g}); "
            f"replicas bit-equal {[r[name]['replicas_equal'] for r in ranks]}; counters per "
            f"rank {[r[name]['counts'] for r in ranks]}")
        expect(got["same_start"], f"{tag} {name}: DP and one process start apart")
        expect(all(r[name]["replicas_equal"] for r in ranks),
               f"{tag} {name}: the replicas differ across ranks")
        expect(all(got["rel_update"][k] <= TOL_TRAIN_UPDATE[k] for k in DP_TRAIN_KEYS),
               f"{tag} {name}: the DP steps disagree with the one-process steps")
        expect(got["rel_terms"] <= TOL_TRAIN_TERMS, f"{tag} {name}: the DP loss terms differ")
    for r in ranks:
        for k in ("train_fwd", "train_bwd"):
            expect(r["identity"]["counts"][k] > 0, f"{tag} rank {r['rank']}: {k} not launched")
    fit = r0["fit"]
    log(f"{tag} fit: {BATCH_SUBJECTS} subjects x {DP_FIT_STEPS} steps, wall per rank "
        f"{[round(r['fit']['wall_s'], 3) for r in ranks]} s against one process "
        f"{fit['single_wall_s']:.3f} s; steady subject-steps/s per rank "
        f"{[round(r['fit']['steady_subject_steps_s'], 2) for r in ranks]} against "
        f"{fit['single_subject_steps_s']:.2f}; loss mean {fit['loss'][0]:.5f} -> "
        f"{fit['loss'][1]:.5f}; max|DP - one process| after {DP_FIT_STEPS} steps from zero "
        f"{json.dumps(fit['errs_zero'])} (of the loss by step "
        f"{json.dumps(fit['loss_diff_by_step'])}), from the seeded codes "
        f"{json.dumps(fit['errs_seeded'])}; after {DP_FIT_CHECK_STEPS} steps from the "
        f"seeded codes {json.dumps(fit['errs'])} (rtol {TOL_FIT_RTOL:g}, atol "
        f"{TOL_FIT_ATOL:g}); "
        f"replicas bit-equal {[r['fit']['replicas_equal'] for r in ranks]}; counters per "
        f"rank {[r['fit']['counts'] for r in ranks]}")
    expect(fit["close"], f"{tag} the sharded fit disagrees with the one-process fit")
    expect(all(r["fit"]["replicas_equal"] and r["fit"]["finite"] for r in ranks),
           f"{tag} fit results differ by rank or are not finite")
    for r in ranks:
        for k in ("broyden_search", "fit_fwd", "fit_bwd"):
            expect(r["fit"]["counts"][k] > 0, f"{tag} rank {r['rank']}: {k} not launched")
    ext = r0["extract"]
    log(f"{tag} extraction at res {EXTRACT_RES}: wall s per rank "
        f"{[r['extract']['wall_s'] for r in ranks]}, one-process dense "
        f"{ext['single_dense_wall_s']:.3f} s; vertices {ext['vertices']}; array-equal to "
        f"phase 8's one-process meshes per rank {[r['extract']['equal'] for r in ranks]}; K1 "
        f"launches per rank {[{k: c['ensemble_sdf'] for k, c in r['extract']['counts'].items()} for r in ranks]}")
    for r in ranks:
        for name, same in r["extract"]["equal"].items():
            expect(same, f"{tag} rank {r['rank']}: sharded {name} mesh differs from phase 8's")
            expect(r["extract"]["counts"][name]["ensemble_sdf"] > 0,
                   f"{tag} rank {r['rank']}: {name} launched no K1")
    pose = r0["pose"]
    log(f"{tag} posing: {pose['expressions']} expressions of {len(refs['dense_v'])} vertices, "
        f"wall per rank {[round(r['pose']['wall_s'], 3) for r in ranks]} s against one process "
        f"{pose['single_wall_s']:.3f} s; max|DP - one process| / max|offset| "
        f"{pose['err']:.3e} (tol {TOL_K7:g}); replicas bit-equal "
        f"{[r['pose']['replicas_equal'] for r in ranks]}; K7 launches per rank "
        f"{[r['pose']['counts']['deepsdf_trunk'] for r in ranks]}")
    expect(pose["err"] <= TOL_K7, f"{tag} sharded posing disagrees with one process")
    for r in ranks:
        expect(r["pose"]["replicas_equal"], f"{tag} posing differs on rank {r['rank']}")
        expect(r["pose"]["counts"]["deepsdf_trunk"] > 0,
               f"{tag} rank {r['rank']}: posing launched no K7")
    total = {}
    for r in ranks:
        for part in ("identity", "deformation", "fit", "pose"):
            _add(total, r[part]["counts"])
        for counts in r["extract"]["counts"].values():
            _add(total, counts)
    return total


def dp_path(fitted, meshes):
    """Phase 13: two ranks on card 0 over gloo, then, with two cards or more,
    one rank a card over NCCL (up to 4).  ``fitted``: phase 4's codes;
    ``meshes``: phase 8's one-process dense, streamed and lip-2.0 sparse
    meshes at res 256."""
    import torch

    lat_expr, lat_shape, anchors = fitted
    refs = {"lat_expr": lat_expr, "lat_shape": lat_shape, "anchors": anchors}
    for name, m in meshes.items():
        refs[f"{name}_v"], refs[f"{name}_f"] = m.vertices, m.faces
    torch.cuda.empty_cache()
    total = dp_run(2, "gloo", refs)
    n = torch.cuda.device_count()
    if n >= 2:
        _add(total, dp_run(min(n, 4), "nccl", refs))
    else:
        log(f"[dp] NCCL not run: {n} card (NCCL refuses two ranks on one device; the gloo "
            f"ranks above shared card 0)")
    log(f"[counters] phase 13: {json.dumps(total)}")
    return total


# ---------------------------------------------------------------------------
# Phase 14: matmul precision and remat
# ---------------------------------------------------------------------------

# The lower precisions by their JAX names: TF32 and BF16 (ops/precision.py).
LOW_PRECISIONS = ("high", "bfloat16")
# K3-K6 at a lower precision against their plain versions at the same
# precision, relative to the plain output's magnitude.  Both round the same
# operands, but they sum in other orders, so an operand computed an ulp
# apart may round to the neighbouring TF32 or bf16 value (2^-10 or 2^-7
# of it) and carry that through the layers.
# Each is about 4x the largest error measured on an H100.  The F32 output
# lies further off (about 1.5e-3 at TF32, 8e-3 at BF16, on the plain
# versions), so each kernel is also held nearer to its plain version than to
# the F32 kernel's output: a lower-precision call that ran 3xTF32 fails.
TOL_LOW = {"high": 1e-3, "bfloat16": 1e-2}
# The tensor cores' peak for each lower precision's operands (bound).
PEAK_LOW = {"high": PEAK_TF32_FLOPS, "bfloat16": PEAK_BF16_FLOPS}
PRECISION_FIT_STEPS = 20
TOL_LOW_LOSS = 0.05  # a lower precision's loss against F32's, relative
# K5/K6's plain versions at a lower precision run in member chunks: their
# rounded operands would add to the plain double backward's ~50 GiB at B=32
PLAIN_MEMBER_CHUNK = 10


def rel_err(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def bit_identical(xs, ys) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(xs, ys))


def low_library_ms(cfg, n_members: int, M: int, passes: str, device, reps: int,
                   name: str) -> float:
    """``baddbmm_chain_ms`` at a lower precision: with TF32 on for "high"
    (the flag restored after), on bf16 operands for "bfloat16"."""
    import torch

    if name == "bfloat16":
        return baddbmm_chain_ms(cfg, n_members, M, passes, device, reps, dtype=torch.bfloat16)
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return baddbmm_chain_ms(cfg, n_members, M, passes, device, reps)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def check_k3_k4_low(shape, params, gen, device, rows, name: str):
    """K3 and K4 at precision ``name`` at the batched fit's launch shape (8
    subjects x 5 scans = 40 rows of 1000 points, Morton-sorted, culled at
    1e-10) against their plain versions at the same precision, each run
    twice (bit-identical); rows ``fit_fwd@S8_{name}``, ``fit_bwd@S8_{name}``
    with bounds at one tensor-core pass."""
    import numpy as np
    import torch

    from nphm_tpu_torch.models.ensemble import mirror_scale, predict_anchors
    from nphm_tpu_torch.ops import precision
    from nphm_tpu_torch.ops.fit_fields import (
        active_mask,
        member_f,
        member_f_plain,
        morton_codes,
        prepare_train_operands,
    )

    cfg = shape.cfg
    B, subjects, N, tile = 5 * BATCH_SUBJECTS, BATCH_SUBJECTS, 1000, 512
    xyz = torch.tensor(np.stack(observations(B, N, SEED + 2)), device=device)
    lat = (torch.randn((subjects, cfg.lat_dim), generator=gen) * 0.01).to(device)
    lat = lat.repeat_interleave(B // subjects, dim=0).contiguous()
    perm = torch.argsort(morton_codes(xyz), dim=1, stable=True)
    xyz = torch.gather(xyz, 1, perm[..., None].expand(B, N, 3))
    Np = -(-N // tile) * tile
    xyz = torch.cat([xyz, xyz[:, -1:].expand(B, Np - N, 3)], dim=1)
    A, M = cfg.n_members, B * Np
    _, skip = cfg.layer_shapes
    dF = torch.randn((A, M), generator=gen).to(device)
    with precision.matmul_precision(name):
        lat.requires_grad_(True)
        anchors = predict_anchors(params, cfg, lat)
        centers = torch.cat([anchors, torch.zeros_like(anchors[:, :1])], dim=1)
        coords = (xyz[:, :, None] - centers[:, None]) * mirror_scale(cfg, device)
        coords = coords.permute(2, 3, 0, 1).reshape(A, 3, M).detach().requires_grad_(True)
        layers, _ = prepare_train_operands(params, cfg, lat)
        active = active_mask(cfg, coords, tile, 1e-10)
        ins = (layers[0]["b"], layers[skip]["b"], coords)
        runs = []
        for _ in range(2):
            Fk = member_f(cfg, layers, coords, active, tile, B)
            runs.append((Fk, *torch.autograd.grad(Fk, ins, dF, retain_graph=True)))
        Fp = member_f_plain(cfg, layers, coords, active, tile, B)
        plain = (Fp, *torch.autograd.grad(Fp, ins, dF, retain_graph=True))
        e3 = rel_err(runs[0][0], Fp)
        e4 = max(rel_err(a, b) for a, b in zip(runs[0][1:], plain[1:]))
        with precision.matmul_precision("default"):
            F32 = member_f(cfg, layers, coords, active, tile, B)
            f32 = (F32, *torch.autograd.grad(F32, ins, dF))
        # the F32 kernel's distance, on the plain version's scale
        g3 = float((runs[0][0] - F32).detach().abs().max()) / float(Fp.detach().abs().max())
        g4 = max(float((a - c).abs().max()) / float(b.abs().max())
                 for a, b, c in zip(runs[0][1:], plain[1:], f32[1:]))
        del F32, f32
        abs3 = float((runs[0][0] - Fp).detach().abs().max())
        abs4 = max(float((a - b).abs().max()) for a, b in zip(runs[0][1:], plain[1:]))
        with torch.no_grad():
            ms3 = cuda_ms(lambda: member_f(cfg, layers, coords, active, tile, B), 10)
            plain3 = cuda_ms(lambda: member_f_plain(cfg, layers, coords, active, tile, B), 5)
        ms4 = cuda_ms(lambda: torch.autograd.grad(Fk, ins, dF, retain_graph=True), 10)
        plain4 = cuda_ms(lambda: torch.autograd.grad(Fp, ins, dF, retain_graph=True), 5)
        # the F32 instantiations on the same inputs, timed beside them
        with precision.matmul_precision("default"):
            with torch.no_grad():
                f32_3 = cuda_ms(lambda: member_f(cfg, layers, coords, active, tile, B), 10)
            F32 = member_f(cfg, layers, coords, active, tile, B)
            f32_4 = cuda_ms(lambda: torch.autograd.grad(F32, ins, dF, retain_graph=True), 10)
            del F32
    tol = TOL_LOW[name]
    same = bit_identical(runs[0], runs[1])
    pairs = live_lanes(active, tile, B, N)
    wb = weight_bytes(params["ensemble"], cfg)
    flops3, flops4 = 2.0 * nphm_fmas(cfg) * pairs, 4.0 * nphm_fmas(cfg) * pairs
    b3 = bound(flops3, pairs * 16 + wb, 1, PEAK_LOW[name])
    b4 = bound(flops4, pairs * 28 + wb, 1, PEAK_LOW[name])
    lib3 = low_library_ms(cfg, A, M, "f", device, 10, name)
    lib4 = low_library_ms(cfg, A, M, "fr", device, 10, name)
    log(f"[K3/K4 {name}] M={B}x{Np}: relative error K3 {e3:.3e}, K4 {e4:.3e} (tol {tol:g}; "
        f"from the F32 kernel K3 {g3:.3e}, K4 {g4:.3e}); two calls bit-identical {same}; "
        f"K3 {ms3:.3f} ms (F32 {f32_3:.3f}, ratio {ms3 / f32_3:.3f}), plain {plain3:.3f}, "
        f"library {lib3:.3f} (ratio {ms3 / lib3:.3f}), bound {b3['bound_ms']:.3f} "
        f"({b3['bound_by']}); K4 {ms4:.3f} ms (F32 {f32_4:.3f}, ratio {ms4 / f32_4:.3f}), "
        f"plain {plain4:.3f}, library {lib4:.3f} (ratio {ms4 / lib4:.3f}), bound "
        f"{b4['bound_ms']:.3f} ({b4['bound_by']})")
    expect(bool(all(torch.isfinite(t).all() for t in runs[0])), f"K3/K4 at {name} non-finite")
    expect(e3 <= tol and e4 <= tol, f"K3/K4 at {name} disagree with their plain versions")
    expect(e3 < g3 and e4 < g4, f"K3/K4 at {name} lie nearer the F32 kernel than their "
                                f"plain versions at {name}")
    expect(same, f"two K3/K4 calls at {name} differ")
    rows[f"fit_fwd@S8_{name}"] = dict(max_abs_err=abs3, rel_err=e3, ms=ms3, plain_ms=plain3,
                                      library_ms=lib3, f32_ms=f32_3, vs_f32=ms3 / f32_3, **b3)
    rows[f"fit_bwd@S8_{name}"] = dict(max_abs_err=abs4, rel_err=e4, ms=ms4, plain_ms=plain4,
                                      library_ms=lib4, f32_ms=f32_4, vs_f32=ms4 / f32_4, **b4)
    del runs, plain, Fk, Fp
    torch.cuda.empty_cache()


def check_k5_k6_low(shape, params, gen, device, rows, name: str):
    """K5/K6 at precision ``name`` at the training path's shapes (B=32 rows x
    1693 points padded to 2048, no culling) against their plain versions at
    the same precision, which run in member chunks of PLAIN_MEMBER_CHUNK
    (their times summed over the chunks); K5 and K6 each run twice
    (bit-identical); rows ``train_fwd@{name}``, ``train_bwd@{name}`` with
    bounds at one tensor-core pass."""
    import torch

    from nphm_tpu_torch.models.ensemble import mirror_scale, predict_anchors
    from nphm_tpu_torch.ops import precision
    from nphm_tpu_torch.ops.fit_fields import active_mask, prepare_train_operands
    from nphm_tpu_torch.ops.train_fields import (
        _flat,
        _unflat,
        member_fields,
        member_fields_plain,
    )

    cfg = shape.cfg
    B, tile, A = 32, 512, cfg.n_members
    xyz = torch.tensor(train_batch(B, SEED + 4), device=device)
    N = xyz.shape[1]
    Np = -(-N // tile) * tile
    xyz = torch.cat([xyz, xyz[:, -1:].expand(B, Np - N, 3)], dim=1)
    lat = (torch.randn((B, cfg.lat_dim), generator=gen) * 0.1).to(device)
    M = B * Np
    dF = torch.randn((A, M), generator=gen).to(device)
    dG = torch.randn((A, 3, M), generator=gen).to(device)
    with precision.matmul_precision(name):
        with torch.no_grad():
            anchors = predict_anchors(params, cfg, lat)
            centers = torch.cat([anchors, torch.zeros_like(anchors[:, :1])], dim=1)
            coords = (xyz[:, :, None] - centers[:, None]) * mirror_scale(cfg, device)
            coords = coords.permute(2, 3, 0, 1).reshape(A, 3, M).contiguous()
            layers, _ = prepare_train_operands(params, cfg, lat)
        flat = [t.detach().clone().requires_grad_(True) for t in _flat(cfg, layers)]
        layers = _unflat(cfg, flat)
        coords.requires_grad_(True)
        active = active_mask(cfg, coords, tile, 0.0)
        ins = flat + [coords]
        runs = []
        for _ in range(2):
            Fk, Gk = member_fields(cfg, layers, coords, active, tile, B)
            phi_k = (Fk * dF).sum() + (Gk * dG).sum()
            runs.append((Fk, Gk, *torch.autograd.grad(phi_k, ins, retain_graph=True)))
        same = bit_identical(runs[0], runs[1])
        kernel = runs[0]
        del runs
        with precision.matmul_precision("default"):
            F32, G32 = member_fields(cfg, layers, coords, active, tile, B)
            phi32 = (F32 * dF).sum() + (G32 * dG).sum()
            f32 = (F32, G32, *torch.autograd.grad(phi32, ins, retain_graph=True))
            gap = [float((k - c).detach().abs().max()) for k, c in zip(kernel, f32)]
            # the F32 instantiations on the same inputs, timed beside them
            with torch.no_grad():
                f32_5 = cuda_ms(lambda: member_fields(cfg, layers, coords, active, tile, B), 5)
            f32_6 = cuda_ms(lambda: torch.autograd.grad(phi32, ins, retain_graph=True), 3)
        del F32, G32, phi32, f32
        with torch.no_grad():
            ms5 = cuda_ms(lambda: member_fields(cfg, layers, coords, active, tile, B), 5)
        ms6 = cuda_ms(lambda: torch.autograd.grad(phi_k, ins, retain_graph=True), 3)
        # the plain versions member chunk by member chunk: every operand leads
        # with the member axis
        n_out = len(kernel)
        diff, mag = [0.0] * n_out, [0.0] * n_out
        plain5 = plain6 = 0.0
        for m0 in range(0, A, PLAIN_MEMBER_CHUNK):
            sl = slice(m0, m0 + PLAIN_MEMBER_CHUNK)
            c_flat = [t.detach()[sl].clone().requires_grad_(True) for t in flat]
            c_coords = coords.detach()[sl].clone().requires_grad_(True)
            c_layers, c_active = _unflat(cfg, c_flat), active[:, sl].contiguous()
            Fp, Gp = member_fields_plain(cfg, c_layers, c_coords, c_active, tile, B)
            phi_p = (Fp * dF[sl]).sum() + (Gp * dG[sl]).sum()
            plain = (Fp, Gp, *torch.autograd.grad(phi_p, c_flat + [c_coords],
                                                  retain_graph=True))
            for i, (k, p) in enumerate(zip(kernel, plain)):
                diff[i] = max(diff[i], float((k[sl] - p).abs().max()))
                mag[i] = max(mag[i], float(p.abs().max()))
            plain5 += cuda_ms(lambda: member_fields_plain(cfg, c_layers, c_coords, c_active,
                                                          tile, B), 2)
            plain6 += cuda_ms(lambda: torch.autograd.grad(phi_p, c_flat + [c_coords],
                                                          retain_graph=True), 2)
            del Fp, Gp, phi_p, plain
    rels = [d / max(m, 1e-30) for d, m in zip(diff, mag)]
    e5, e6 = max(rels[:2]), max(rels[2:])
    # the F32 kernel's distance, on the plain versions' scale
    gaps = [d / max(m, 1e-30) for d, m in zip(gap, mag)]
    g5, g6 = max(gaps[:2]), max(gaps[2:])
    tol = TOL_LOW[name]
    pairs = live_lanes(active, tile, B, N)
    wb = weight_bytes(params["ensemble"], cfg)
    flops5, flops6 = 2.0 * 2 * nphm_fmas(cfg) * pairs, 2.0 * 6 * nphm_fmas(cfg) * pairs
    b5 = bound(flops5, pairs * 28 + wb, 1, PEAK_LOW[name])
    b6 = bound(flops6, pairs * 40 + 2 * wb, 1, PEAK_LOW[name])
    del kernel, phi_k, flat, layers, coords, ins
    torch.cuda.empty_cache()
    lib5 = low_library_ms(cfg, A, M, "fr", device, 3, name)
    lib6 = low_library_ms(cfg, A, M, "frfwrw", device, 3, name)
    scr = A * k6_scratch_bytes(cfg, M, name)
    log(f"[K5/K6 {name}] M={B}x{Np}: relative error K5 {e5:.3e}, K6 {e6:.3e} (worst of "
        f"{n_out - 2} gradients; tol {tol:g}; from the F32 kernel K5 {g5:.3e}, K6 {g6:.3e}); "
        f"two calls bit-identical {same}; K5 {ms5:.3f} ms (F32 {f32_5:.3f}, ratio "
        f"{ms5 / f32_5:.3f}), plain {plain5:.3f} (in member chunks of {PLAIN_MEMBER_CHUNK}), "
        f"library {lib5:.3f} (ratio {ms5 / lib5:.3f}), bound {b5['bound_ms']:.3f} "
        f"({b5['bound_by']}); K6 {ms6:.3f} ms (F32 {f32_6:.3f}, ratio {ms6 / f32_6:.3f}), "
        f"plain {plain6:.3f}, library {lib6:.3f} (ratio {ms6 / lib6:.3f}), bound "
        f"{b6['bound_ms']:.3f} ({b6['bound_by']}); K6's scratch moves {scr / 1e9:.2f} GB "
        f"({scr / PEAK_HBM_BYTES_S * 1e3:.3f} ms at {PEAK_HBM_BYTES_S / 1e12:g} TB/s)")
    expect(all(d == d for d in diff), f"K5/K6 at {name} non-finite")
    expect(e5 <= tol and e6 <= tol, f"K5/K6 at {name} disagree with their plain versions")
    expect(e5 < g5 and e6 < g6, f"K5/K6 at {name} lie nearer the F32 kernel than their "
                                f"plain versions at {name}")
    expect(same, f"two K5/K6 calls at {name} differ")
    rows[f"train_fwd@{name}"] = dict(max_abs_err=max(diff[:2]), rel_err=e5, ms=ms5,
                                     plain_ms=plain5, library_ms=lib5, f32_ms=f32_5,
                                     vs_f32=ms5 / f32_5, **b5)
    rows[f"train_bwd@{name}"] = dict(max_abs_err=max(diff[2:]), rel_err=e6, ms=ms6,
                                     plain_ms=plain6, library_ms=lib6, f32_ms=f32_6,
                                     vs_f32=ms6 / f32_6, **b6)


def precision_counters():
    """Each of K3-K6's launches by precision (the wrappers' dicts)."""
    from nphm_tpu_torch.ops.fit_fields import member_f
    from nphm_tpu_torch.ops.train_fields import member_fields

    return {"fit_fwd": member_f.launches_at, "fit_bwd": member_f.bwd_launches_at,
            "train_fwd": member_fields.launches_at,
            "train_bwd": member_fields.bwd_launches_at}


def precision_main_path(models, device):
    """Two ``IdentityTrainer`` steps (B=32, K5/K6; the second one timed) and
    a PRECISION_FIT_STEPS-step ``fit_joint_batch`` (phase 7's 8 subjects,
    K2-K4) at "default" and each lower precision, from the same start and
    draws: finite, and the lower precisions' first-step and final fit
    losses within TOL_LOW_LOSS of F32's.  Returns the kernel counters of
    these runs and each of K3-K6's launches by precision."""
    import numpy as np
    import torch

    from nphm_tpu_torch.fitting import FittingConfig, fit_joint_batch
    from nphm_tpu_torch.training.trainer import IdentityTrainer

    shape, params_shape, expr, params_expr, _gen = models
    train_ds, val_ds = identity_sets(32, 2, 32)
    batch = next(iter(train_ds.batch_iter(seed=0)))
    subjects = batch_observations()
    reset_counters()
    for per in precision_counters().values():
        per.update({p: 0 for p in per})
    out = {}
    for name in ("default",) + LOW_PRECISIONS:
        with tempfile.TemporaryDirectory() as tmp:
            tr = IdentityTrainer(shape, params_shape, train_config(matmul_precision=name),
                                 train_ds, val_ds, "precision", exp_dir=tmp,
                                 logger=_History(), seed=SEED, device=device)
            terms = tr._train_step(tr._batch(batch), tr.lr_at(0), tr.lr_lat_at(0))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = tr._train_step(tr._batch(batch), tr.lr_at(0), tr.lr_lat_at(0))
            torch.cuda.synchronize()
            step_ms = 1e3 * (time.perf_counter() - t0)
        cfg = FittingConfig(n_steps=PRECISION_FIT_STEPS, seed=SEED, matmul_precision=name)
        le, ls, _, hist = fit_joint_batch(shape, params_shape, expr, params_expr, subjects,
                                          cfg=cfg, device=device, verbose=False)
        out[name] = dict(train_loss=float(terms["loss"]),
                         fit_loss=float(hist["loss"][-1].mean()),
                         finite=bool(np.isfinite(hist["loss"]).all()
                                     and all(np.isfinite(x).all() for x in le + ls)
                                     and all(torch.isfinite(v).all() for t in (terms, again)
                                             for v in t.values())),
                         step_ms=step_ms, subject_steps_s=hist["steady_subject_steps_s"])
        log(f"[precision {name}] identity step (B=32) loss {out[name]['train_loss']:.6f}, "
            f"second step {step_ms:.2f} ms; {PRECISION_FIT_STEPS}-step "
            f"batched fit: final mean loss {out[name]['fit_loss']:.6f}, steady "
            f"{out[name]['subject_steps_s']:.2f} subject-steps/s")
    counts = read_counters()
    by_prec = {k: {p.name: n for p, n in per.items()} for k, per in precision_counters().items()}
    log(f"[counters] phase 14 main path: {json.dumps(counts)}; by precision "
        f"{json.dumps(by_prec)}")
    for name in LOW_PRECISIONS:
        expect(out[name]["finite"], f"the {name} trainer step or fit is not finite")
        for key in ("train_loss", "fit_loss"):
            ref = out["default"][key]
            expect(abs(out[name][key] - ref) <= TOL_LOW_LOSS * abs(ref),
                   f"the {name} {key} is not within {TOL_LOW_LOSS:g} of F32's")
    for kernel, per in by_prec.items():
        for p, n in per.items():
            expect(n > 0, f"{kernel}'s {p} instantiation was not launched on the main path")
    return counts, by_prec


def npm_remat_path(npm, device):
    """NPM stage 1 at configs/npm.yaml's widths (8x1024 trunk, B=32 rows x
    1693 points, plain fields path): 3 ``IdentityTrainer`` steps from the
    same start with ``remat`` on and off.  The states after them are
    bit-equal; each run's peak device memory and step times are logged."""
    import numpy as np
    import torch

    from nphm_tpu_torch.config import load_yaml
    from nphm_tpu_torch.training.trainer import IdentityTrainer

    shape, params_shape = npm[0], npm[1]
    train_ds, val_ds = identity_sets(32, 2, 32)
    batches = [next(iter(train_ds.batch_iter(seed=e))) for e in range(3)]
    states = {}
    for remat in (True, False):
        cfg = load_yaml(os.path.join(ROOT, "configs", "npm.yaml"))
        cfg["training"]["remat"] = remat
        with tempfile.TemporaryDirectory() as tmp:
            tr = IdentityTrainer(shape, params_shape, cfg, train_ds, val_ds, "npm",
                                 exp_dir=tmp, logger=_History(), seed=SEED, device=device)
            expect(tr._fields_fn is None, "the NPM trainer did not take the plain path")
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
            times = []
            for b in batches:
                b = tr._batch(b)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr._train_step(b, tr.lr_at(0), tr.lr_lat_at(0))
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
            peak = torch.cuda.max_memory_allocated(device)
            states[remat] = _leaves(tr.state_dict())
            del tr
        log(f"[remat] NPM stage 1 remat={remat}: peak device memory {peak / 2**30:.3f} GiB "
            f"({(peak - base) / 2**30:.3f} GiB above the trainer's state)")
        log(f"[remat] NPM stage 1 remat={remat}: step ms {[round(t, 3) for t in times]} "
            f"(steady mean {float(np.mean(times[1:])):.3f} ms, first step excluded)")
    same = all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(states[True], states[False]))
    log(f"[remat] NPM updates with remat on and off bit-equal: {same}")
    expect(same, "remat changed the NPM stage-1 updates")


def occupancy_report(shape, params, device):
    """Registers and local (stack) bytes a thread, shared memory and blocks
    per SM of K3-K6's instantiations at each precision, as the built library
    reports them for the NPHM widths; each launch's shared memory must equal
    the host's mirror (``fit_fields.smem_bytes``) and leave a block
    resident."""
    import torch

    from nphm_tpu_torch.ops import fit_fields as ff
    from nphm_tpu_torch.ops import precision
    from nphm_tpu_torch.ops.train_fields import occupancy

    cfg = shape.cfg
    layers, _ = ff.prepare_train_operands(params, cfg, torch.zeros((2, cfg.lat_dim),
                                                                   device=device))
    for kernel, key, sized in (("fit_fwd", "fit_fwd", "fit_fwd"),
                               ("fit_bwd", "fit_bwd", "fit_bwd"),
                               ("train_fwd", "train_fwd", "train_fwd"),
                               ("train_bwd_fwd", "train_bwd", "train_bwd"),
                               ("train_bwd_rev", "train_bwd", "train_bwd"),
                               ("lane_contract", "train_bwd", "lane_contract")):
        for p in precision.Precision:
            occ = occupancy(kernel, cfg, layers, 2, 64, p)
            mirror = ff.smem_bytes(sized, cfg, ff.ROUTES[key][p])
            log(f"[occupancy] {kernel} at {p.name} (route {occ['route']}): "
                f"{occ['registers']} registers, {occ['local_bytes']} local (stack) bytes a "
                f"thread, {occ['smem_bytes']} B shared memory (host mirror {mirror}), "
                f"{occ['blocks_per_sm']} block(s) per SM")
            expect(occ["smem_bytes"] == mirror,
                   f"{kernel} at {p.name}: the host's shared-memory mirror disagrees")
            expect(occ["blocks_per_sm"] >= 1, f"{kernel} at {p.name}: no block fits an SM")


def precision_path(models, npm, device, rows):
    """Phase 14: K3-K6's instantiations' occupancy, K3-K6 at TF32 and BF16
    against their plain versions, the identity step and the batched fit at
    each precision, and remat on the NPM stage 1.  Returns the main path's
    counters."""
    shape, params_shape, gen = models[0], models[1], models[4]
    occupancy_report(shape, params_shape, device)
    for name in LOW_PRECISIONS:
        check_k3_k4_low(shape, params_shape, gen, device, rows, name)
        check_k5_k6_low(shape, params_shape, gen, device, rows, name)
    counts, by_prec = precision_main_path(models, device)
    for name in LOW_PRECISIONS:
        p = {"high": "TF32", "bfloat16": "BF16"}[name]
        for kernel in ("fit_fwd", "fit_bwd"):
            rows[f"{kernel}@S8_{name}"]["launches"] = by_prec[kernel][p]
        for kernel in ("train_fwd", "train_bwd"):
            rows[f"{kernel}@{name}"]["launches"] = by_prec[kernel][p]
    # each BF16 row beside the TF32 row of the same kernel, timed in this run
    for key in ("fit_fwd@S8_", "fit_bwd@S8_", "train_fwd@", "train_bwd@"):
        low, tf32 = rows[key + "bfloat16"], rows[key + "high"]
        low["tf32_ms"], low["vs_tf32"] = tf32["ms"], low["ms"] / tf32["ms"]
        log(f"[precision] {key}bfloat16 {low['ms']:.3f} ms: {low['vs_f32']:.3f}x F32, "
            f"{low['vs_tf32']:.3f}x TF32 ({tf32['ms']:.3f} ms), "
            f"{low['ms'] / low['library_ms']:.3f}x the bf16 library call")
    npm_remat_path(npm, device)
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
    fit_counts, serial_it_s, fitted = main_path(models, device)
    train_counts = train_path(models, device)
    npm_counts, npm_lat = npm_path(npm, device)
    check_batched_kernels(models, device, rows)
    batch_counts = batch_path(models, device, serial_it_s)
    cli_counts = cli_path(models)
    extract_counts, dp_meshes = extraction_path(models, npm, fitted, npm_lat, device, rows)
    with tempfile.TemporaryDirectory() as tree_dir:
        train_cli_counts, tree = training_cli_path(tree_dir)
        t0 = time.perf_counter()
        protocol_counts, _ = evaluation_path()
        log(f"[phase 10] {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        synthetic_counts = synthetic_path()
        log(f"[phase 11] {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        mode_counts = modes_path(models, device, rows, tree_dir, tree)
        log(f"[phase 12] {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    dp_counts = dp_path(fitted, dp_meshes)
    log(f"[phase 13] {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    precision_counts = precision_path(models, npm, device, rows)
    log(f"[phase 14] {time.perf_counter() - t0:.2f} s")
    paths = (fit_counts, train_counts, npm_counts, batch_counts, cli_counts, extract_counts,
             train_cli_counts, protocol_counts, synthetic_counts, mode_counts, dp_counts,
             precision_counts)
    table = []
    for name, (source, replaces) in KERNELS.items():
        # rows of the same kernel at other shapes: "ensemble_sdf@res256", ...
        also = {k.split("@", 1)[1]: v for k, v in rows.items() if k.startswith(name + "@")}
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces,
                      "launches": sum(c[name] for c in paths),
                      "library_ms": None, **rows[name], **({"at": also} if also else {})})
    log(smi)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


def dp_only():
    """``python3 chip_smoke.py --dp``: phase 13 alone, on every card of the
    host up to 4 (NCCL) after the two gloo ranks on card 0.  Its inputs
    come first: phases 1 and 2, phase 4's fit for the codes, and the
    one-process dense, streamed and lip-2.0 sparse meshes at res 256 that
    phase 8 would give."""
    import numpy as np
    import torch

    from nphm_tpu_torch.fitting.inference import FittingConfig, fit_joint
    from nphm_tpu_torch.reconstruction.extract import extract_mesh, extract_mesh_streamed
    from nphm_tpu_torch.reconstruction.sparse import extract_mesh_sparse

    smi = device_and_build()
    device = torch.device("cuda", 0)
    shape, params_shape, expr, params_expr, _gen = build_models(device)
    fitted = fit_joint(shape, params_shape, expr, params_expr, observations(20, 2500, SEED + 3),
                       cfg=FittingConfig(n_steps=FIT_STEPS, seed=SEED), device=device,
                       verbose=False)[:3]
    box = (GRID_MIN, GRID_MAX, EXTRACT_RES)
    lat = fitted[1]
    meshes = {"dense": extract_mesh(shape, params_shape, lat, *box, device=device),
              "streamed": extract_mesh_streamed(shape, params_shape, lat, *box, device=device),
              "sparse_lip2": extract_mesh_sparse(shape, params_shape, lat, *box, lip=2.0,
                                                 transfer_dtype=np.float16, device=device)}
    t0 = time.perf_counter()
    dp_path(fitted, meshes)
    log(f"[phase 13] {time.perf_counter() - t0:.2f} s")
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


def main():
    sys.path.insert(0, ROOT)
    try:
        dp_only() if sys.argv[1:] == ["--dp"] else run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
