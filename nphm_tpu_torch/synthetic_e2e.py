"""Production-widths end-to-end quality run on synthetic analytic geometry
(counterpart of ``scripts/validation/synthetic_e2e.py``, same flags plus
``--device`` and ``--seed``):

    python -m nphm_tpu_torch.synthetic_e2e [--epochs 1500] [--def_epochs 300]
        [--subjects 16] [--resolution 128] [--fit_steps 500] [--tiny]
        [--device D] [--seed S]

The CPU accuracy gates (``tests/test_torch_accuracy_gate*.py``) hold
reconstruction quality at tiny widths.  This runs the same observe ->
train -> fit -> extract -> deform -> evaluate loop at the production widths
(``NPHMConfig()``: 39 anchors, 1344-d latent; ``DeformationConfig()``:
compress mode, 6 x 512 trunk) on closed-form ellipsoid heads:

1. stage 1, ``IdentityTrainer`` on ``SyntheticIdentityDataset`` (K5/K6 on
   the card);
2. the reconstruction of a train subject at ``--resolution`` in the
   +-0.7 box (K1);
3. ``fit_identity`` of a held-out ellipsoid from three clouds (K3/K4);
4. stage 2, a compress-mode ``DeformationTrainer`` on
   ``SyntheticDeformationDataset``;
5. the neutral mesh and its pose (K7) against the posed surface;
6. ``fit_joint`` of the held-out ellipsoid from posed clouds (K2-K4), its
   canonical mesh and its pose.

It prints one JSON line with the JAX script's keys: the Chamfer-L1 figures
(box units) and wall seconds; ``backend`` is the card's name (or "cpu").
Weights come from seeded ``torch.Generator``s, so the draw differs from
the JAX script's ``PRNGKey`` init.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np
import torch

from nphm_tpu_torch.data.sampling import sample_mesh_surface
from nphm_tpu_torch.data.synthetic import (
    SyntheticDeformationDataset,
    SyntheticIdentityDataset,
    _ellipsoid_surface,
)
from nphm_tpu_torch.evaluation.metrics import eval_pointcloud
from nphm_tpu_torch.fitting import FittingConfig, fit_identity, fit_joint
from nphm_tpu_torch.models import (
    DeformationConfig,
    NPHMConfig,
    make_deformation_decoder,
    make_nphm_decoder,
    predict_anchors,
)
from nphm_tpu_torch.reconstruction.extract import deform_mesh, extract_mesh
from nphm_tpu_torch.training.trainer import IdentityTrainer
from nphm_tpu_torch.training.trainer_corresp import DeformationTrainer
from nphm_tpu_torch.utils.logging_utils import MetricsLogger
from nphm_tpu_torch.utils.params import default_device

BOX = ((-0.7, -0.7, -0.7), (0.7, 0.7, 0.7))
HELDOUT_RADII = np.array([0.46, 0.52, 0.41], np.float32)
HELDOUT_CENTER = np.array([0.02, -0.01, 0.03], np.float32)


def _chamfer(mesh, gt_pts):
    pred, _ = sample_mesh_surface(mesh, 20000, rng=np.random.default_rng(42))
    return float(eval_pointcloud(pred, gt_pts, metric_space=False)["chamfer_l1"])


def _gt_surface(radii, center, n=20000, seed=42):
    return _ellipsoid_surface(radii, center, n, np.random.default_rng(seed))[0]


def _row(table, i):
    return table[i][None].cpu().numpy()


def model_configs(tiny: bool):
    if tiny:
        cfg_m = NPHMConfig(lat_dim_glob=8, lat_dim_loc=4, n_loc=7, n_symm_pairs=3,
                           hidden_dim=16, n_layers=4, pos_mlp_dim=16)
        dcfg = DeformationConfig(mode="compress", lat_dim_expr=8, lat_dim_id=8,
                                 lat_dim_glob_shape=cfg_m.lat_dim_glob,
                                 lat_dim_loc_shape=cfg_m.lat_dim_loc, n_loc=cfg_m.n_loc,
                                 hidden_dim=32, n_layers=4)
        return cfg_m, dcfg
    return NPHMConfig(), DeformationConfig()  # 39 anchors, 1344-d latent; 6 x 512


def identity_train_cfg(subjects: int, epochs: int) -> dict:
    decay = max(epochs // 3, 1)
    return {"training": {
        "batch_size": subjects, "ckpt_interval": 10**9,
        "grad_clip": 0.1, "grad_clip_lat": 0.1,
        "lr": 0.0008, "lr_lat": 0.002,
        "lr_decay_factor": 0.5, "lr_decay_factor_lat": 0.5,
        "lr_decay_interval": decay, "lr_decay_interval_lat": decay,
        "npoints_decoder": 750, "npoints_decoder_non": 250,
        "sigma_near": 0.01, "weight_decay": 0.01,
        "lambdas": {"lat_reg": 0.01, "surf_sdf": 2.0, "normals": 0.3, "space_sdf": 0.01,
                    "grad": 0.1, "anchors": 7.5, "symm_dist": 0.01, "middle_dist": 0.0},
    }}


def deformation_train_cfg(subjects: int, def_epochs: int) -> dict:
    decay = max(def_epochs // 3, 1)
    return {"training": {
        "batch_size": min(subjects, 8), "ckpt_interval": 10**9,
        "grad_clip": 0.025, "grad_clip_lat": 0.025,
        "lambdas": {"corresp": 100.0, "lat_reg": 5e-5, "loss_reg_zero": 5e-5},
        "lr": 0.0005, "lr_lat": 0.0025,
        "lr_decay_factor": 0.5, "lr_decay_factor_lat": 0.5,
        "lr_decay_interval": decay, "lr_decay_interval_lat": decay,
        "weight_decay": 0.0005,
    }}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=1500)
    ap.add_argument("--def_epochs", type=int, default=300)
    ap.add_argument("--subjects", type=int, default=16)
    ap.add_argument("--resolution", type=int, default=128)
    ap.add_argument("--fit_steps", type=int, default=500)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny widths for a quick smoke run (CPU)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of both decoders' init generators")
    return ap.parse_args(argv)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    args = parse_args(argv)
    device = default_device() if args.device is None else torch.device(args.device)
    backend = torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
    out = {"backend": backend, "production_dims": not args.tiny}
    t_all = time.time()
    cfg_m, dcfg = model_configs(args.tiny)
    recon_res = 32 if args.tiny else 256  # the trainers' epoch-0 log_recs

    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(cfg_m.n_loc, 3))
    mean_anchors = (0.45 * dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
                    ).astype(np.float32)
    dec = make_nphm_decoder(cfg_m, mean_anchors)
    params = dec.init(torch.Generator().manual_seed(args.seed), device)

    # --- stage 1: identity training on analytic ellipsoids ---------------
    ident = SyntheticIdentityDataset(n_subjects=args.subjects, n_face=750, n_non_face=250,
                                     batch_size=args.subjects, n_anchors=cfg_m.n_loc, seed=0)
    val = SyntheticIdentityDataset(n_subjects=2, n_face=750, n_non_face=250, batch_size=2,
                                   n_anchors=cfg_m.n_loc, seed=5)
    with tempfile.TemporaryDirectory() as tmp:
        tr = IdentityTrainer(dec, params, identity_train_cfg(args.subjects, args.epochs),
                             ident, val, "synth_e2e", exp_dir=tmp,
                             logger=MetricsLogger(quiet=True),
                             recon_resolution=recon_res, device=device)
        t0 = time.time()
        tr.train_model(args.epochs)
        _sync(device)
        out["train_s"] = round(time.time() - t0, 1)
        out["train_steps"] = args.epochs  # one batch per epoch

        # --- reconstruction quality of a train subject -------------------
        t0 = time.time()
        mesh0 = extract_mesh(dec, tr.params, _row(tr.latents, 0), *BOX, args.resolution,
                             device=device)
        out["recon_extract_s"] = round(time.time() - t0, 2)
        out["recon_chamfer"] = round(
            _chamfer(mesh0, _gt_surface(ident.radii[0], ident.centers[0])), 5)

        # --- fit a HELD-OUT ellipsoid from point clouds -------------------
        obs_rng = np.random.default_rng(7)
        obs = [_ellipsoid_surface(HELDOUT_RADII, HELDOUT_CENTER, 2500, obs_rng)[0]
               for _ in range(3)]
        fc = FittingConfig(n_steps=args.fit_steps, n_obs_per_batch=3, n_points_per_obs=1000,
                           log_every=10**9)
        t0 = time.time()
        lat_fit, _anchors, _h = fit_identity(dec, tr.params, obs, cfg=fc, verbose=False,
                                             device=device)
        out["fit_s"] = round(time.time() - t0, 2)
        mesh_fit = extract_mesh(dec, tr.params, np.asarray(lat_fit).reshape(1, -1), *BOX,
                                args.resolution, device=device)
        out["heldout_fit_chamfer"] = round(
            _chamfer(mesh_fit, _gt_surface(HELDOUT_RADII, HELDOUT_CENTER)), 5)

        # --- stage 2: deformation field (compress mode) -------------------
        def_train = SyntheticDeformationDataset(ident, n_expressions=2, n_points=1000,
                                                batch_size=min(args.subjects, 8),
                                                warp_scale=0.08)
        # val warps over the VAL identity dataset: the trainer conditions
        # val batches on shape_state["latents_val"], one row per val subject
        def_val = SyntheticDeformationDataset(val, n_expressions=1, n_points=1000,
                                              batch_size=2, seed=9)
        ddec = make_deformation_decoder(dcfg)
        dparams = ddec.init(torch.Generator().manual_seed(args.seed + 1), device)
        shape_state = {"params": tr.params, "latents": tr.latents.cpu().numpy(),
                       "latents_val": tr.latents_val.cpu().numpy()}
        dtr = DeformationTrainer(ddec, dparams, dec,
                                 deformation_train_cfg(args.subjects, args.def_epochs),
                                 def_train, def_val, "synth_e2e_def", exp_dir=tmp,
                                 shape_state=shape_state, logger=MetricsLogger(quiet=True),
                                 recon_resolution=recon_res, device=device)
        t0 = time.time()
        dtr.train_model(args.def_epochs)
        _sync(device)
        out["def_train_s"] = round(time.time() - t0, 1)

        scan = 1  # (subject 0, expression 1): a genuinely non-neutral warp
        subj = def_train.subject_steps[scan]
        lat_subj = _row(tr.latents, subj)
        mesh_neutral = extract_mesh(dec, tr.params, lat_subj, *BOX, args.resolution,
                                    device=device)
        with torch.no_grad():
            anchors = predict_anchors(tr.params, cfg_m, tr.latents[subj][None])
        mesh_def = deform_mesh(mesh_neutral, ddec, dtr.params, _row(dtr.latents, scan),
                               anchors=anchors[0].cpu().numpy(), lat_shape=lat_subj,
                               device=device)
        gt_posed = def_train.warp(scan, _gt_surface(ident.radii[subj], ident.centers[subj]))
        out["def_neutral_chamfer_vs_posed"] = round(_chamfer(mesh_neutral, gt_posed), 5)
        out["def_deformed_chamfer_vs_posed"] = round(_chamfer(mesh_def, gt_posed), 5)

        # --- the full protocol: joint identity + expression fit of the
        # HELD-OUT subject from POSED observations (Broyden correspondence
        # search through the trained warp, IFT gradients), then canonical
        # extraction and posing ---------------------------------------------
        n_scans = len(def_train.subject_steps)
        warp_scans = [i % n_scans for i in range(3)]  # 3 trained warps
        eval_obs = 1 % len(warp_scans)  # the observation evaluated below
        posed_obs = []
        for i, ws in enumerate(warp_scans):
            cloud = _ellipsoid_surface(HELDOUT_RADII, HELDOUT_CENTER, 2500,
                                       np.random.default_rng(100 + i))[0]
            posed_obs.append(def_train.warp(ws, cloud).astype(np.float32))
        t0 = time.time()
        lat_e, lat_s, anchors_fit, _h = fit_joint(dec, tr.params, ddec, dtr.params, posed_obs,
                                                  cfg=fc, verbose=False, device=device)
        out["joint_fit_s"] = round(time.time() - t0, 2)
        lat_s = np.asarray(lat_s).reshape(1, -1)
        mesh_can = extract_mesh(dec, tr.params, lat_s, *BOX, args.resolution, device=device)
        out["joint_canonical_chamfer"] = round(
            _chamfer(mesh_can, _gt_surface(HELDOUT_RADII, HELDOUT_CENTER)), 5)
        mesh_posed = deform_mesh(mesh_can, ddec, dtr.params, np.asarray(lat_e[eval_obs])[None],
                                 anchors=np.asarray(anchors_fit[0]), lat_shape=lat_s,
                                 device=device)
        gt_posed_heldout = def_train.warp(warp_scans[eval_obs],
                                          _gt_surface(HELDOUT_RADII, HELDOUT_CENTER))
        out["joint_posed_chamfer"] = round(_chamfer(mesh_posed, gt_posed_heldout), 5)

    out["total_s"] = round(time.time() - t_all, 1)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
