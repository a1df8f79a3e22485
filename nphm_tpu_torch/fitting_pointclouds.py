"""Point-cloud fitting and random head sampling from trained experiments
(counterpart of ``scripts/fitting/fitting_pointclouds.py``, same flags and
output layout).

    # sample random heads from the latent prior
    python -m nphm_tpu_torch.fitting_pointclouds -cfg_file configs/fitting_nphm.yaml \\
        -exp_name EXP -exp_tag TAG -sample
    # fit the test split's single-view point clouds (-demo: the dummy tree),
    # S subjects at a time
    python -m nphm_tpu_torch.fitting_pointclouds -cfg_file configs/fitting_nphm.yaml \\
        -exp_name EXP -exp_tag TAG [-demo] [-batch_subjects S]

Experiments are read from ``EXPERIMENT_DIR/{name}/configs.yaml`` and
``checkpoints/``, written by the port's trainer or the JAX package's
(``training.checkpoints.load_checkpoint``).  A fit writes, under
``FITTING_DIR/forward_{exp_name}/{exp_tag}/``, ``configs.yaml`` and for
each subject and expression ``{subj}_{expr}.ply``,
``{subj}_{expr}_lat_shape.npy`` and ``{subj}_{expr}_lat_expr.npy``, then
prints one ``FIT_PHASE_TIMINGS {json}`` line.  ``-sample`` writes
``mesh_NNNN.ply``, ``lat_NNNN.npy`` and a frontal screenshot
``step_NNNN.png`` into ``nphm_shape_space_samples_085``
(``npm_...`` for the NPM family) under the working directory.  Meshes are
extracted as the JAX script extracts them: ``-sparse`` through
``extract_mesh_sparse`` (``-sparse_lip``), else on the card an NPHM model
through ``extract_mesh_streamed``, both with an f16 copy to the host,
else through the dense grid (``extract_mesh``); K1 (NPHM) or K7 (NPM)
evaluates the field.  Posing runs through K7.  Everything runs on the card
unless ``-device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import yaml

from nphm_tpu_torch import env_paths
from nphm_tpu_torch.config import (
    build_expression_decoder,
    build_identity_decoder,
    fitting_overrides_from_cfg,
    load_yaml,
    print_cfg,
)
from nphm_tpu_torch.data.manager import DataManager
from nphm_tpu_torch.evaluation.render import render_screenshot
from nphm_tpu_torch.fitting import FittingConfig, fit_joint, fit_joint_batch
from nphm_tpu_torch.reconstruction.extract import (
    deform_mesh_batch,
    extract_mesh,
    extract_mesh_streamed,
)
from nphm_tpu_torch.reconstruction.sparse import extract_mesh_sparse
from nphm_tpu_torch.training import checkpoints as ckpt
from nphm_tpu_torch.utils.params import default_device, from_numpy_pytree

GRID_MIN = (-0.55, -0.5, -0.95)
GRID_MAX = (0.55, 0.75, 0.4)


def load_experiment(exp_name: str, checkpoint_epoch, local: bool, kind: str, device):
    """A decoder and its trained params on ``device`` from an experiment."""
    weight_dir = os.path.join(env_paths.EXPERIMENT_DIR, exp_name)
    cfg = load_yaml(os.path.join(weight_dir, "configs.yaml"))
    print_cfg(cfg, f"{kind} model configs ({exp_name})")
    data = ckpt.load_checkpoint(os.path.join(weight_dir, "checkpoints"), checkpoint_epoch)
    if data is None:
        raise FileNotFoundError(f"no checkpoint in {weight_dir}/checkpoints")
    if kind == "shape":
        decoder = build_identity_decoder(cfg["decoder"], local=local)
    else:
        decoder = build_expression_decoder(cfg, cfg["ex_decoder"].get("mode", "compress"))
    return decoder, from_numpy_pytree(data["params"], device), data, cfg


def extract(args, decoder_shape, params_shape, lat, device, sparse: bool):
    """The canonical mesh of a shape code, by the JAX script's choice of
    path: sparse two-pass when ``sparse``; streamed over x-slabs for an
    NPHM model on the card; the dense grid otherwise."""
    if sparse:
        return extract_mesh_sparse(decoder_shape, params_shape, lat, GRID_MIN, GRID_MAX,
                                   args.resolution, lip=args.sparse_lip,
                                   transfer_dtype=np.float16, device=device)
    if torch.device(device).type == "cuda" and decoder_shape.kind == "nphm":
        return extract_mesh_streamed(decoder_shape, params_shape, lat, GRID_MIN, GRID_MAX,
                                     args.resolution, transfer_dtype=np.float16,
                                     device=device)
    return extract_mesh(decoder_shape, params_shape, lat, GRID_MIN, GRID_MAX,
                        args.resolution, device=device)


def sample_shape_space(args, CFG, decoder_shape, params_shape, device):
    local = CFG["local_shape"]
    out_dir = "nphm_shape_space_samples_085" if local else "npm_shape_space_samples_085"
    print(f"Saving random samples in {out_dir}")
    os.makedirs(out_dir, exist_ok=True)
    prefix = "nphm" if local else "npm"
    lat_mean = np.load(os.path.join(env_paths.ASSETS, f"{prefix}_lat_mean.npy"))
    lat_std = np.load(os.path.join(env_paths.ASSETS, f"{prefix}_lat_std.npy"))
    rng = np.random.default_rng(args.seed)
    for step in range(args.n_samples):
        lat = (rng.normal(size=lat_mean.shape) * lat_std * 0.85 + lat_mean).astype(
            np.float32)[None]
        mesh = extract(args, decoder_shape, params_shape, lat, device, sparse=False)
        mesh.export(os.path.join(out_dir, f"mesh_{step:04d}.ply"))
        np.save(os.path.join(out_dir, f"lat_{step:04d}.npy"), lat)
        # the reference's plotter screenshot of each sample (its
        # fitting_pointclouds.py:222), best effort as in the JAX script
        try:
            render_screenshot(mesh, os.path.join(out_dir, f"step_{step:04d}.png"))
        except (OSError, RuntimeError, ValueError) as e:
            print(f"screenshot failed: {e}")
        print(f"sample {step}: {len(mesh.vertices)} verts")


def fit_pointclouds(args, CFG, decoder_shape, params_shape, decoder_expr, params_expr,
                    out_dir, device):
    manager = DataManager(dummy_path=env_paths.DUMMY_DATA if args.demo else None)
    subjects = [351, 365] if args.demo else env_paths.subjects_test
    if args.subjects:
        subjects = list(args.subjects)

    print("############ Starting Fitting ############")
    # wall time of the fit, extraction and posing + export, one JSON line
    timings = {"fit_s": 0.0, "extract_s": 0.0, "deform_export_s": 0.0}
    biters = []
    group_walls = []  # the first group's wall holds the kernels' first launches
    fcfg = FittingConfig(
        n_steps=args.n_steps, step_scale=args.step_scale, seed=args.seed,
        broyden_frac_exit=args.broyden_frac_exit,
        ift_jacobian=args.ift_jacobian,
        warm_identity_jacobian=args.warm_identity_jacobian,
        warm_jacobian_store=not args.no_warm_jacobian_store,
        broyden_warm_steps=args.broyden_warm_steps,
    )
    lambdas, schedule = fitting_overrides_from_cfg(CFG)
    fit_kw = dict(cfg=fcfg, lambdas=lambdas, schedule=schedule, device=device)
    group_size = max(1, args.batch_subjects)
    loaded = []
    for subj in subjects:
        inds = manager.get_expressions(subj, testing=True)
        if not inds:
            print(f"Skipping subject {subj}: no valid test expressions")
            continue
        all_obs = [manager.get_single_view_obs(subj, expr_ind, include_back=(k == 0))
                   for k, expr_ind in enumerate(inds)]
        loaded.append((subj, inds, all_obs))
    # every group padded to the same (obs, points, subjects) shape, as in the
    # JAX script; a single short group keeps its exact size
    pad_obs_to = max((len(o) for _, _, o in loaded), default=0)
    pad_points_to = max((len(ob) for _, _, o in loaded for ob in o), default=0)
    pad_subjects_to = group_size if len(loaded) > group_size else 0
    for start in range(0, len(loaded), group_size):
        per_subj = loaded[start : start + group_size]
        for subj, inds, _ in per_subj:
            print(f"Fitting subject {subj} (expressions: {inds})")
        t_fit = time.time()
        if len(per_subj) > 1:
            lat_exprs, lat_shapes, anchors_l, hist = fit_joint_batch(
                decoder_shape, params_shape, decoder_expr, params_expr,
                [obs for _, _, obs in per_subj], pad_obs_to=pad_obs_to,
                pad_points_to=pad_points_to, pad_subjects_to=pad_subjects_to, **fit_kw,
            )
        else:
            le, ls, an, hist = fit_joint(decoder_shape, params_shape, decoder_expr,
                                         params_expr, per_subj[0][2], **fit_kw)
            lat_exprs, lat_shapes, anchors_l = [le], [ls], [an]
        wall = time.time() - t_fit
        timings["fit_s"] += wall
        group_walls.append(round(wall, 1))
        biters.append(float(np.mean(hist["broyden_iters"])))
        for (subj, inds, _), lat_expr, lat_shape, anchors in zip(
            per_subj, lat_exprs, lat_shapes, anchors_l
        ):
            ex_s, de_s = _export_subject(args, out_dir, decoder_shape, params_shape,
                                         decoder_expr, params_expr, subj, inds, lat_expr,
                                         lat_shape, anchors, device)
            timings["extract_s"] += ex_s
            timings["deform_export_s"] += de_s
    if biters:
        timings["mean_broyden_iters"] = round(float(np.mean(biters)), 3)
    timings["fit_group_walls_s"] = group_walls
    print("FIT_PHASE_TIMINGS " + json.dumps(
        {k: round(v, 1) if isinstance(v, float) else v for k, v in timings.items()}
    ))


def _export_subject(args, out_dir, decoder_shape, params_shape, decoder_expr,
                    params_expr, subj, inds, lat_expr, lat_shape, anchors, device):
    """Extract, pose and export one fitted subject; returns the wall time
    of (extraction, posing + export)."""
    t0 = time.time()
    mesh_can = extract(args, decoder_shape, params_shape, lat_shape, device, args.sparse)
    extract_s = time.time() - t0
    t0 = time.time()
    meshes = deform_mesh_batch(
        mesh_can, decoder_expr, params_expr, [lat_expr[i][None] for i in range(len(inds))],
        anchors=anchors, lat_shape=lat_shape, chunk_size=args.batch_points, device=device,
    )
    for i, expr_ind in enumerate(inds):
        meshes[i].export(os.path.join(out_dir, f"{subj}_{expr_ind}.ply"))
        np.save(os.path.join(out_dir, f"{subj}_{expr_ind}_lat_shape.npy"), lat_shape)
        np.save(os.path.join(out_dir, f"{subj}_{expr_ind}_lat_expr.npy"), lat_expr[i][None])
    print(f"exported {len(inds)} expressions for subject {subj}")
    return extract_s, time.time() - t0


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Run generation")
    parser.add_argument("-resolution", default=256, type=int)
    parser.add_argument("-batch_points", default=65536, type=int,
                        help="vertices a chunk when posing on the CPU")
    parser.add_argument("-cfg_file", type=str, required=True)
    parser.add_argument("-exp_name", type=str, required=True)
    parser.add_argument("-exp_tag", type=str, required=True)
    parser.add_argument("-demo", action="store_true")
    parser.add_argument("-sample", action="store_true")
    parser.add_argument("-n_samples", type=int, default=100)
    parser.add_argument("-n_steps", type=int, default=1000)
    parser.add_argument("-step_scale", type=float, default=1.0)
    parser.add_argument("-seed", type=int, default=0)
    parser.add_argument("-batch_subjects", type=int, default=1,
                        help="fit this many subjects per batched fit")
    parser.add_argument("-subjects", type=int, nargs="*", default=None,
                        help="restrict fitting to these subject ids (default: the test split)")
    parser.add_argument("-sparse", action="store_true",
                        help="sparse two-pass extraction (O(surface); eikonal-trained SDFs)")
    parser.add_argument("-sparse_lip", type=float, default=2.0,
                        help="Lipschitz bound for the sparse coarse-pass margin")
    parser.add_argument("-broyden_frac_exit", type=float,
                        default=FittingConfig.broyden_frac_exit,
                        help="stop a Broyden search once at most this fraction of points "
                             "is still active (0 = exact any(active) semantics)")
    parser.add_argument("-ift_jacobian", type=str, default=FittingConfig.ift_jacobian,
                        choices=("exact", "broyden"),
                        help="inverse Jacobian of the IFT gradient: exact (3 JVPs a step) "
                             "or the search's secant J^-1")
    parser.add_argument("-warm_identity_jacobian", action="store_true",
                        help="start warm Broyden searches at J = I")
    parser.add_argument("-no_warm_jacobian_store", action="store_true",
                        help="do not carry the refined J^-1 across fit steps")
    parser.add_argument("-broyden_warm_steps", type=int,
                        default=FittingConfig.broyden_warm_steps,
                        help="per-step Broyden budget once the warm store is primed")
    parser.add_argument("-device", type=str, default=None,
                        help="torch device (default: the GPU)")
    args, _ = parser.parse_known_args(argv)
    return args


def main(argv=None):
    args = parse_args(argv)
    device = default_device() if args.device is None else args.device
    CFG = load_yaml(args.cfg_file)
    print_cfg(CFG)
    decoder_shape, params_shape, _, _ = load_experiment(
        CFG["exp_name_shape"], CFG["checkpoint_shape"], CFG["local_shape"], "shape", device)
    decoder_expr = params_expr = None
    if CFG.get("exp_name_expr"):
        decoder_expr, params_expr, _, _ = load_experiment(
            CFG["exp_name_expr"], CFG["checkpoint_expr"], CFG["local_shape"], "expr", device)

    out_dir = os.path.join(env_paths.FITTING_DIR, f"forward_{args.exp_name}", args.exp_tag)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "configs.yaml"), "w") as f:
        yaml.safe_dump(CFG, f, default_flow_style=False)

    if args.sample:
        sample_shape_space(args, CFG, decoder_shape, params_shape, device)
    else:
        fit_pointclouds(args, CFG, decoder_shape, params_shape, decoder_expr, params_expr,
                        out_dir, device)


if __name__ == "__main__":
    main()
