"""Stage-1 training CLI, the identity SDF space (counterpart of
``scripts/training/train.py``, same flags plus ``-device``):

    python -m nphm_tpu_torch.train -exp_name EXP -cfg_file configs/nphm.yaml -local

The first run of an experiment snapshots its config into
``EXPERIMENT_DIR/EXP/configs.yaml``; a rerun reloads that file and resumes
from the latest checkpoint.  Training reads the supervision chunks of
``SUPERVISION_IDENTITY`` (``data.datasets.IdentityDataset``) and runs on
the card unless ``-device cpu`` is given; ``-wandb`` is accepted and
ignored (the port has no wandb hook).  The experiment it writes is what
``train_corresp`` and ``fitting_pointclouds`` load.
"""

from __future__ import annotations

import argparse
import os

import torch

from nphm_tpu_torch import env_paths
from nphm_tpu_torch.config import (
    build_identity_decoder,
    load_yaml,
    print_cfg,
    snapshot_or_reload_config,
)
from nphm_tpu_torch.data.datasets import IdentityDataset
from nphm_tpu_torch.training.trainer import IdentityTrainer
from nphm_tpu_torch.utils.logging_utils import MetricsLogger
from nphm_tpu_torch.utils.params import default_device


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Run Model")
    parser.add_argument("-exp_name", required=True, type=str)
    parser.add_argument("-cfg_file", type=str)
    parser.add_argument("-closed", action="store_true")
    parser.add_argument("-local", action="store_true")
    parser.add_argument("-wandb", action="store_true", help="accepted and ignored")
    parser.add_argument("-seed", type=int, default=0)
    parser.add_argument("-device", type=str, default=None,
                        help="torch device (default: the GPU)")
    args, _ = parser.parse_known_args(argv)
    return args


def main(argv=None):
    args = parse_args(argv)
    device = default_device() if args.device is None else torch.device(args.device)
    cfg = load_yaml(args.cfg_file) if args.cfg_file else None
    exp_dir = os.path.join(env_paths.EXPERIMENT_DIR, args.exp_name)
    cfg = snapshot_or_reload_config(exp_dir, cfg)
    print_cfg(cfg)

    tcfg = cfg["training"]
    kwargs = dict(n_supervision_points_face=tcfg["npoints_decoder"],
                  n_supervision_points_non_face=tcfg["npoints_decoder_non"],
                  batch_size=tcfg["batch_size"], sigma_near=tcfg["sigma_near"],
                  has_anchors=args.local, is_closed=args.closed)
    train_dataset = IdentityDataset(mode="train", **kwargs)
    val_dataset = IdentityDataset(mode="val", **kwargs)
    print(f"Train dataset: {len(train_dataset)} subjects; val: {len(val_dataset)} subjects")

    decoder = build_identity_decoder(cfg["decoder"], local=args.local)
    params = decoder.init(torch.Generator().manual_seed(args.seed), device)
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"Number of parameters in decoder: {n_params}")

    trainer = IdentityTrainer(decoder, params, cfg, train_dataset, val_dataset, args.exp_name,
                              logger=MetricsLogger(log_dir=exp_dir), seed=args.seed,
                              recon_resolution=tcfg.get("recon_resolution", 256),
                              device=device)
    trainer.train_model(tcfg.get("nepochs", 30001))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


if __name__ == "__main__":
    main()
