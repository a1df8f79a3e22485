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

Data parallel under ``torchrun`` (one process per device):

    torchrun --nproc_per_node N -m nphm_tpu_torch.train -exp_name EXP ...

With ``WORLD_SIZE`` > 1 and ``training.data_parallel`` (default true) the
ranks join one process group (``-backend``: default ``nccl`` on the GPU,
``gloo`` on the CPU; ranks that share a card need ``gloo``) and train one
model data-parallel on ``cuda:LOCAL_RANK`` (or ``-device``); rank 0 alone
writes the snapshot, metrics and checkpoints.  With ``data_parallel:
false`` rank 0 trains alone and the other ranks exit.
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
from nphm_tpu_torch.parallel.mesh import barrier, device_of, get_device_mesh, is_main
from nphm_tpu_torch.training.trainer import IdentityTrainer
from nphm_tpu_torch.utils.logging_utils import MetricsLogger


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Run Model")
    parser.add_argument("-exp_name", required=True, type=str)
    parser.add_argument("-cfg_file", type=str)
    parser.add_argument("-closed", action="store_true")
    parser.add_argument("-local", action="store_true")
    parser.add_argument("-wandb", action="store_true", help="accepted and ignored")
    parser.add_argument("-seed", type=int, default=0)
    parser.add_argument("-device", type=str, default=None,
                        help="torch device (default: the GPU, cuda:LOCAL_RANK under torchrun)")
    parser.add_argument("-backend", type=str, default=None, choices=("nccl", "gloo"),
                        help="torch.distributed backend of a data-parallel run "
                             "(default: nccl on the GPU, gloo on the CPU)")
    args, _ = parser.parse_known_args(argv)
    return args


def setup_run(args, exp_dir: str, cfg):
    """(cfg, device, mesh) of a training CLI run: the data-parallel mesh
    under ``torchrun`` (None in one process, or with ``training.
    data_parallel: false``, where the ranks past 0 get cfg None and exit),
    and the experiment's config, snapshotted by rank 0 and read by the
    others after it."""
    mesh = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        snap = os.path.join(exp_dir, "configs.yaml")
        known = load_yaml(snap) if cfg is None and os.path.exists(snap) else cfg
        if known is None or known["training"].get("data_parallel", True):
            mesh = get_device_mesh(backend=args.backend, device=args.device)
        elif int(os.environ["RANK"]) > 0:
            print(f"rank {os.environ['RANK']}: training.data_parallel is false; rank 0 "
                  f"trains alone")
            return None, None, None
    if is_main(mesh):
        cfg = snapshot_or_reload_config(exp_dir, cfg)
        print_cfg(cfg)
        if mesh is not None:
            print(f"Data-parallel training over {mesh.size} devices ({mesh.backend})")
    barrier(mesh)
    if not is_main(mesh):
        cfg = load_yaml(os.path.join(exp_dir, "configs.yaml"))
    return cfg, device_of(args.device, mesh), mesh


def main(argv=None):
    args = parse_args(argv)
    cfg = load_yaml(args.cfg_file) if args.cfg_file else None
    exp_dir = os.path.join(env_paths.EXPERIMENT_DIR, args.exp_name)
    cfg, device, mesh = setup_run(args, exp_dir, cfg)
    if cfg is None:
        return
    main_rank = is_main(mesh)

    tcfg = cfg["training"]
    kwargs = dict(n_supervision_points_face=tcfg["npoints_decoder"],
                  n_supervision_points_non_face=tcfg["npoints_decoder_non"],
                  batch_size=tcfg["batch_size"], sigma_near=tcfg["sigma_near"],
                  has_anchors=args.local, is_closed=args.closed)
    train_dataset = IdentityDataset(mode="train", **kwargs)
    val_dataset = IdentityDataset(mode="val", **kwargs)
    decoder = build_identity_decoder(cfg["decoder"], local=args.local)
    params = decoder.init(torch.Generator().manual_seed(args.seed), device)
    if main_rank:
        print(f"Train dataset: {len(train_dataset)} subjects; val: {len(val_dataset)} "
              f"subjects")
        print(f"Number of parameters in decoder: {sum(t.numel() for t in _leaves(params))}")

    trainer = IdentityTrainer(decoder, params, cfg, train_dataset, val_dataset, args.exp_name,
                              logger=MetricsLogger(log_dir=exp_dir if main_rank else None,
                                                   quiet=not main_rank),
                              seed=args.seed,
                              recon_resolution=tcfg.get("recon_resolution", 256),
                              device=device, mesh=mesh)
    trainer.train_model(tcfg.get("nepochs", 30001))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


if __name__ == "__main__":
    main()
