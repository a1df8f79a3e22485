"""Stage-2 training CLI, the forward deformation field and expression space
(counterpart of ``scripts/training/train_corresp.py``, same flags plus
``-device``):

    python -m nphm_tpu_torch.train_corresp -exp_name EXP \\
        -cfg_file configs/nphm_def.yaml -mode compress

The config's ``training.shape_exp_name`` (and ``shape_ckpt``) names the
stage-1 experiment whose frozen decoder and latent tables it loads, from
either package's trainer.  Snapshot and resume as in ``train``; ``-ckpt``
picks the checkpoint to resume from.  Runs on the card unless ``-device
cpu`` is given; ``-wandb`` is accepted and ignored.  Under ``torchrun`` it
trains data-parallel as ``train`` does (``-backend``,
``training.data_parallel``).
"""

from __future__ import annotations

import argparse
import os

import torch

from nphm_tpu_torch import env_paths
from nphm_tpu_torch.config import (
    build_expression_decoder,
    build_identity_decoder,
    load_yaml,
)
from nphm_tpu_torch.data.datasets import DeformationDataset
from nphm_tpu_torch.parallel.mesh import is_main
from nphm_tpu_torch.train import setup_run
from nphm_tpu_torch.training.trainer_corresp import DeformationTrainer
from nphm_tpu_torch.utils.logging_utils import MetricsLogger


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Run Model")
    parser.add_argument("-exp_name", required=True, type=str)
    parser.add_argument("-cfg_file", type=str)
    parser.add_argument("-ckpt", type=int)
    parser.add_argument("-mode", required=True, type=str)
    parser.add_argument("-wandb", action="store_true", help="accepted and ignored")
    parser.add_argument("-seed", type=int, default=0)
    parser.add_argument("-device", type=str, default=None,
                        help="torch device (default: the GPU, cuda:LOCAL_RANK under torchrun)")
    parser.add_argument("-backend", type=str, default=None, choices=("nccl", "gloo"),
                        help="torch.distributed backend of a data-parallel run "
                             "(default: nccl on the GPU, gloo on the CPU)")
    args, _ = parser.parse_known_args(argv)
    return args


def main(argv=None):
    args = parse_args(argv)
    cfg = load_yaml(args.cfg_file) if args.cfg_file else None
    if cfg is not None:
        cfg.setdefault("ex_decoder", {})["mode"] = args.mode
    exp_dir = os.path.join(env_paths.EXPERIMENT_DIR, args.exp_name)
    cfg, device, mesh = setup_run(args, exp_dir, cfg)
    if cfg is None:
        return
    main_rank = is_main(mesh)
    if args.ckpt is not None:
        cfg["training"]["ckpt"] = args.ckpt

    tcfg = cfg["training"]
    train_dataset = DeformationDataset("train", tcfg["npoints_decoder"], tcfg["batch_size"])
    val_dataset = DeformationDataset("val", tcfg["npoints_decoder"], tcfg["batch_size"])
    if main_rank:
        print(f"Train dataset: {len(train_dataset)} scans; val: {len(val_dataset)}")

    decoder = build_expression_decoder(cfg, args.mode)
    params = decoder.init(torch.Generator().manual_seed(args.seed), device)
    decoder_shape = None
    if "shape_exp_name" in tcfg:
        decoder_shape = build_identity_decoder(cfg["id_decoder"], local=(args.mode != "npm"))

    trainer = DeformationTrainer(decoder, params, decoder_shape, cfg, train_dataset,
                                 val_dataset, args.exp_name,
                                 logger=MetricsLogger(log_dir=exp_dir if main_rank else None,
                                                      quiet=not main_rank),
                                 seed=args.seed,
                                 recon_resolution=tcfg.get("recon_resolution", 256),
                                 device=device, mesh=mesh)
    trainer.train_model(tcfg.get("nepochs", 8000))


if __name__ == "__main__":
    main()
