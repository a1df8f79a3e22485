"""Does the NPM family's stage-1 field get a zero set, by lr and init draw?

    python -m nphm_tpu_torch.profile_npm_lr [--subjects 16] [--epochs 151]
        [--runs 0.002:0,0.002:1,0.0005:0,0.0005:1] [--device cuda]

Stage-1 training at the widths of ``configs/npm.yaml`` with the protocol's
batch (= the subjects) and latent lr, on a dummy tree of ``--subjects``
training subjects and 2 validation subjects, once for each ``lr:seed`` of
``--runs`` (the seed draws the decoder's init).  After the first epoch and
every 25 after it, one line: the field of training code 0 over a res-24
grid of the fitting box (least and greatest value, positive share: a zero
set needs both signs) and the share of the skip layer's units that are
alive, i.e. whose pre-activation rises above -5/beta somewhere on the grid.
Checkpoints and reconstruction logs are skipped.
"""

from __future__ import annotations

import argparse
import importlib
import os
import tempfile
import time

import numpy as np
import torch

GRID_MIN = (-0.55, -0.5, -0.95)
GRID_MAX = (0.55, 0.75, 0.4)


def field_and_skip_alive(decoder, params, code, grid):
    """The trunk of ``models/deepsdf.py`` unrolled: the field at ``grid`` and
    the skip layer's alive share."""
    from nphm_tpu_torch.models.deepsdf import SQRT2
    from nphm_tpu_torch.models.mlp import softplus_beta

    cfg = decoder.cfg
    _, skip = cfg.layer_shapes
    ds = cfg.d_in_spatial
    layers = params["layers"]
    x, alive = grid, None
    for i, layer in enumerate(layers):
        w, b = layer["w"], layer["b"]
        if i == 0:
            x = grid @ w[:, :ds].T + code @ w[:, ds:].T + b
        elif i == skip:
            h = w.shape[1] - cfg.d_in
            x = (x @ w[:, :h].T + grid @ w[:, h:h + ds].T + code @ w[:, h + ds:].T) / SQRT2 + b
            alive = float((x > -5.0 / cfg.beta).any(dim=0).float().mean())
        else:
            x = x @ w.T + b
        if i < len(layers) - 1:
            x = softplus_beta(x, cfg.beta)
    return x.ravel().float().cpu().numpy(), alive


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--subjects", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=151)
    ap.add_argument("--runs", type=str, default="0.002:0,0.002:1,0.0005:0,0.0005:1")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    runs = [(float(lr), int(seed)) for lr, seed in (r.split(":") for r in args.runs.split(","))]

    from nphm_tpu_torch.data.dummy import dummy_env, generate_dummy_data

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "tree")
        generate_dummy_data(root, subjects=tuple(1000 + i for i in range(args.subjects))
                            + (199, 286), n_expressions=1, n_supervision=100000)
        os.environ.update(dummy_env(root))
        # the data layer reads its paths at import: point it at the new tree
        from nphm_tpu_torch import env_paths
        from nphm_tpu_torch.data import datasets, manager

        for mod in (env_paths, manager, datasets):
            importlib.reload(mod)
        from nphm_tpu_torch.config import build_identity_decoder, load_yaml
        from nphm_tpu_torch.training.trainer import IdentityTrainer
        from nphm_tpu_torch.utils.logging_utils import MetricsLogger

        axes = [np.linspace(a, b, 24, dtype=np.float32) for a, b in zip(GRID_MIN, GRID_MAX)]
        grid = torch.tensor(np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3),
                            device=args.device)
        configs = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                               "configs")
        for lr, seed in runs:
            cfg = load_yaml(os.path.join(configs, "npm.yaml"))
            t = cfg["training"]
            t.update(batch_size=min(args.subjects, 32), lr=lr, lr_lat=0.005, ckpt_interval=25)
            kw = dict(n_supervision_points_face=t["npoints_decoder"],
                      n_supervision_points_non_face=t["npoints_decoder_non"],
                      batch_size=t["batch_size"], sigma_near=t["sigma_near"],
                      has_anchors=False, is_closed=False)
            decoder = build_identity_decoder(cfg["decoder"], local=False)
            trainer = IdentityTrainer(
                decoder, decoder.init(torch.Generator().manual_seed(seed), args.device), cfg,
                datasets.IdentityDataset(mode="train", **kw),
                datasets.IdentityDataset(mode="val", **kw), f"npm_lr_{lr}_{seed}",
                exp_dir=os.path.join(tmp, "exp"), logger=MetricsLogger(quiet=True),
                recon_resolution=16, device=args.device)
            t0 = time.time()

            def reading(epoch, n_recs=5):
                with torch.no_grad():
                    f, alive = field_and_skip_alive(decoder, trainer.params,
                                                    trainer.latents[0:1], grid)
                print(f"[npm lr] lr {lr} seed {seed}, {args.subjects} subjects, epoch "
                      f"{epoch + 1}: field {f.min():.5f} .. {f.max():.5f}, positive share "
                      f"{(f > 0).mean():.3f}, skip layer alive {alive:.3f} "
                      f"({time.time() - t0:.1f} s)", flush=True)

            # the trainer calls log_recs after epoch 0 and every 25th epoch
            trainer.log_recs = reading
            trainer.save_checkpoint = lambda epoch: None
            trainer.train_model(args.epochs)


if __name__ == "__main__":
    main()
