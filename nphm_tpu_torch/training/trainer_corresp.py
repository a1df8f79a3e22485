"""Stage-2 auto-decoder trainer: the forward deformation field and the
expression space (counterpart of ``DeformationTrainer`` in
``nphm_tpu/training/trainer_corresp.py``), on one device.

Behavioural spec: reference ``src/NPHM/models/training_corresp.py``.  The
frozen stage-1 identity decoder and both of its latent tables come from a
stage-1 checkpoint, written by this package or by the JAX package
(``checkpoints.load_checkpoint`` reads either without jax).  Per-scan
expression codes (N(0, 0.01) init, max_norm 1) train against
``deformation_loss`` with AdamW, row-Adam, clipping and validation latents,
as in stage 1 (``AutoDecoderTrainer``).  Anchors come from the frozen
decoder's anchor MLP (reference loss_functions.py:292-294), or from the
batch for a decoder without one.

The deformation field trains in plain torch with autograd; the JAX package
writes no kernel for it either (a step is a few large products).  Its
compress-mode noise and the prior's sample points come from ``self.draws``
(default: a generator seeded with ``seed + 1``); the generator's state is
not checkpointed, so a resumed run draws other noise.  Checkpoints follow
the stage-1 convention: epoch N's is written after its validation and
training resumes at N + 1.  ``log_recs`` reconstructs the frozen identity
(``extract_mesh``: K1 on the GPU) and poses it (``deform_mesh``: K7); an
error there stops training (the JAX trainer prints it and carries on).

Data parallelism (``mesh=``) is the stage-1 trainer's.  Its one stage-2
detail: every rank draws the noise and prior samples of the whole batch, in
the one-device order, and keeps its rows, so a data-parallel step draws
what the one-device step draws (the JAX trainer's replicated key).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from nphm_tpu_torch import env_paths
from nphm_tpu_torch.models.ensemble import predict_anchors
from nphm_tpu_torch.reconstruction.extract import deform_mesh, extract_mesh
from nphm_tpu_torch.training import checkpoints as ckpt
from nphm_tpu_torch.training.losses import deformation_loss, generator_draws
from nphm_tpu_torch.training.trainer import AutoDecoderTrainer
from nphm_tpu_torch.utils.logging_utils import MetricsLogger
from nphm_tpu_torch.utils.params import from_numpy_pytree

RECON_BOX_MIN = (-0.35, -0.45, -0.15)
RECON_BOX_MAX = (0.35, 0.35, 0.35)


def row_draws(draws, rows: slice, n: int):
    """``draws`` of an n-row batch, cut to ``rows``: each draw is made at the
    whole batch's shape (rows lead every draw's shape) and sliced."""

    def draw(kind, shape, device):
        return draws(kind, (n,) + tuple(shape[1:]), device)[rows]

    return draw


class DeformationTrainer(AutoDecoderTrainer):
    def __init__(self, decoder_expr, params_expr, decoder_shape, cfg: dict, train_dataset,
                 val_dataset, exp_name: str, exp_dir: Optional[str] = None,
                 logger: Optional[MetricsLogger] = None, shape_state: Optional[dict] = None,
                 recon_resolution: int = 256, seed: int = 0, device=None, mesh=None):
        self.decoder = decoder_expr
        self.decoder_shape = decoder_shape
        super().__init__(params_expr, cfg, train_dataset, val_dataset, exp_name, exp_dir,
                         logger, recon_resolution, seed, device, decoder_expr.lat_dim, 0.01,
                         mesh)
        if shape_state is None:
            shape_dir = os.path.join(exp_dir or env_paths.EXPERIMENT_DIR,
                                     self.cfg["shape_exp_name"], "checkpoints")
            shape_state = ckpt.load_checkpoint(shape_dir, self.cfg.get("shape_ckpt"))
            if shape_state is None:
                raise FileNotFoundError(f"stage-1 checkpoint not found in {shape_dir}")
        self.params_shape = from_numpy_pytree(shape_state["params"], self.device)
        self.latents_shape = from_numpy_pytree(shape_state["latents"], self.device)
        self.latents_shape_val = from_numpy_pytree(shape_state["latents_val"], self.device)
        self.draws = generator_draws(torch.Generator().manual_seed(seed + 1))
        # seeded random order of the scans log_recs shows (reference
        # training_corresp.py:118)
        perm_rng = np.random.default_rng(seed + 2)
        self.eval_perm = {"train": perm_rng.permutation(len(train_dataset)),
                          "val": perm_rng.permutation(len(val_dataset))}

    def _anchors_for(self, lat_shape, batch):
        """Anchors [B, K, 3] from the frozen identity decoder's anchor MLP
        (NPHM), else the batch's GT anchors."""
        if self.decoder_shape is not None and self.decoder_shape.kind == "nphm":
            with torch.no_grad():
                return predict_anchors(self.params_shape, self.decoder_shape.cfg, lat_shape)
        return batch.get("gt_anchors")

    def _loss(self, params, table, batch, *, val: bool, rows=None):
        idx = batch["idx"].reshape(-1).long()
        shape_table = self.latents_shape_val if val else self.latents_shape
        lat_shape = shape_table[batch["subj_ind"].reshape(-1).long()]
        draws = self.draws if rows is None else row_draws(self.draws, *rows)
        terms = deformation_loss(self.decoder, params, batch, lat_shape, table[idx],
                                 self._anchors_for(lat_shape, batch), training=not val,
                                 draws=draws)
        loss = sum(self.lambdas[k] * terms[k] for k in terms)
        return loss, terms

    def lr_lat_at(self, epoch: int) -> float:
        """Latent LR under plain step decay (no epoch-1000 gate in stage 2)."""
        interval = self.cfg.get("lr_decay_interval_lat")
        if not interval:
            return self.cfg["lr_lat"]
        return self.cfg["lr_lat"] * self.cfg["lr_decay_factor_lat"] ** (epoch // interval)

    def log_recs(self, epoch: int, mode: str = "val", n_recs: int = 5):
        """For ``n_recs`` scans of the seeded ``eval_perm``, export (reference
        training_corresp.py:327-411) ``mesh_{subj}_neutral.ply``, the frozen
        identity's reconstruction, and ``mesh_{subj}_e{expr}.ply``, that mesh
        posed by the deformation field; with a ``DataManager`` also
        ``gt_{subj}_e{expr}.ply`` (the posed registration),
        ``reg_{subj}_neutral.ply`` (the neutral registration) and
        ``reg_{subj}_e{expr}.ply`` (the neutral registration posed)."""
        if self.decoder_shape is None:
            return
        d_set = self.train_dataset if mode == "train" else self.val_dataset
        table = self.latents if mode == "train" else self.latents_val
        shape_table = self.latents_shape if mode == "train" else self.latents_shape_val
        exp_dir = os.path.join(self.exp_path, "recs", f"{mode}_epoch_{epoch}")
        os.makedirs(exp_dir, exist_ok=True)
        manager = getattr(d_set, "manager", None)
        for jj in range(min(n_recs, len(d_set))):
            rnd = int(self.eval_perm[mode][(jj + self.log_steps) % len(d_set)])
            self.log_steps += 1
            subj = d_set.subject_steps[rnd]
            expr = d_set.steps[rnd] if hasattr(d_set, "steps") else rnd
            lat_shape = shape_table[int(d_set.subject_index[rnd])][None]
            anchors = self._anchors_for(lat_shape, {})
            lat_shape = lat_shape.cpu().numpy()
            lat_expr = table[rnd][None].cpu().numpy()
            anchors = None if anchors is None else anchors.cpu().numpy()

            def pose(m):
                return deform_mesh(m, self.decoder, self.params, lat_expr, anchors=anchors,
                                   lat_shape=lat_shape, device=self.device)

            mesh = extract_mesh(self.decoder_shape, self.params_shape, lat_shape,
                                RECON_BOX_MIN, RECON_BOX_MAX, self.recon_resolution,
                                device=self.device)
            mesh.export(os.path.join(exp_dir, f"mesh_{subj}_neutral.ply"))
            pose(mesh).export(os.path.join(exp_dir, f"mesh_{subj}_e{expr}.ply"))
            if manager is not None:
                m_gt = manager.get_registration_mesh(subject=subj,
                                                     expression=d_set.neutral_expr_index[subj])
                manager.get_registration_mesh(subject=subj, expression=expr).export(
                    os.path.join(exp_dir, f"gt_{subj}_e{expr}.ply"))
                m_gt.export(os.path.join(exp_dir, f"reg_{subj}_neutral.ply"))
                pose(m_gt).export(os.path.join(exp_dir, f"reg_{subj}_e{expr}.ply"))
