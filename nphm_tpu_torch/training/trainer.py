"""Stage-1 auto-decoder trainer (counterpart of ``IdentityTrainer`` in
``nphm_tpu/training/trainer.py``), on one device, and the machinery it
shares with the stage-2 trainer (``AutoDecoderTrainer``).

Behavioural spec: reference ``src/NPHM/models/training.py``
(TrainerAutoDecoder): per-subject latent tables (max_norm 1, N(0,
0.1/sqrt(d)) init) optimised with SparseAdam, the decoder with AdamW
(weight decay, ``mean_anchors`` excluded), global-norm gradient clips,
step-decay learning rates (the latent decay gated on epoch > 1000), a
validation loop that optimises validation latents with the decoder frozen,
best-val marker files, full-state checkpoints and reconstruction logging.

The NPHM decoder's fields run through K5/K6 (``ops.train_fields``) when
``fused_train_kernel`` is "auto" and the device is CUDA, or when it is
true; otherwise through the decoder and an autograd spatial gradient.

Data parallelism (``mesh=``, a ``parallel.DataMesh`` of more than one
rank; the counterpart of the JAX trainers' ``mesh=``): every rank iterates
the same batches, renorms the whole batch's latent rows, and computes the
loss on its contiguous block of rows (K5/K6 on the local shard).  Every
loss term is a mean over equal-sized row blocks (or over the parameters
alone), so the one-device loss is the mean of the ranks' losses: the
parameter and latent-table gradients are all-reduced (mean) before the
clips, and every rank applies the same update, so the replicas stay
bit-equal.  A batch whose size the rank count does not divide runs whole on
every rank with no collective (the JAX trainers' ``_pick``).  The epoch's
metric sums are all-reduced once, before the host pull.  Rank 0 alone
writes metrics, checkpoints, best-val markers and reconstruction logs;
every rank reads the checkpoint on resume.

Resume is exact: the checkpoint of epoch N is written at the end of the
epoch (after validation) and training resumes at epoch N + 1, so a resumed
run equals an uninterrupted one.  (The JAX trainer writes it before
validation and repeats epoch N, so its checkpoint of epoch N holds the
validation latents before that epoch's update; see ``checkpoints``.)

``training.matmul_precision`` (JAX's names, default "default") scopes each
train and validation step with ``ops.precision.matmul_precision``, as the
JAX trainers scope their jitted steps: "default" is fp32 with TF32 off,
"high" rounds every product's operands to TF32 and "bfloat16" to bf16
(the models' products and K3-K6 alike; ``ops/precision.py``).
``training.remat`` recomputes the decoder forward in the backward pass on
the plain fields path (``losses.identity_sdf_loss``); K5/K6 ignore it.  It
is off by default, where the JAX package's default is on: in torch the
recompute costs the step time and memory (``losses.identity_sdf_loss``).
"""

from __future__ import annotations

import functools
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from nphm_tpu_torch import env_paths
from nphm_tpu_torch.ops import precision
from nphm_tpu_torch.parallel.mesh import (
    all_reduce_mean,
    barrier,
    broadcast_state,
    data_parallel,
    device_of,
    is_main,
    shard_rows,
)
from nphm_tpu_torch.reconstruction.extract import extract_mesh
from nphm_tpu_torch.training import checkpoints as ckpt
from nphm_tpu_torch.training.latents import (
    RowAdamState,
    clip_global_norm,
    renorm_rows,
    row_adam_init,
    row_adam_update,
)
from nphm_tpu_torch.training.losses import identity_sdf_loss
from nphm_tpu_torch.utils.logging_utils import MetricsLogger
from nphm_tpu_torch.utils.params import from_numpy_pytree, to_numpy_pytree
from nphm_tpu_torch.utils.profiling import StepTimer

RECON_BOX_MIN = (-0.4, -0.6, -0.7)
RECON_BOX_MAX = (0.4, 0.6, 0.5)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
NO_DECAY = ("mean_anchors",)  # buffers, not trained: no weight decay


def tree_paths(tree, prefix=()):
    """(path, leaf) pairs in the JAX pytree order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, prefix + (i,))
    else:
        yield prefix, tree


def tree_rebuild(tree, leaves):
    """Same structure as ``tree`` with leaves taken in ``tree_paths`` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)


def _scoped(step):
    """Run a trainer step at the trainer's matmul precision."""

    @functools.wraps(step)
    def scoped(self, *args, **kwargs):
        with precision.matmul_precision(self.matmul_precision):
            return step(self, *args, **kwargs)

    return scoped


class _TermAccumulator:
    """Sum per-step metric dicts on the device; one host pull per epoch."""

    def __init__(self):
        self.keys = None
        self.vec = None
        self.count = 0

    def add(self, terms: dict) -> None:
        if self.keys is None:
            self.keys = sorted(terms)
        vec = torch.stack([terms[k].detach().reshape(()) for k in self.keys])
        self.vec = vec if self.vec is None else self.vec + vec
        self.count += 1

    def averages(self, mesh=None) -> dict:
        """Per-step means; with a mesh, of the ranks' mean (one all-reduce)."""
        if self.count == 0:
            return {}
        if mesh is not None:
            all_reduce_mean(self.vec, mesh)
        vals = self.vec.cpu().numpy() / self.count
        return {k: float(v) for k, v in zip(self.keys, vals)}


class AutoDecoderTrainer:
    """What both auto-decoder trainers share (stage 1 here, stage 2 in
    ``trainer_corresp``): train and validation latent tables (max_norm 1),
    AdamW on the decoder (decay masked off ``NO_DECAY``), row-Adam on the
    latents, global-norm clips, the epoch loop with validation, best-val
    markers, checkpoints, resume and data parallelism.  A subclass sets
    ``self.decoder`` and defines ``_loss(params, table, batch, *, val,
    rows)`` (rows: None, or (slice, n) when ``batch`` is that slice of an
    n-row batch), ``lr_lat_at`` and ``log_recs``."""

    def __init__(self, params, cfg: dict, train_dataset, val_dataset, exp_name: str,
                 exp_dir: Optional[str], logger: Optional[MetricsLogger],
                 recon_resolution: int, seed: int, device, lat_dim: int, lat_std: float,
                 mesh=None):
        self.mesh = data_parallel(mesh)
        self.device = device_of(device, mesh)
        self.main = is_main(self.mesh)
        self.cfg = cfg["training"]
        self.matmul_precision = precision.resolve(
            self.cfg.get("matmul_precision", "default"))
        self.lambdas = dict(self.cfg["lambdas"])
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.recon_resolution = recon_resolution

        self.exp_path = os.path.join(exp_dir or env_paths.EXPERIMENT_DIR, exp_name)
        self.checkpoint_path = os.path.join(self.exp_path, "checkpoints")
        if self.main:
            os.makedirs(self.checkpoint_path, exist_ok=True)
        self.logger = logger or MetricsLogger(log_dir=self.exp_path if self.main else None,
                                              quiet=not self.main)

        gen = torch.Generator().manual_seed(seed)
        self.latents = (torch.randn((len(train_dataset), lat_dim), generator=gen)
                        * lat_std).to(self.device)
        self.latents_val = (torch.randn((len(val_dataset), lat_dim), generator=gen)
                            * lat_std).to(self.device)
        self.max_norm = 1.0

        self.params = from_numpy_pytree(to_numpy_pytree(params), self.device)
        # replicas start from rank 0's state
        broadcast_state([self.params, self.latents, self.latents_val], self.mesh)
        self.opt_state = self._adamw_init(self.params)
        self.lat_state = row_adam_init(self.latents)
        self.lat_state_val = row_adam_init(self.latents_val)
        self.val_min = None
        self.log_steps = 0
        self._timer = StepTimer(self.device)

    # -------------------------------------------------------------- optimizer

    @staticmethod
    def _adamw_init(params):
        zeros = [torch.zeros_like(p) for _, p in tree_paths(params)]
        return {
            "count": torch.zeros((), dtype=torch.int32, device=zeros[0].device),
            "mu": tree_rebuild(params, zeros),
            "nu": tree_rebuild(params, [torch.zeros_like(z) for z in zeros]),
        }

    def _adamw_update(self, grads, lr):
        """optax.adamw (b1 0.9, b2 0.999, eps 1e-8) with decay masked off
        ``NO_DECAY``; updates ``self.params`` and ``self.opt_state``."""
        # hyperparameters are float32 scalars, as optax.inject_hyperparams keeps them
        dev = self.opt_state["count"].device
        b1, b2, eps, wd, lr = (torch.tensor(v, dtype=torch.float32, device=dev) for v in
                               (ADAM_B1, ADAM_B2, ADAM_EPS, self.cfg["weight_decay"], lr))
        count = self.opt_state["count"] + 1
        cf = count.to(torch.float32)
        bc1 = 1 - torch.pow(b1, cf)
        bc2 = 1 - torch.pow(b2, cf)
        paths = list(tree_paths(self.params))
        mus = [m for _, m in tree_paths(self.opt_state["mu"])]
        nus = [v for _, v in tree_paths(self.opt_state["nu"])]
        new_p, new_mu, new_nu = [], [], []
        for (path, p), g, mu, nu in zip(paths, grads, mus, nus):
            mu = (1 - b1) * g + b1 * mu
            nu = (1 - b2) * (g * g) + b2 * nu
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            if not any(k in NO_DECAY for k in path):
                u = u + wd * p
            new_p.append(p - lr * u)
            new_mu.append(mu)
            new_nu.append(nu)
        self.params = tree_rebuild(self.params, new_p)
        self.opt_state = {"count": count, "mu": tree_rebuild(self.params, new_mu),
                          "nu": tree_rebuild(self.params, new_nu)}

    # ------------------------------------------------------------------ steps

    def _batch(self, batch):
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}

    def _shard(self, batch):
        """(this rank's rows of the batch, rows): rows is (slice, n) when the
        batch's n rows split evenly over the mesh, else the batch runs whole
        (rows None), as under no mesh."""
        n = batch["idx"].reshape(-1).shape[0]
        if self.mesh is None or n % self.mesh.size:
            return batch, None
        sl = shard_rows(n, self.mesh)
        return {k: v[sl] for k, v in batch.items()}, (sl, n)

    def _all_reduce_grads(self, grads):
        """The ranks' mean of each gradient, in one all-reduce."""
        flat = torch.cat([g.reshape(-1) for g in grads])
        all_reduce_mean(flat, self.mesh)
        return [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]

    @_scoped
    def _train_step(self, batch, lr: float, lr_lat: float):
        idx = batch["idx"].reshape(-1).long()
        with torch.no_grad():
            table = renorm_rows(self.latents, idx, self.max_norm)
        table.requires_grad_(True)
        leaves = [p.detach().requires_grad_(True) for _, p in tree_paths(self.params)]
        params = tree_rebuild(self.params, leaves)
        local, rows = self._shard(batch)
        loss, terms = self._loss(params, table, local, val=False, rows=rows)
        grads = torch.autograd.grad(loss, leaves + [table], allow_unused=True)
        g_params = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        g_table = grads[-1]
        if rows is not None:
            *g_params, g_table = self._all_reduce_grads(g_params + [g_table])
        # the profiler range lets profile_train split optimizer from glue
        with torch.no_grad(), torch.profiler.record_function("optimizer"):
            if self.cfg.get("grad_clip") is not None:
                g_params, _ = clip_global_norm(g_params, self.cfg["grad_clip"])
            if self.cfg.get("grad_clip_lat") is not None:
                (g_table,), _ = clip_global_norm([g_table], self.cfg["grad_clip_lat"])
            self.params = tree_rebuild(self.params, [p.detach() for p in leaves])
            self._adamw_update(g_params, lr)
            self.latents, self.lat_state = row_adam_update(
                table.detach(), g_table, self.lat_state, idx, lr_lat
            )
            terms = {k: v.detach() for k, v in terms.items()}
            terms["loss"] = loss.detach()
            if self.cfg.get("log_grad_norms"):
                terms.update(self._grad_norm_terms(g_params, g_table))
        return terms

    def _grad_norm_terms(self, g_params, g_table):
        """Per-top-level-key gradient L2 norms (the stand-in for the
        reference's ``wandb.watch`` histograms)."""
        sq = {}
        for (path, _), g in zip(tree_paths(self.params), g_params):
            sq[path[0]] = sq.get(path[0], 0.0) + torch.sum(g * g)
        terms = {f"gnorm_{k}": torch.sqrt(v) for k, v in sq.items()}
        terms["gnorm_latents"] = torch.sqrt(torch.sum(g_table * g_table))
        return terms

    @_scoped
    def _val_step(self, batch, lr_lat: float):
        idx = batch["idx"].reshape(-1).long()
        with torch.no_grad():
            table = renorm_rows(self.latents_val, idx, self.max_norm)
        table.requires_grad_(True)
        local, rows = self._shard(batch)
        loss, terms = self._loss(self.params, table, local, val=True, rows=rows)
        (g_table,) = torch.autograd.grad(loss, [table])
        if rows is not None:
            (g_table,) = self._all_reduce_grads([g_table])
        with torch.no_grad():
            if self.cfg.get("grad_clip_lat") is not None:
                (g_table,), _ = clip_global_norm([g_table], self.cfg["grad_clip_lat"])
            self.latents_val, self.lat_state_val = row_adam_update(
                table.detach(), g_table, self.lat_state_val, idx, lr_lat
            )
        terms = {k: v.detach() for k, v in terms.items()}
        terms["loss"] = loss.detach()
        return terms

    # --------------------------------------------------------------- schedule

    def lr_at(self, epoch: int) -> float:
        """Decoder LR under the reference's step decay (training.py:93-99)."""
        interval = self.cfg.get("lr_decay_interval")
        if not interval:
            return self.cfg["lr"]
        return self.cfg["lr"] * self.cfg["lr_decay_factor"] ** (epoch // interval)

    # --------------------------------------------------------------- training

    def train_model(self, epochs: int):
        start = self.load_checkpoint()
        interval = self.cfg["ckpt_interval"]
        for epoch in range(start, epochs):
            t0 = time.time()
            lr = float(np.float32(self.lr_at(epoch)))
            lr_lat = float(np.float32(self.lr_lat_at(epoch)))
            acc = _TermAccumulator()
            for batch in self.train_dataset.batch_iter(seed=epoch):
                batch = self._batch(batch)
                with self._timer.step():
                    terms = self._train_step(batch, lr, lr_lat)
                acc.add(terms)
            if epoch % interval == 0 and self.main:
                self.log_recs(epoch)
            val = self.compute_val_loss(lr_lat)
            if "loss" in val and (self.val_min is None or val["loss"] < self.val_min):
                self.val_min = val["loss"]
                if self.main:
                    ckpt.update_val_min(self.exp_path, epoch, val["loss"])
            if epoch % interval == 0 and self.main:
                self.save_checkpoint(epoch)

            avg = acc.averages(self.mesh)
            barrier(self.mesh)  # the other ranks wait for rank 0's files
            if not self.main:
                continue
            msg = f"Epoch {epoch:5d} ({time.time() - t0:.1f}s)"
            for k in sorted(avg):
                msg += f" {k} {avg[k]:.4f}/{val.get(k, float('nan')):.4f}"
            self.logger.print(msg)
            avg.update({f"val_{k}": v for k, v in val.items()})
            avg.update(self._timer.metrics())
            avg.update({"lr": lr, "lr_lat": lr_lat})
            self.logger.log(avg, step=epoch)

    def compute_val_loss(self, lr_lat: float) -> dict:
        """Optimise validation latents with the decoder frozen
        (reference training.py:250-275)."""
        acc = _TermAccumulator()
        for batch in self.val_dataset.batch_iter(seed=0):
            acc.add(self._val_step(self._batch(batch), lr_lat))
        return acc.averages(self.mesh)

    # ------------------------------------------------------------ persistence

    def state_dict(self) -> dict:
        """The whole training state as plain dicts, lists and numpy arrays."""
        return {
            "params": to_numpy_pytree(self.params),
            "opt_state": to_numpy_pytree(self.opt_state),
            "latents": to_numpy_pytree(self.latents),
            "lat_state": to_numpy_pytree(self.lat_state._asdict()),
            "latents_val": to_numpy_pytree(self.latents_val),
            "lat_state_val": to_numpy_pytree(self.lat_state_val._asdict()),
            "val_min": self.val_min,
            "log_steps": self.log_steps,
        }

    def load_state_dict(self, state: dict):
        def tensors(tree):
            return from_numpy_pytree(tree, self.device)

        def row_state(s):
            return RowAdamState(
                torch.as_tensor(np.array(s["step"]), dtype=torch.int32, device=self.device),
                tensors(s["exp_avg"]), tensors(s["exp_avg_sq"]),
            )

        opt = state["opt_state"]
        if not isinstance(opt, dict):
            raise ValueError(
                "this checkpoint's optimizer state is not the port's (a JAX-written "
                "checkpoint loads its optax states as positional tuples): the port "
                "trainer does not resume from it (ROADMAP, 'Departure on purpose'); "
                "bridge a live JAX state with utils.params.trainer_state_from_jax")
        self.params = tensors(state["params"])
        self.opt_state = {
            "count": torch.as_tensor(np.array(opt["count"]), dtype=torch.int32,
                                     device=self.device),
            "mu": tensors(opt["mu"]),
            "nu": tensors(opt["nu"]),
        }
        self.latents = tensors(state["latents"])
        self.lat_state = row_state(state["lat_state"])
        self.latents_val = tensors(state["latents_val"])
        self.lat_state_val = row_state(state["lat_state_val"])
        self.val_min = state.get("val_min")
        self.log_steps = int(state.get("log_steps", 0))

    def save_checkpoint(self, epoch: int):
        ckpt.save_checkpoint(self.checkpoint_path, epoch, self.state_dict())

    def load_checkpoint(self) -> int:
        """Restore the latest (or ``cfg["ckpt"]``) checkpoint; returns the
        first epoch still to run."""
        data = ckpt.load_checkpoint(self.checkpoint_path, self.cfg.get("ckpt"))
        if data is None:
            if self.main:
                self.logger.print(f"No checkpoints found at {self.checkpoint_path}")
            return 0
        self.load_state_dict(data)
        if self.main:
            self.logger.print(f"Resumed after epoch {data['epoch']}")
        return int(data["epoch"]) + 1


class IdentityTrainer(AutoDecoderTrainer):
    def __init__(self, decoder, params, cfg: dict, train_dataset, val_dataset,
                 exp_name: str, exp_dir: Optional[str] = None,
                 logger: Optional[MetricsLogger] = None, recon_resolution: int = 256,
                 seed: int = 0, device=None, mesh=None):
        self.decoder = decoder
        d = decoder.lat_dim
        super().__init__(params, cfg, train_dataset, val_dataset, exp_name, exp_dir, logger,
                         recon_resolution, seed, device, d, 0.1 / math.sqrt(d), mesh)

        fused = self.cfg.get("fused_train_kernel", "auto")
        if fused == "auto":
            fused = getattr(decoder, "kind", None) == "nphm" and self.device.type == "cuda"
        self._fields_fn = None
        if fused:
            from nphm_tpu_torch.ops.train_fields import apply_nphm_train

            kw = dict(self.cfg.get("fused_train_kernel_kw", {}))
            unknown = set(kw) - {"tile", "cull_eps"}
            if unknown:
                raise ValueError(f"fused_train_kernel_kw: unknown keys {sorted(unknown)}")

            def fields_fn(p, pts, lat):
                return apply_nphm_train(p, decoder.cfg, pts, lat, **kw)

            self._fields_fn = fields_fn

    def _loss(self, params, table, batch, *, val: bool, rows=None):
        idx = batch["idx"].reshape(-1)
        terms = identity_sdf_loss(self.decoder, params, batch, table[idx], training=True,
                                  remat=self.cfg.get("remat", False),
                                  fields_fn=self._fields_fn)
        loss = sum(self.lambdas[k] * terms[k] for k in terms)
        return loss, terms

    def lr_lat_at(self, epoch: int) -> float:
        """Latent LR: decays only at multiples of the interval past epoch
        1000 and holds the last-set value in between (training.py:101-108),
        so interval 600 holds the base LR until epoch 1200."""
        interval = self.cfg.get("lr_decay_interval_lat")
        if not interval:
            return self.cfg["lr_lat"]
        k = epoch // interval
        if k * interval <= 1000:
            return self.cfg["lr_lat"]
        return self.cfg["lr_lat"] * self.cfg["lr_decay_factor_lat"] ** k

    def log_recs(self, epoch: int, n_recs: int = 5):
        """Export reconstruction meshes of a few train/val latents through
        ``extract_mesh`` (K1 on CUDA; reference training.py:282-333)."""
        exp_dir = os.path.join(self.exp_path, "recs", f"epoch_{epoch}")
        os.makedirs(exp_dir, exist_ok=True)
        n = min(n_recs, len(self.val_dataset) // 2 or 1)
        for jj in range(n):
            step_t = (jj + n * self.log_steps) % len(self.train_dataset)
            step_v = (jj + n * self.log_steps) % len(self.val_dataset)
            for tag, table, step in (("train", self.latents, step_t),
                                     ("val", self.latents_val, step_v)):
                mesh = extract_mesh(self.decoder, self.params,
                                    table[step][None].cpu().numpy(), RECON_BOX_MIN,
                                    RECON_BOX_MAX, self.recon_resolution,
                                    device=self.device)
                mesh.export(os.path.join(exp_dir, f"{tag}_{step}.ply"))
        self.log_steps += 1
