"""Latent fitting (counterpart of ``fit_joint``, ``fit_joint_batch`` and
``fit_identity`` in ``nphm_tpu/fitting/inference.py``).

``fit_joint`` jointly optimizes one identity code and per-observation
expression codes against |SDF| at Broyden-found canonical correspondences,
with IFT gradients through the roots, a step-scheduled clamp on |SDF|, and
the reference's lr/lambda division schedules.  ``fit_joint_batch`` fits S
subjects at once: a step folds their S x nb observations into the rows of
one search and one shape-field call, and every subject keeps its own loss
terms, Adam moments and warm store (``fit_joint`` is its S = 1 case).
``fit_identity`` fits the identity code alone, with no search.  Schedules
are precomputed on the host; the step loop is a Python loop over the step
body, with the per-point warm store of roots and inverse Jacobians, the
Adam moments and the history all kept on the device (the history is
pulled once, at the end).

Kernel routing: on a CUDA device the correspondence search runs as K2
(``ops.search``) and the NPHM shape field at the roots as K3/K4
(``ops.fit_fields``) — ``fused_search`` / ``fused_shape_fields`` "auto".
"on" selects the same wrappers everywhere (on the CPU they run the kernels'
plain versions); "off" selects the plain ``fitting.broyden.search`` and
``apply_nphm``.  "auto" skips K2 when its shared memory exceeds the card's
limit (the NPM family's 8x1024 offsets trunk) and for an ``interpolate``
deformation field, whose conditioning is per point (as in the JAX
package); "on" raises for the latter.  The NPM family's shape
field is the plain ``apply_deepsdf`` with autograd, as in the JAX package;
its fit has no anchors.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from nphm_tpu_torch.fitting.broyden import ift_correction, search
from nphm_tpu_torch.models.ensemble import predict_anchors
from nphm_tpu_torch.ops import precision
from nphm_tpu_torch.parallel.mesh import (
    data_parallel,
    device_of,
    gather_rows,
    is_main,
    shard_rows,
)
from nphm_tpu_torch.utils.math import safe_l2norm, sq_norm
from nphm_tpu_torch.utils.params import default_device, tree_to


def default_joint_lambdas() -> Dict[str, float]:
    """Loss weights of the reference fitting script."""
    return {
        "surface": 2.0,
        "reg_expr": 0.01,
        "reg_global": 0.25,
        "reg_unobserved": 10.0,
        "reg_loc": 0.05,
        "symm_dist": 5.0,
    }


def default_joint_schedule() -> Dict[str, Dict[int, float]]:
    """Step-indexed divisors of the reference fitting script."""
    return {
        "lr": {200: 2, 400: 2, 600: 2, 800: 2},
        "symm_dist": {200: 10, 500: 9999},
        "reg_global": {200: 3, 600: 10},
        "reg_loc": {500: 3, 600: 10},
        "reg_expr": {600: 10},
    }


@dataclasses.dataclass(frozen=True)
class FittingConfig:
    n_steps: int = 1000
    step_scale: float = 1.0
    lr: float = 0.01
    lr_scale: float = 1.0
    n_obs_per_batch: int = 5
    n_points_per_obs: int = 1000
    clamp_schedule: Sequence = ((0, 0.1), (250, 0.05), (500, 0.0075))
    unobserved_anchors: Sequence[int] = (30, 31, 39)
    broyden_max_steps: int = 15
    broyden_cvg: float = 1e-6
    broyden_dvg: float = 0.2
    training_mode_shape: bool = True  # the reference fits in train mode
    log_every: int = 50
    seed: int = 0
    # shape field at the roots through K3/K4: "auto" (CUDA), "on", "off";
    # "train" through the full training field K5/K6
    fused_shape_fields: str = "auto"
    # warm-start each search from the point's previous root
    warm_start_corresp: bool = True
    # Broyden budget per step once the store is warm (step > 0)
    broyden_warm_steps: int = 3
    # J^-1 init at I instead of the autograd Jacobian (warm path only)
    warm_identity_jacobian: bool = False
    # carry each point's refined J^-1 across steps in the warm store
    warm_jacobian_store: bool = True
    # stop a search once at most this fraction of points is active
    broyden_frac_exit: float = 0.0
    # IFT inverse Jacobian: "broyden" (the search's secant) or "exact"
    ift_jacobian: str = "broyden"
    # correspondence search through K2: "auto" (CUDA), "on", "off"
    fused_search: str = "auto"
    # matmul precision of each step's loss and gradient (JAX's names,
    # ops/precision.py): "default" is fp32, as the reference's torch
    # matmuls; "high" rounds every product's operands to TF32, "bfloat16"
    # to bf16 (the models' products, the plain search, K3/K4; K2 stays
    # 3xTF32, as the JAX package's K2 forces HIGHEST)
    matmul_precision: str = "default"

    def __post_init__(self):
        precision.resolve(self.matmul_precision)

    @property
    def total_steps(self) -> int:
        return int(self.n_steps * self.step_scale)


def _scheduled_array(base: float, events: Dict[int, float], total: int,
                     step_scale: float) -> np.ndarray:
    """Value per step under the reference's cumulative-division semantics."""
    out = np.zeros(total, np.float32)
    cur = base
    for j in range(total):
        if int(j / step_scale) in events:
            cur = cur / events[int(j / step_scale)]
        out[j] = cur
    return out


def _clamp_array(schedule, total: int, step_scale: float) -> np.ndarray:
    """|sdf| clamp per step: the base threshold always, tighter ones strictly
    after their step."""
    out = np.zeros(total, np.float32)
    for j in range(total):
        thresh = None
        for after, value in schedule:
            if after == 0 or j > int(after * step_scale):
                thresh = value
        out[j] = thresh
    return out


def _pad_subjects(subjects_obs: List[List[np.ndarray]], pad_obs_to: int = 0,
                  pad_points_to: int = 0, pad_subjects_to: int = 0):
    """Ragged clouds of S subjects -> (padded [S_pad, o_max, p_max, 3],
    lens [S_pad, o_max], n_obs [S_pad]) numpy, as the JAX package pads them:
    o_max to a multiple of 8 observations, p_max to a multiple of 512
    points, each at least its ``pad_*_to``; dummy subjects (up to
    ``pad_subjects_to``) hold one one-point observation at the origin."""
    S = len(subjects_obs)
    S_pad = max(S, pad_subjects_to)
    n_obs = np.ones(S_pad, np.int64)
    n_obs[:S] = [len(o) for o in subjects_obs]
    o_max = -(-max(int(n_obs.max()), pad_obs_to) // 8) * 8
    p_max = -(-max(max(len(o) for obs in subjects_obs for o in obs), pad_points_to)
              // 512) * 512
    padded = np.zeros((S_pad, o_max, p_max, 3), np.float32)
    lens = np.ones((S_pad, o_max), np.int64)
    for s_i, obs in enumerate(subjects_obs):
        for i, o in enumerate(obs):
            o = np.asarray(o, np.float32)[:, :3]
            padded[s_i, i, : len(o)] = o
            lens[s_i, i] = len(o)
    return padded, lens, n_obs


def _masked_mean(values, mask):
    """Mean of values over mask along the last axis."""
    return torch.sum(values * mask, dim=-1) / torch.clamp(torch.sum(mask, dim=-1), min=1.0)


_JOINT_HIST_KEYS = (
    "loss", "n_valid", "reg_expr", "reg_global", "reg_loc",
    "reg_unobserved", "surface", "symm_dist", "broyden_iters",
)
_ID_HIST_KEYS = (
    "loss", "reg_global", "reg_loc", "reg_unobserved", "surface",
    "symm_dist",
)


def _shape_regularizers(decoder, lat_shape, unobserved):
    """Latent regularizers for the ensemble decoder's structured code; a
    global code (the NPM family) has only ``reg_global``.

    lat_shape: [S, D], the codes of S subjects; every term is of shape [S].
    """
    if decoder.lat_dim_glob is None:
        reg = sq_norm(lat_shape)
        zero = torch.zeros_like(reg)
        return {"reg_loc": zero, "reg_global": reg, "reg_unobserved": zero,
                "symm_dist": zero}
    g, l = decoder.lat_dim_glob, decoder.lat_dim_loc
    terms = {
        "reg_loc": sq_norm(lat_shape[..., g:]),
        "reg_global": sq_norm(lat_shape[..., :g]),
    }
    reg_unobserved = 0.0
    for idx in unobserved:
        reg_unobserved = reg_unobserved + sq_norm(
            lat_shape[..., g + idx * l : g + (idx + 1) * l])
    terms["reg_unobserved"] = reg_unobserved
    n_symm = decoder.n_symm_pairs
    loc = lat_shape[..., g : g + 2 * n_symm * l].reshape(
        lat_shape.shape[:-1] + (2 * n_symm, l)
    )
    terms["symm_dist"] = torch.mean(
        safe_l2norm(loc[..., ::2, :] - loc[..., 1::2, :]), dim=-1
    )
    return terms


def _shape_fields_fn(decoder_shape, cfg: FittingConfig, device):
    """None, or the K3/K4 SDF evaluator ``fields(params, pts, lat) -> sdf``.

    Training-mode semantics, loss-specialised (first-order gradient w.r.t.
    lat and points only; valid because the decoder is frozen), Morton-sorted
    points with per-tile member culling at 1e-10.  ``"train"`` selects the
    full training field (K5/K6, ~8x the work; kept for A/B like the JAX
    package's).
    """
    mode = cfg.fused_shape_fields
    is_nphm = getattr(decoder_shape, "kind", None) == "nphm"
    use = device.type == "cuda" if mode == "auto" else bool(mode) and mode != "off"
    if not (use and is_nphm):
        return None
    if mode == "train":
        from nphm_tpu_torch.ops.train_fields import apply_nphm_train

        def fields(params_shape, pts, lat_b):
            sdf, _grads, _anchors = apply_nphm_train(
                params_shape, decoder_shape.cfg, pts, lat_b, cull_eps=1e-10, sort=True
            )
            return sdf

        return fields
    from nphm_tpu_torch.ops.fit_fields import apply_nphm_fit

    def fields(params_shape, pts, lat_b):
        sdf, _anchors = apply_nphm_fit(
            params_shape, decoder_shape.cfg, pts, lat_b, cull_eps=1e-10, sort=True
        )
        return sdf

    return fields


def _use_fused_search(decoder_expr, cfg: FittingConfig, device) -> bool:
    """Gate for K2: warm path with an explicit J^-1 init, exact any(active)
    exit semantics, and a kernel-eligible deformation trunk.  "auto" also
    needs the kernel's shared memory to fit one block (decided from the
    trunk's shape, before any launch) and skips a trunk K2 cannot run (an
    ``interpolate`` field's per-point conditioning); "on" raises for one."""
    mode = cfg.fused_search
    if mode == "off" or not mode:
        return False
    if not cfg.warm_start_corresp or cfg.broyden_frac_exit > 0:
        return False
    if not (cfg.warm_jacobian_store or cfg.warm_identity_jacobian):
        return False
    from nphm_tpu_torch.ops.search import search_fits, search_fusable

    if not search_fusable(decoder_expr):
        if mode == "on":
            raise ValueError("fused_search='on', but K2 cannot run this expression "
                             "decoder's trunk (an interpolate field conditions per point)")
        return False
    if mode == "auto":
        return device.type == "cuda" and search_fits(decoder_expr)
    return True


def _make_joint_loss(decoder_shape, decoder_expr, cfg: FittingConfig, lam_keys,
                     fused_fields, fused_search: bool):
    """The joint-fit loss body of S subjects folded into one batch of rows:
    anchors -> Broyden search -> IFT correction -> clamped |sdf| +
    regularizers.  Returns ``loss_fn(...) -> (loss, aux)``: ``loss`` is the
    sum of the subjects' losses, so each subject's gradient is its own (the
    JAX package's ``vmap``); every term in ``aux`` is per subject, [S].
    """
    warm = cfg.warm_start_corresp
    use_anchors = decoder_shape.lat_dim_glob is not None

    def loss_fn(lat_s, lat_e, params_shape, params_expr, points, lam_row,
                clamp_j, obs_row, pt, xc0, jinv0, broyden_steps):
        """lat_s [S, D]; lat_e [S * O, E] and points [S * O * P, 3], the
        expression codes and padded observations flattened; obs_row [S,
        nb], the drawn observations' rows of ``lat_e``; pt [S, nb, npp],
        their points' rows of ``points``; xc0 / jinv0 [S * nb * npp, 3
        (, 3)] or None.  The S * nb rows of npp points run through one
        search and one shape-field call."""
        S, nb = obs_row.shape
        npp = pt.shape[-1]
        rows = S * nb
        obs = points.index_select(0, pt.reshape(-1)).reshape(rows, npp, 3)
        lat_e_sel = lat_e[obs_row]

        def per_row(t):  # [S, ...] -> [S * nb, ...], each subject's nb rows
            if S == 1:  # one subject: a plain broadcast, fewer ops on the host
                return t.expand((nb,) + t.shape[1:])
            return t[:, None].expand((S, nb) + t.shape[1:]).reshape((rows,) + t.shape[1:])

        lat_b = per_row(lat_s)
        cond = torch.cat([lat_b, lat_e_sel.reshape(rows, -1)], dim=-1)
        anchors_b = None
        if use_anchors:
            anchors_b = per_row(predict_anchors(params_shape, decoder_shape.cfg, lat_s))
        if xc0 is not None:
            xc0 = xc0.reshape(rows, npp, 3)
        if jinv0 is not None:
            jinv0 = jinv0.reshape(rows, npp, 3, 3)
        if fused_search:
            from nphm_tpu_torch.ops.search import search_fused

            jinv_k = (
                torch.eye(3, device=obs.device).expand(obs.shape[:-1] + (3, 3))
                if jinv0 is None
                else jinv0
            )
            xc_opt, result = search_fused(
                decoder_expr, params_expr, obs, cond.detach(),
                None if anchors_b is None else anchors_b.detach(),
                max_steps=broyden_steps, cvg_thresh=cfg.broyden_cvg,
                dvg_thresh=cfg.broyden_dvg,
                xc_init=obs if xc0 is None else xc0, j_inv_init=jinv_k, groups=S,
            )
        else:
            xc_opt, result = search(
                decoder_expr, params_expr, obs, cond, anchors_b,
                max_steps=broyden_steps, cvg_thresh=cfg.broyden_cvg,
                dvg_thresh=cfg.broyden_dvg, xc_init=xc0,
                identity_j_init=warm and cfg.warm_identity_jacobian,
                j_inv_init=jinv0, frac_exit=cfg.broyden_frac_exit, groups=S,
            )
        xc = ift_correction(
            decoder_expr, params_expr, xc_opt, cond, anchors_b,
            j_inv=result["j_inv"] if cfg.ift_jacobian == "broyden" else None,
        )
        if fused_fields is not None:
            sdf = fused_fields(params_shape, xc, lat_b)
        else:
            sdf, _ = decoder_shape.apply(
                params_shape, xc, lat_b, training=cfg.training_mode_shape
            )
        l = torch.abs(sdf[..., 0]).reshape(S, -1)
        valid = result["valid_ids"].reshape(S, -1)
        mask = (valid & (l < clamp_j)).to(l.dtype)
        terms = {"surface": _masked_mean(l, mask)}
        terms["reg_expr"] = torch.mean(sq_norm(lat_e_sel), dim=-1)
        terms.update(_shape_regularizers(decoder_shape, lat_s, cfg.unobserved_anchors))
        loss = 0.0
        for i, k in enumerate(lam_keys):
            loss = loss + lam_row[i] * terms[k]
        aux = dict(terms)
        aux["loss"] = loss
        aux["n_valid"] = torch.sum(valid.to(torch.float32), dim=-1)
        aux["broyden_iters"] = result["group_iters"].to(torch.float32).to(obs.device)
        aux["xc_opt"] = xc_opt  # [S * nb, npp, 3 (, 3)], the search's rows
        aux["j_inv"] = result["j_inv"]
        return loss.sum(), aux

    return loss_fn


class _Adam:
    """optax.scale_by_adam followed by ``p - lr * u`` (b1 0.9, b2 0.999,
    eps 1e-8), updating the parameter tensor in place."""

    def __init__(self, p, b1=0.9, b2=0.999, eps=1e-8):
        self.mu = torch.zeros_like(p)
        self.nu = torch.zeros_like(p)
        self.count = 0
        self.b1, self.b2, self.eps = b1, b2, eps

    def step(self, p, g, lr):
        self.count += 1
        self.mu.mul_(self.b1).add_((1 - self.b1) * g)
        self.nu.mul_(self.b2).add_((1 - self.b2) * g * g)
        mu_hat = self.mu / (1 - self.b1**self.count)
        nu_hat = self.nu / (1 - self.b2**self.count)
        p.sub_(lr * (mu_hat / (torch.sqrt(nu_hat) + self.eps)))


def _schedules(lambdas, schedule, cfg: FittingConfig, device):
    """(lam_keys, lr per step numpy, lambdas [K, T] and clamp [T] on device)."""
    total = cfg.total_steps
    lam_keys = tuple(sorted(lambdas))
    lr_arr = _scheduled_array(cfg.lr * cfg.lr_scale, schedule.get("lr", {}), total,
                              cfg.step_scale)
    lam_mat = np.stack([_scheduled_array(lambdas[k], schedule.get(k, {}), total,
                                         cfg.step_scale) for k in lam_keys])
    clamp_arr = _clamp_array(cfg.clamp_schedule, total, cfg.step_scale)
    return (lam_keys, lr_arr, torch.as_tensor(lam_mat, device=device),
            torch.as_tensor(clamp_arr, device=device))


class _StepClock:
    """Wall time of a step loop: total, first step, and steps per second
    after the first (the device synchronised at both marks)."""

    def __init__(self, device):
        self.device = device
        self.start = time.perf_counter()
        self.first = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step_done(self, j: int):
        if j == 0:
            self._sync()
            self.first = time.perf_counter()

    def finish(self, total: int) -> dict:
        self._sync()
        end = time.perf_counter()
        first = self.first or end
        steady = (total - 1) / (end - first) if total > 1 and end > first else float("nan")
        return {"elapsed_s": end - self.start, "first_step_s": first - self.start,
                "steady_it_s": steady}


def fit_joint(
    decoder_shape,
    params_shape,
    decoder_expr,
    params_expr,
    all_obs: List[np.ndarray],
    lambdas: Optional[Dict[str, float]] = None,
    schedule: Optional[Dict[str, Dict[int, float]]] = None,
    cfg: FittingConfig = FittingConfig(),
    lat_expr_init: Optional[np.ndarray] = None,
    lat_shape_init: Optional[np.ndarray] = None,
    verbose: bool = True,
    device=None,
    sample_draws=None,
):
    """Joint identity + expression fitting with Broyden correspondences: the
    one-subject case of ``fit_joint_batch``.

    Returns (lat_expr [n_obs, E], lat_shape [1, D], anchors (None for the
    NPM family), history dict) as numpy.  The parameters move to ``device``
    first (default ``default_device()``).
    ``sample_draws``: optional (sel [T, nb], idx [T, nb, npp]) integer
    arrays replacing the per-step random draws (seeded from ``cfg.seed``).
    The history holds one entry per step for each term, plus
    ``elapsed_s``, ``first_step_s`` and ``steady_it_s`` (steps after the
    first over their wall time).
    """
    le, ls, anchors, hist = fit_joint_batch(
        decoder_shape, params_shape, decoder_expr, params_expr, [all_obs], lambdas,
        schedule, cfg, verbose=False, device=device,
        sample_draws=None if sample_draws is None else tuple(
            np.asarray(a)[:, None] for a in sample_draws),
        lat_shape_init=None if lat_shape_init is None else [lat_shape_init],
        lat_expr_init=None if lat_expr_init is None else [lat_expr_init],
    )
    total = cfg.total_steps
    history = {k: hist[k][:, 0] for k in _JOINT_HIST_KEYS}
    history.update(elapsed_s=hist["elapsed_s"], first_step_s=hist["first_step_s"],
                   steady_it_s=hist["steady_subject_steps_s"])
    if verbose:
        for j in range(0, total, max(1, cfg.log_every)):
            msg = f"Step {j:5d} " + " ".join(
                f"{k} {history[k][j]:02.6f}" for k in sorted(history)
                if k not in ("n_valid", "elapsed_s", "first_step_s", "steady_it_s")
            )
            print(msg, int(history["n_valid"][j]))
        print(f"[fit_joint] {total} steps in {history['elapsed_s']:.1f}s "
              f"({history['steady_it_s']:.1f} it/s after the first step)")
    return le[0], ls[0], anchors[0], history


def fit_joint_batch(
    decoder_shape,
    params_shape,
    decoder_expr,
    params_expr,
    subjects_obs: List[List[np.ndarray]],
    lambdas: Optional[Dict[str, float]] = None,
    schedule: Optional[Dict[str, Dict[int, float]]] = None,
    cfg: FittingConfig = FittingConfig(),
    verbose: bool = True,
    pad_obs_to: int = 0,
    pad_points_to: int = 0,
    pad_subjects_to: int = 0,
    device=None,
    sample_draws=None,
    lat_shape_init: Optional[List[np.ndarray]] = None,
    lat_expr_init: Optional[List[np.ndarray]] = None,
    mesh=None,
):
    """Fit many subjects at once: each step folds the S subjects' nb
    observations into S * nb rows of one search (K2, a subject's lanes
    padded to whole tiles) and one shape-field call (K3/K4).  Every subject
    keeps its own loss, Adam moments and warm store, so its trajectory is
    that of ``fit_joint`` on the same draws.

    subjects_obs: one observation list per subject (ragged sizes fine).
    ``pad_obs_to`` / ``pad_points_to`` / ``pad_subjects_to``: lower bounds
    on the padded observation, point and subject axes (a caller fitting
    several groups passes its global maxima, as the JAX package's CLI
    does); dummy subjects are dropped from the results.
    ``sample_draws``: optional (sel [T, S, nb], idx [T, S, nb, npp]); dummy
    subjects draw zeros.  ``lat_shape_init`` (one [D] a subject) and
    ``lat_expr_init`` (one [n_obs_s, E] a subject): optional starting codes
    (default zero).  Returns per-subject lists (lat_exprs [n_obs_s, E],
    lat_shapes [1, D], anchors [1, K, 3] or None) and a history: each term
    [T, S] (``loss``, ``broyden_iters``, ...), ``elapsed_s``,
    ``first_step_s`` and ``steady_subject_steps_s`` (subject-steps after
    the first step over their wall time).

    ``mesh`` (a ``parallel.DataMesh`` of W > 1 ranks): the subject axis is
    padded with dummy subjects to a multiple of W and rank r fits its
    contiguous block through its own K2 launch and K3/K4 calls.  Every
    rank makes the one-device call's draws and keeps its subjects' rows,
    so a subject draws the same points at every W (its trajectory differs
    only by rounding: the ranks' launches sum in another order); no
    collective runs in the step loop.  The codes and the history are gathered at the end, so
    every rank returns what the one-device call returns (the timings are
    the rank's own).
    """
    device = device_of(device, mesh)
    mesh = data_parallel(mesh)
    params_shape = tree_to(params_shape, device)
    params_expr = tree_to(params_expr, device)
    lam_keys, lr_arr, lam_mat, clamp_arr = _schedules(
        dict(lambdas or default_joint_lambdas()), schedule or default_joint_schedule(),
        cfg, device)
    total = cfg.total_steps
    nb, npp = cfg.n_obs_per_batch, cfg.n_points_per_obs
    S = len(subjects_obs)
    S_draw = max(S, pad_subjects_to)  # the one-device call's subjects: its draws
    W = 1 if mesh is None else mesh.size
    padded_np, lens_np, n_obs_np = _pad_subjects(subjects_obs, pad_obs_to, pad_points_to,
                                                 -(-S_draw // W) * W)
    S_pad, o_max = padded_np.shape[:2]
    own = shard_rows(S_pad, mesh)  # this rank's subjects
    S_loc = own.stop - own.start
    padded = torch.as_tensor(padded_np[own], device=device)
    # the draws' bounds: observations a subject has (as float), and its last
    n_obs = torch.as_tensor(n_obs_np[:S_draw], device=device)[:, None]
    n_obs_f, n_obs_last = n_obs.to(torch.float32), n_obs - 1
    lens = torch.as_tensor(lens_np[:S_draw], device=device)
    subj_row = torch.arange(S_loc, device=device)[:, None] * o_max
    points = padded.reshape(-1, 3)
    p_max = padded.shape[2]

    # the expression codes of this rank's subjects' (padded) observations,
    # flattened
    lat_expr = torch.zeros((S_pad * o_max, decoder_expr.lat_dim), device=device)
    lat_shape = torch.zeros((S_pad, decoder_shape.lat_dim), device=device)
    for s, init in enumerate(() if lat_shape_init is None else lat_shape_init):
        lat_shape[s] = torch.as_tensor(np.asarray(init, np.float32).reshape(-1))
    for s, init in enumerate(() if lat_expr_init is None else lat_expr_init):
        lat_expr[s * o_max : s * o_max + n_obs_np[s]] = torch.as_tensor(
            np.asarray(init, np.float32).reshape(n_obs_np[s], -1))
    lat_expr = lat_expr[own.start * o_max : own.stop * o_max].clone()
    lat_shape = lat_shape[own].clone()
    opt_s, opt_e = _Adam(lat_shape), _Adam(lat_expr)

    warm = cfg.warm_start_corresp
    warm_j = warm and cfg.warm_jacobian_store
    store = padded.clone() if warm else None
    store_j = (
        torch.eye(3, device=device).expand(padded.shape[:3] + (3, 3)).contiguous()
        if warm_j
        else None
    )
    loss_fn = _make_joint_loss(
        decoder_shape, decoder_expr, cfg, lam_keys,
        _shape_fields_fn(decoder_shape, cfg, device),
        _use_fused_search(decoder_expr, cfg, device),
    )
    if sample_draws is not None:
        # dummy subjects past S draw zeros
        draws = [torch.zeros((total, S_pad) + np.shape(a)[2:], dtype=torch.int64,
                             device=device) for a in sample_draws]
        for d, a in zip(draws, sample_draws):
            d[:, :S] = torch.as_tensor(np.asarray(a), dtype=torch.int64)
        draws = [d[:, own] for d in draws]
    else:
        gen = torch.Generator(device=device).manual_seed(cfg.seed)

        def draw():
            """The one-device call's draws (sel [S_draw, nb], idx [S_draw, nb,
            npp]) and this rank's rows of them; dummy subjects draw zeros."""
            u = torch.rand((S_draw, nb), generator=gen, device=device)
            sel = torch.minimum((u * n_obs_f).to(torch.int64), n_obs_last)
            n_pts = lens.gather(1, sel)[..., None]
            u = torch.rand((S_draw, nb, npp), generator=gen, device=device)
            idx = torch.minimum((u * n_pts).to(torch.int64), n_pts - 1)
            if mesh is None:
                return sel, idx
            return tuple(torch.cat([t, t.new_zeros((S_pad - S_draw,) + t.shape[1:])])[own]
                         for t in (sel, idx))
    hist = torch.zeros((total, len(_JOINT_HIST_KEYS), S_loc), device=device)

    clock = _StepClock(device)
    for j in range(total):
        # obs_row: the drawn observations' rows of the flattened [S_loc *
        # o_max] observations; pt: their points' rows of the flattened
        # [S_loc * o_max * p_max] points and warm stores (one index, not three)
        if sample_draws is not None:
            sel, idx = draws[0][j], draws[1][j]
        else:
            sel, idx = draw()
        obs_row = subj_row + sel
        pt = obs_row[..., None] * p_max + idx
        at = pt.reshape(-1)
        xc0 = store.view(-1, 3).index_select(0, at) if warm else None
        bsteps = cfg.broyden_warm_steps if warm and j > 0 else cfg.broyden_max_steps
        jinv0 = store_j.view(-1, 3, 3).index_select(0, at) if warm_j else None

        lat_s = lat_shape.detach().requires_grad_(True)
        lat_e = lat_expr.detach().requires_grad_(True)
        with precision.matmul_precision(cfg.matmul_precision):
            loss, aux = loss_fn(lat_s, lat_e, params_shape, params_expr, points,
                                lam_mat[:, j], clamp_arr[j], obs_row, pt, xc0, jinv0,
                                bsteps)
            g_s, g_e = torch.autograd.grad(loss, (lat_s, lat_e))
        if warm:
            store.view(-1, 3).index_copy_(0, at, aux["xc_opt"].reshape(-1, 3))
        if warm_j:
            store_j.view(-1, 3, 3).index_copy_(0, at, aux["j_inv"].reshape(-1, 3, 3))
        opt_s.step(lat_shape, g_s, float(lr_arr[j]))
        opt_e.step(lat_expr, g_e, float(lr_arr[j]))
        with torch.no_grad():
            hist[j] = torch.stack([torch.as_tensor(aux[k], device=device).expand(S_loc)
                                   for k in _JOINT_HIST_KEYS])
        clock.step_done(j)
    timing = clock.finish(total)
    if mesh is not None:
        lat_shape = gather_rows(lat_shape, S_pad, mesh)
        lat_expr = gather_rows(lat_expr, S_pad * o_max, mesh, granule=o_max)
        hist = gather_rows(hist, S_pad, mesh, dim=2)

    hist_np = hist.cpu().numpy()
    history = {k: hist_np[:, i, :S] for i, k in enumerate(_JOINT_HIST_KEYS)}
    history.update(elapsed_s=timing["elapsed_s"], first_step_s=timing["first_step_s"],
                   steady_subject_steps_s=timing["steady_it_s"] * S)
    if verbose and is_main(mesh):
        print(f"[fit_joint_batch] {S} subjects x {total} steps in "
              f"{timing['elapsed_s']:.1f}s ({history['steady_subject_steps_s']:.1f} "
              f"subject-steps/s after the first step, mean Broyden iters "
              f"{float(history['broyden_iters'].mean()):.2f})")
    anchors_list = [None] * S
    if decoder_shape.lat_dim_glob is not None:
        with torch.no_grad():
            anchors = predict_anchors(params_shape, decoder_shape.cfg,
                                      lat_shape[:S]).cpu().numpy()
        anchors_list = [anchors[s : s + 1] for s in range(S)]
    lat_expr_np = lat_expr.cpu().numpy().reshape(S_pad, o_max, -1)
    lat_shape_np = lat_shape.cpu().numpy()
    lat_exprs = [lat_expr_np[s, : n_obs_np[s]] for s in range(S)]
    lat_shapes = [lat_shape_np[s : s + 1] for s in range(S)]
    return lat_exprs, lat_shapes, anchors_list, history


def default_identity_lambdas() -> Dict[str, float]:
    """Loss weights of the identity-only fit (the JAX package's defaults)."""
    return {
        "surface": 2.0,
        "reg_global": 0.25,
        "reg_unobserved": 10.0,
        "reg_loc": 0.05,
        "symm_dist": 5.0,
    }


def fit_identity(
    decoder_shape,
    params_shape,
    all_obs: List[np.ndarray],
    lambdas: Optional[Dict[str, float]] = None,
    schedule: Optional[Dict[str, Dict[int, float]]] = None,
    cfg: FittingConfig = FittingConfig(),
    lat_shape_init: Optional[np.ndarray] = None,
    verbose: bool = True,
    device=None,
    sample_draws=None,
):
    """Identity-space-only fitting (counterpart of the JAX package's
    ``fit_identity``): clamped |sdf| at the observed points, no search.  On
    a CUDA device the NPHM shape field runs through K3/K4
    (``fused_shape_fields``).

    ``sample_draws``: optional (sel [T, nb], idx [T, nb, npp]).  Returns
    (lat_shape [1, D], anchors (None for the NPM family), history): each
    term of ``_ID_HIST_KEYS`` per step, plus ``elapsed_s``,
    ``first_step_s`` and ``steady_it_s``.
    """
    device = default_device() if device is None else torch.device(device)
    params_shape = tree_to(params_shape, device)
    lam_keys, lr_arr, lam_mat, clamp_arr = _schedules(
        dict(lambdas or default_identity_lambdas()), schedule or default_joint_schedule(),
        cfg, device)
    total = cfg.total_steps
    nb, npp = cfg.n_obs_per_batch, cfg.n_points_per_obs
    padded_np, lens_np, _ = _pad_subjects([all_obs])
    padded = torch.as_tensor(padded_np[0], device=device)
    lens = torch.as_tensor(lens_np[0], device=device)
    n_obs = len(all_obs)
    lat_shape = torch.zeros((1, decoder_shape.lat_dim), device=device)
    if lat_shape_init is not None:
        lat_shape[0] = torch.as_tensor(np.asarray(lat_shape_init, np.float32).reshape(-1))
    opt = _Adam(lat_shape)
    fields = _shape_fields_fn(decoder_shape, cfg, device)
    if sample_draws is not None:
        draws_sel, draws_idx = (torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                                device=device) for a in sample_draws)
    else:
        gen = torch.Generator(device=device).manual_seed(cfg.seed)
    hist = torch.zeros((total, len(_ID_HIST_KEYS)), device=device)

    clock = _StepClock(device)
    for j in range(total):
        if sample_draws is not None:
            sel, idx = draws_sel[j], draws_idx[j]
        else:
            sel = torch.randint(0, n_obs, (nb,), generator=gen, device=device)
            u = torch.rand((nb, npp), generator=gen, device=device)
            idx = torch.minimum((u * lens[sel][:, None]).to(torch.int64),
                                lens[sel][:, None] - 1)
        obs = padded[sel[:, None], idx]
        lat_s = lat_shape.detach().requires_grad_(True)
        lat_b = lat_s.expand(nb, -1)
        with precision.matmul_precision(cfg.matmul_precision):
            if fields is not None:
                sdf = fields(params_shape, obs, lat_b)
            else:
                sdf, _ = decoder_shape.apply(params_shape, obs, lat_b,
                                             training=cfg.training_mode_shape)
            l = torch.abs(sdf[..., 0]).reshape(-1)
            terms = {"surface": _masked_mean(l, (l < clamp_arr[j]).to(l.dtype))}
            terms.update({k: v[0] for k, v in _shape_regularizers(
                decoder_shape, lat_s, cfg.unobserved_anchors).items()})
            loss = 0.0
            for i, k in enumerate(lam_keys):
                loss = loss + lam_mat[i, j] * terms[k]
            (g,) = torch.autograd.grad(loss, (lat_s,))
        opt.step(lat_shape, g, float(lr_arr[j]))
        terms["loss"] = loss
        hist[j] = torch.stack([torch.as_tensor(terms[k], device=device).detach().reshape(())
                               for k in _ID_HIST_KEYS])
        clock.step_done(j)
    timing = clock.finish(total)
    hist_np = hist.cpu().numpy()
    history = {k: hist_np[:, i] for i, k in enumerate(_ID_HIST_KEYS)}
    history.update(timing)
    if verbose:
        print(f"[fit_identity] {total} steps in {history['elapsed_s']:.1f}s "
              f"({history['steady_it_s']:.1f} it/s after the first step), "
              f"final loss {history['loss'][-1]:.6f}")
    anchors = None
    if decoder_shape.lat_dim_glob is not None:
        with torch.no_grad():
            anchors = predict_anchors(params_shape, decoder_shape.cfg,
                                      lat_shape).cpu().numpy()
    return lat_shape.cpu().numpy(), anchors, history
