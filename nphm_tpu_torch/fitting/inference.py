"""Joint latent fitting (counterpart of ``fit_joint`` in
``nphm_tpu/fitting/inference.py``).

Jointly optimizes one identity code and per-observation expression codes
against |SDF| at Broyden-found canonical correspondences, with IFT gradients
through the roots, a step-scheduled clamp on |SDF|, and the reference's
lr/lambda division schedules.  Schedules are precomputed on the host; the
step loop is a Python loop over the step body, with the per-point warm
store of roots and inverse Jacobians, the Adam moments and the history all
kept on the device (the history is pulled once, at the end).

Kernel routing: on a CUDA device the correspondence search runs as K2
(``ops.search``) and the NPHM shape field at the roots as K3/K4
(``ops.fit_fields``) — ``fused_search`` / ``fused_shape_fields`` "auto".
"on" selects the same wrappers everywhere (on the CPU they run the kernels'
plain versions); "off" selects the plain ``fitting.broyden.search`` and
``apply_nphm``.  "auto" skips K2 when its shared memory exceeds the card's
limit (the NPM family's 8x1024 offsets trunk).  The NPM family's shape
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


def _pad_observations(all_obs: List[np.ndarray]):
    """Ragged clouds -> (padded [n_obs, max_n, 3], lens [n_obs]) numpy."""
    lens = np.asarray([len(o) for o in all_obs], np.int64)
    padded = np.zeros((len(all_obs), int(lens.max()), 3), np.float32)
    for i, o in enumerate(all_obs):
        padded[i, : len(o)] = np.asarray(o, np.float32)[:, :3]
    return padded, lens


def _masked_mean(values, mask):
    return torch.sum(values * mask) / torch.clamp(torch.sum(mask), min=1.0)


_JOINT_HIST_KEYS = (
    "loss", "n_valid", "reg_expr", "reg_global", "reg_loc",
    "reg_unobserved", "surface", "symm_dist", "broyden_iters",
)


def _shape_regularizers(decoder, lat_shape, unobserved):
    """Latent regularizers for the ensemble decoder's structured code; a
    global code (the NPM family) has only ``reg_global``."""
    if decoder.lat_dim_glob is None:
        zero = torch.zeros((), device=lat_shape.device)
        return {"reg_loc": zero, "reg_global": torch.mean(sq_norm(lat_shape)),
                "reg_unobserved": zero, "symm_dist": zero}
    g, l = decoder.lat_dim_glob, decoder.lat_dim_loc
    terms = {
        "reg_loc": torch.mean(sq_norm(lat_shape[..., g:])),
        "reg_global": torch.mean(sq_norm(lat_shape[..., :g])),
    }
    reg_unobserved = 0.0
    for idx in unobserved:
        sl = lat_shape[..., g + idx * l : g + (idx + 1) * l]
        reg_unobserved = reg_unobserved + torch.mean(sq_norm(sl))
    terms["reg_unobserved"] = reg_unobserved
    n_symm = decoder.n_symm_pairs
    loc = lat_shape[..., g : g + 2 * n_symm * l].reshape(
        lat_shape.shape[0], 2 * n_symm, l
    )
    terms["symm_dist"] = torch.mean(safe_l2norm(loc[:, ::2] - loc[:, 1::2]))
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
    trunk's shape, before any launch)."""
    mode = cfg.fused_search
    if mode == "off" or not mode:
        return False
    if not cfg.warm_start_corresp or cfg.broyden_frac_exit > 0:
        return False
    if not (cfg.warm_jacobian_store or cfg.warm_identity_jacobian):
        return False
    from nphm_tpu_torch.ops.search import search_fits, search_fusable

    if not search_fusable(decoder_expr):
        return False
    if mode == "auto":
        return device.type == "cuda" and search_fits(decoder_expr)
    return True


def _make_joint_loss(decoder_shape, decoder_expr, cfg: FittingConfig, lam_keys,
                     fused_fields, fused_search: bool):
    """The joint-fit loss body: anchors -> Broyden search -> IFT correction
    -> clamped |sdf| + regularizers.  Returns ``loss_fn(...) -> (loss, aux)``.
    """
    nb = cfg.n_obs_per_batch
    warm = cfg.warm_start_corresp
    use_anchors = decoder_shape.lat_dim_glob is not None

    def loss_fn(lat_s, lat_e, params_shape, params_expr, padded, lam_row,
                clamp_j, sel, idx, xc0, jinv0, broyden_steps):
        obs = padded[sel[:, None], idx]
        cond = torch.cat([lat_s.expand(nb, -1), lat_e[sel]], dim=-1)
        anchors_b = None
        if use_anchors:
            anchors = predict_anchors(params_shape, decoder_shape.cfg, lat_s)
            anchors_b = anchors.expand((nb,) + anchors.shape[1:])
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
                xc_init=obs if xc0 is None else xc0, j_inv_init=jinv_k,
            )
        else:
            xc_opt, result = search(
                decoder_expr, params_expr, obs, cond, anchors_b,
                max_steps=broyden_steps, cvg_thresh=cfg.broyden_cvg,
                dvg_thresh=cfg.broyden_dvg, xc_init=xc0,
                identity_j_init=warm and cfg.warm_identity_jacobian,
                j_inv_init=jinv0, frac_exit=cfg.broyden_frac_exit,
            )
        xc = ift_correction(
            decoder_expr, params_expr, xc_opt, cond, anchors_b,
            j_inv=result["j_inv"] if cfg.ift_jacobian == "broyden" else None,
        )
        lat_b = lat_s.expand(nb, -1)
        if fused_fields is not None:
            sdf = fused_fields(params_shape, xc, lat_b)
        else:
            sdf, _ = decoder_shape.apply(
                params_shape, xc, lat_b, training=cfg.training_mode_shape
            )
        l = torch.abs(sdf[..., 0])
        mask = (result["valid_ids"] & (l < clamp_j)).to(l.dtype)
        terms = {"surface": _masked_mean(l, mask)}
        terms["reg_expr"] = torch.mean(sq_norm(lat_e[sel]))
        terms.update(_shape_regularizers(decoder_shape, lat_s, cfg.unobserved_anchors))
        loss = 0.0
        for i, k in enumerate(lam_keys):
            loss = loss + lam_row[i] * terms[k]
        aux = dict(terms)
        aux["n_valid"] = torch.sum(result["valid_ids"].to(torch.float32))
        aux["broyden_iters"] = result["iters"].to(torch.float32).to(obs.device)
        aux["xc_opt"] = xc_opt
        aux["j_inv"] = result["j_inv"]
        return loss, aux

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
    """Joint identity + expression fitting with Broyden correspondences.

    Returns (lat_expr [n_obs, E], lat_shape [1, D], anchors (None for the
    NPM family), history dict) as numpy.  The parameters move to ``device``
    first (default ``default_device()``).
    ``sample_draws``: optional (sel [T, nb], idx [T, nb, npp]) integer
    arrays replacing the per-step random draws (seeded from ``cfg.seed``).
    The history holds one entry per step for each term, plus
    ``elapsed_s``, ``first_step_s`` and ``steady_it_s`` (steps after the
    first over their wall time).
    """
    device = default_device() if device is None else torch.device(device)
    params_shape = tree_to(params_shape, device)
    params_expr = tree_to(params_expr, device)
    lambdas = dict(lambdas or default_joint_lambdas())
    schedule = schedule or default_joint_schedule()
    total = cfg.total_steps
    lam_keys = tuple(sorted(lambdas))
    nb, npp = cfg.n_obs_per_batch, cfg.n_points_per_obs

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    lr_arr = _scheduled_array(cfg.lr * cfg.lr_scale, schedule.get("lr", {}), total,
                              cfg.step_scale)
    lam_mat = dev(np.stack([
        _scheduled_array(lambdas[k], schedule.get(k, {}), total, cfg.step_scale)
        for k in lam_keys
    ]))
    clamp_arr = dev(_clamp_array(cfg.clamp_schedule, total, cfg.step_scale))

    padded_np, lens_np = _pad_observations(all_obs)
    n_obs = len(all_obs)
    o_pad = -(-n_obs // 8) * 8
    p_pad = -(-padded_np.shape[1] // 512) * 512
    padded_np = np.pad(
        padded_np, ((0, o_pad - n_obs), (0, p_pad - padded_np.shape[1]), (0, 0))
    )
    padded = dev(padded_np)
    lens = dev(lens_np, torch.int64)

    lat_expr = (
        torch.zeros((o_pad, decoder_expr.lat_dim), device=device)
        if lat_expr_init is None
        else torch.nn.functional.pad(
            dev(lat_expr_init).reshape(n_obs, -1), (0, 0, 0, o_pad - n_obs)
        )
    )
    lat_shape = (
        torch.zeros((1, decoder_shape.lat_dim), device=device)
        if lat_shape_init is None
        else dev(lat_shape_init).reshape(1, -1)
    )
    opt_s, opt_e = _Adam(lat_shape), _Adam(lat_expr)

    warm = cfg.warm_start_corresp
    warm_j = warm and cfg.warm_jacobian_store
    store = padded.clone() if warm else None
    store_j = (
        torch.eye(3, device=device).expand(padded.shape[:2] + (3, 3)).contiguous()
        if warm_j
        else None
    )
    loss_fn = _make_joint_loss(
        decoder_shape, decoder_expr, cfg, lam_keys,
        _shape_fields_fn(decoder_shape, cfg, device),
        _use_fused_search(decoder_expr, cfg, device),
    )
    if sample_draws is not None:
        draws_sel = dev(sample_draws[0], torch.int64)
        draws_idx = dev(sample_draws[1], torch.int64)
    else:
        gen = torch.Generator(device=device).manual_seed(cfg.seed)
    hist = torch.zeros((total, len(_JOINT_HIST_KEYS)), device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t_start = time.perf_counter()
    t_first = None
    for j in range(total):
        if sample_draws is not None:
            sel, idx = draws_sel[j], draws_idx[j]
        else:
            sel = torch.randint(0, n_obs, (nb,), generator=gen, device=device)
            u = torch.rand((nb, npp), generator=gen, device=device)
            idx = torch.minimum((u * lens[sel][:, None]).to(torch.int64),
                                lens[sel][:, None] - 1)
        xc0 = store[sel[:, None], idx] if warm else None
        bsteps = cfg.broyden_warm_steps if warm and j > 0 else cfg.broyden_max_steps
        jinv0 = store_j[sel[:, None], idx] if warm_j else None

        lat_s = lat_shape.detach().requires_grad_(True)
        lat_e = lat_expr.detach().requires_grad_(True)
        loss, aux = loss_fn(lat_s, lat_e, params_shape, params_expr, padded,
                            lam_mat[:, j], clamp_arr[j], sel, idx, xc0, jinv0, bsteps)
        g_s, g_e = torch.autograd.grad(loss, (lat_s, lat_e))
        if warm:
            store[sel[:, None], idx] = aux["xc_opt"]
        if warm_j:
            store_j[sel[:, None], idx] = aux["j_inv"]
        opt_s.step(lat_shape, g_s, float(lr_arr[j]))
        opt_e.step(lat_expr, g_e, float(lr_arr[j]))
        aux["loss"] = loss
        hist[j] = torch.stack([torch.as_tensor(aux[k], device=device).detach().reshape(())
                               for k in _JOINT_HIST_KEYS])
        if j == 0:
            sync()
            t_first = time.perf_counter()
    sync()
    t_end = time.perf_counter()

    hist_np = hist.cpu().numpy()
    history = {k: hist_np[:, i] for i, k in enumerate(_JOINT_HIST_KEYS)}
    history["elapsed_s"] = t_end - t_start
    history["first_step_s"] = (t_first or t_end) - t_start
    history["steady_it_s"] = (
        (total - 1) / (t_end - t_first) if total > 1 and t_end > t_first else float("nan")
    )
    if verbose:
        for j in range(0, total, max(1, cfg.log_every)):
            msg = f"Step {j:5d} " + " ".join(
                f"{k} {history[k][j]:02.6f}" for k in sorted(history)
                if k not in ("n_valid", "elapsed_s", "first_step_s", "steady_it_s")
            )
            print(msg, int(history["n_valid"][j]))
        print(f"[fit_joint] {total} steps in {history['elapsed_s']:.1f}s "
              f"({history['steady_it_s']:.1f} it/s after the first step)")
    anchors = None
    if decoder_shape.lat_dim_glob is not None:
        with torch.no_grad():
            anchors = predict_anchors(params_shape, decoder_shape.cfg,
                                      lat_shape).cpu().numpy()
    return lat_expr[:n_obs].cpu().numpy(), lat_shape.cpu().numpy(), anchors, history
