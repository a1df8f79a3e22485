"""Batched Broyden root finding and posed->canonical correspondence search
(counterpart of ``nphm_tpu/fitting/broyden.py``).

Finds roots of g(x) = warp(x) - observation per point with good-Broyden
rank-1 inverse-Jacobian updates, per-point convergence/divergence masks and
genuine best-iterate tracking (the reference aliases ``x_opt = x`` and so
returns the last iterate; the returned norms are identical).  These are the
plain versions the fit uses when the fused search is off; the IFT
correction always runs here, in torch autograd through the deformation
trunk.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from nphm_tpu_torch.models.fields import point_jacobian
from nphm_tpu_torch.ops import precision
from nphm_tpu_torch.utils.math import inv3x3


@torch.no_grad()
def broyden(g: Callable, x_init, j_inv_init, max_steps: int = 15,
            cvg_thresh: float = 1e-6, dvg_thresh: float = 0.2, eps: float = 1e-6,
            min_active: int = 0, groups: int = 1):
    """Solve g(x) = 0 per point; g: [P, 3] -> [P, 3].

    Returns dict(result [P,3], diff [P], valid_ids [P], j_inv [P,3,3],
    active [P], iters, group_iters).  The P points split into ``groups``
    equal groups (a batched fit's subjects), each iterating only while more
    than ``min_active`` of its points are active (0 = the reference's
    ``any(active)``), as each subject's own loop does under the JAX
    package's ``vmap``; ``group_iters`` [groups] counts each group's
    iterations, ``iters`` is their max.
    """
    x = x_init.detach()
    j_inv = j_inv_init.detach()
    gx = g(x)
    update = -precision.einsum("pij,pj->pi", j_inv, gx)
    best_norm = torch.linalg.norm(gx, dim=-1)
    x_best = x
    active = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    group_iters = torch.zeros(groups, dtype=torch.int32, device=x.device)
    it = 0
    while it < max_steps:
        live = active.reshape(groups, -1).sum(dim=1) > min_active
        if not bool(live.any()):
            break
        # a group that stopped keeps its state: its active points stand still
        m = (active & live.repeat_interleave(x.shape[0] // groups))[:, None]
        delta_x = torch.where(m, update, 0.0)
        x = x + delta_x
        gx_new = g(x)
        delta_gx = torch.where(m, gx_new - gx, 0.0)
        gx = gx + delta_gx

        gx_norm = torch.linalg.norm(gx, dim=-1)
        better = gx_norm < best_norm
        best_norm = torch.where(better, gx_norm, best_norm)
        x_best = torch.where(better[:, None], x, x_best)
        new_active = (best_norm > cvg_thresh) & (gx_norm < dvg_thresh)

        # good-Broyden rank-1 update of J^-1
        vT = precision.einsum("pi,pij->pj", delta_x, j_inv)
        a = delta_x - precision.einsum("pij,pj->pi", j_inv, delta_gx)
        b = precision.einsum("pj,pj->p", vT, delta_gx)
        b = torch.where(b >= 0, b + eps, b - eps)
        u = a / b[:, None]
        j_inv = j_inv + torch.where(m[:, :, None], u[:, :, None] * vT[:, None, :], 0.0)
        update = -precision.einsum("pij,pj->pi", j_inv, gx)
        active = new_active
        group_iters += live.to(torch.int32)
        it += 1
    return {
        "result": x_best,
        "diff": best_norm,
        "valid_ids": best_norm < cvg_thresh,
        "j_inv": j_inv,
        "active": active,
        "iters": torch.tensor(it, dtype=torch.int32),
        "group_iters": group_iters,
    }


def search(decoder_expr, params_expr, obs, cond, anchors: Optional[torch.Tensor],
           max_steps: int = 15, cvg_thresh: float = 1e-6, dvg_thresh: float = 0.2,
           xc_init=None, identity_j_init: bool = False, j_inv_init=None,
           frac_exit: float = 0.0, groups: int = 1):
    """Posed -> canonical correspondences through the forward warp.

    obs: [B, N, 3]; cond: [B, D] latent ``[z_id, z_ex]``; anchors [B, K, 3]
    or None.  ``xc_init`` warm-starts from earlier roots (default: obs);
    ``j_inv_init`` resumes from an earlier refined inverse Jacobian
    (default: I when ``identity_j_init``, else the autograd Jacobian's
    inverse); ``groups``: equal groups of rows (a batched fit's subjects)
    that iterate and exit on their own (``broyden``).  Returns (xc
    [B, N, 3], result dict); diverged points get J^-1 reset to I.
    """
    n_batch, n_point, _ = obs.shape
    obs = obs.detach()
    cond = cond.detach()
    anchors = None if anchors is None else anchors.detach()
    xc_init = obs if xc_init is None else xc_init.detach()

    def warp(x):
        delta, _ = decoder_expr.apply(params_expr, x, cond, anchors)
        return x + delta

    if j_inv_init is None:
        if identity_j_init:
            j_inv_init = torch.eye(3, device=obs.device).expand(
                xc_init.shape[:-1] + (3, 3)
            )
        else:
            j_inv_init = inv3x3(point_jacobian(warp, xc_init, create_graph=False))

    def g(x_flat):
        x = x_flat.reshape(n_batch, -1, 3)
        return (warp(x) - obs).reshape(-1, 3)

    n_total = n_batch * n_point // groups
    min_active = max(1, int(frac_exit * n_total)) if frac_exit > 0 else 0
    result = broyden(
        g, xc_init.reshape(-1, 3), j_inv_init.reshape(-1, 3, 3),
        max_steps=max_steps, cvg_thresh=cvg_thresh, dvg_thresh=dvg_thresh,
        min_active=min_active, groups=groups,
    )
    diverged = ~result["active"] & ~result["valid_ids"]
    eye = torch.eye(3, dtype=result["j_inv"].dtype, device=obs.device)
    j_inv = torch.where(diverged[:, None, None], eye, result["j_inv"])
    xc = result["result"].reshape(n_batch, n_point, 3)
    return xc, {
        "result": xc,
        "diff": result["diff"],
        "valid_ids": result["valid_ids"].reshape(n_batch, n_point),
        "j_inv": j_inv.reshape(n_batch, n_point, 3, 3),
        "iters": result["iters"],
        "group_iters": result["group_iters"],
    }


def ift_correction(decoder_expr, params_expr, xc_opt, cond, anchors, j_inv=None):
    """Implicit-function-theorem gradient attachment at the found root.

    Returns ``xc`` equal in value to ``xc_opt`` whose gradient w.r.t. the
    latents is d xc = -J^-1 d warp(xc).  ``j_inv`` [B, N, 3, 3] replaces the
    exact autograd Jacobian's inverse (e.g. the search's refined secant).
    """
    xc_opt = xc_opt.detach()

    def warp(x):
        delta, _ = decoder_expr.apply(params_expr, x, cond, anchors)
        return x + delta

    preds_posed = warp(xc_opt)
    if j_inv is None:
        j_inv = inv3x3(point_jacobian(
            lambda x: x + decoder_expr.apply(
                params_expr, x, cond.detach(),
                None if anchors is None else anchors.detach(),
            )[0],
            xc_opt, create_graph=False,
        ))
    j_inv = j_inv.detach()
    correction = preds_posed - preds_posed.detach()
    correction = precision.einsum("bnij,bnj->bni", -j_inv, correction)
    return xc_opt + correction
