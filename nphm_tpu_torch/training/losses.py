"""Training losses (counterpart of ``identity_sdf_loss``,
``latent_pair_consistency`` and ``deformation_loss`` in
``nphm_tpu/training/losses.py``; its ``joint_loss``, which the reference's
pipelines never call, is not ported).

Behavioural spec: reference ``src/NPHM/models/loss_functions.py``
``actual_compute_loss`` (:20-110): |sdf| on surface points, normal
alignment (clamped at 0.75 and halved for non-face points), eikonal
|grad| - 1 everywhere, exp(-10|sdf|) repulsion at far points, latent L2,
anchor MSE, and symmetric / middle latent-pair consistency.  The four point
sets are concatenated into one field evaluation, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from nphm_tpu_torch.models.fields import value_and_spatial_gradient
from nphm_tpu_torch.utils.math import safe_l2norm, sq_norm


def latent_pair_consistency(decoder, lat):
    """Symmetric-pair and middle-pair latent consistency terms
    (reference loss_functions.py:74-85)."""
    g, l = decoder.lat_dim_glob, decoder.lat_dim_loc
    n_symm = decoder.n_symm_pairs
    n_kps = decoder.n_loc
    B = lat.shape[0]
    loc_symm = lat[:, g : g + 2 * n_symm * l].reshape(B, 2 * n_symm, l)
    symm_dist = torch.mean(safe_l2norm(loc_symm[:, ::2] - loc_symm[:, 1::2]))
    loc_middle = lat[:, g + 2 * n_symm * l : -l].reshape(B, n_kps - 2 * n_symm, l)
    if loc_middle.shape[1] < 2:  # no middle pairs to compare
        return symm_dist, torch.zeros((), device=lat.device)
    if loc_middle.shape[1] % 2 == 0:
        middle = safe_l2norm(loc_middle[:, ::2] - loc_middle[:, 1::2])
    else:
        middle = safe_l2norm(loc_middle[:, :-1:2] - loc_middle[:, 1::2])
    return symm_dist, torch.mean(middle)


def identity_sdf_loss(decoder, params, batch: Dict[str, torch.Tensor], lat, *,
                      training: bool = True, fields_fn=None) -> Dict[str, torch.Tensor]:
    """IGR identity-SDF loss dict.

    batch keys: points_face [B,Nf,3], normals_face, points_non_face [B,Nn,3],
    normals_non_face, sup_grad_far [B,Fa,3], sup_grad_near [B,Ne,3],
    gt_anchors [B,K,3] (ensemble decoder).  lat: [B, lat_dim].

    fields_fn: optional ``(params, pts [B,N,3], lat) -> (sdf [B,N,1],
    grads [B,N,3], anchors)`` replacing the decoder + autograd gradient
    pair (the hook for ``ops.train_fields.apply_nphm_train``, K5/K6).
    """
    pf, pn = batch["points_face"], batch["points_non_face"]
    far, near = batch["sup_grad_far"], batch["sup_grad_near"]
    n_f, n_n, n_fa = pf.shape[1], pn.shape[1], far.shape[1]
    pts = torch.cat([pf, pn, far, near], dim=1)

    if fields_fn is not None:
        sdf, grads, anchors = fields_fn(params, pts, lat)
    else:
        def field(x):
            return decoder.apply(params, x, lat, training=training)[0]

        sdf, grads = value_and_spatial_gradient(field, pts)
        # anchors are point-independent
        _, anchors = decoder.apply(params, pts[:, :1], lat, training=training)

    sdf_f = sdf[:, :n_f, 0]
    sdf_n = sdf[:, n_f : n_f + n_n, 0]
    sdf_far = sdf[:, n_f + n_n : n_f + n_n + n_fa, 0]
    g_f = grads[:, :n_f]
    g_n = grads[:, n_f : n_f + n_n]

    surf_sdf = torch.mean(torch.cat([sdf_f.abs(), sdf_n.abs()], dim=1))
    normal_f = safe_l2norm(g_f - batch["normals_face"])
    normal_n = torch.clamp(safe_l2norm(g_n - batch["normals_non_face"]), max=0.75) / 2.0
    normals = torch.mean(torch.cat([normal_f, normal_n], dim=1))
    eikonal = torch.mean(torch.abs(safe_l2norm(grads, dim=-1) - 1.0))
    space_sdf = torch.mean(torch.exp(-10.0 * sdf_far.abs()))
    lat_reg = torch.mean(sq_norm(lat))

    out = {
        "surf_sdf": surf_sdf,
        "normals": normals,
        "space_sdf": space_sdf,
        "grad": eikonal,
        "lat_reg": lat_reg,
    }
    if anchors is not None and "gt_anchors" in batch:
        out["anchors"] = torch.mean((anchors - batch["gt_anchors"]) ** 2)
        symm, middle = latent_pair_consistency(decoder, lat)
        out["symm_dist"] = symm
        out["middle_dist"] = middle
    return out


def generator_draws(gen: Optional[torch.Generator] = None):
    """The draws of ``deformation_loss`` from a (CPU) generator: N(0, 1) for
    the noise kinds, U[0, 1) for "samples", moved to the loss's device."""

    def draw(kind: str, shape, device):
        fn = torch.rand if kind == "samples" else torch.randn
        return fn(shape, generator=gen).to(device)

    return draw


def deformation_loss(decoder_expr, params_expr, batch: Dict[str, torch.Tensor], lat_shape,
                     lat_expr, anchors, *, training: bool = True,
                     gen: Optional[torch.Generator] = None,
                     draws: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """Forward-deformation correspondence loss dict.

    batch keys: points_neutral [B,N,3], points_posed [B,N,3].
    lat_shape: [B, D_id] frozen identity codes; lat_expr: [B, E].
    anchors: [B, K, 3] from the frozen identity decoder, or None.

    The random draws go through ``draws(kind, shape, device)`` (default
    ``generator_draws(gen)``): "noise" and "noise_reg", the N(0, 1) noise
    of a compress-mode field at train time at the neutral points and at the
    prior's points; "samples", U[0, 1) points of the zero-deformation prior
    before they are mapped to [-1.25, 1.25]^3.  The JAX package draws the
    same three from split keys; a caller can hand those draws in here.
    """
    draws = draws or generator_draws(gen)
    lat = torch.cat([lat_shape, lat_expr], dim=-1)
    pn = batch["points_neutral"]
    B, N, _ = pn.shape
    noisy = (training and decoder_expr.kind == "deformation"
             and decoder_expr.cfg.mode == "compress")

    def noise(kind):
        return draws(kind, (B, decoder_expr.cfg.lat_dim_id), pn.device) if noisy else None

    delta, _ = decoder_expr.apply(params_expr, pn, lat, anchors, training=training,
                                  noise=noise("noise"))
    corresp = torch.mean((pn + delta - batch["points_posed"][..., :3]) ** 2)
    lat_reg = torch.mean(sq_norm(lat_expr))

    # zero-deformation prior at uniform random points in [-1.25, 1.25]^3
    samps = (draws("samples", (B, min(100, N), 3), pn.device) - 0.5) * 2.5
    delta_reg, _ = decoder_expr.apply(params_expr, samps, lat, anchors, training=training,
                                      noise=noise("noise_reg"))
    return {"corresp": corresp, "lat_reg": lat_reg,
            "loss_reg_zero": torch.mean(delta_reg**2)}
