"""Stage-1 training loss (counterpart of ``identity_sdf_loss`` and
``latent_pair_consistency`` in ``nphm_tpu/training/losses.py``).

Behavioural spec: reference ``src/NPHM/models/loss_functions.py``
``actual_compute_loss`` (:20-110): |sdf| on surface points, normal
alignment (clamped at 0.75 and halved for non-face points), eikonal
|grad| - 1 everywhere, exp(-10|sdf|) repulsion at far points, latent L2,
anchor MSE, and symmetric / middle latent-pair consistency.  The four point
sets are concatenated into one field evaluation, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict

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
