"""Training losses (counterpart of ``nphm_tpu/training/losses.py``).

Behavioural spec: reference ``src/NPHM/models/loss_functions.py``.

- ``identity_sdf_loss`` == ``actual_compute_loss`` (:20-110): |sdf| on
  surface points, normal alignment (clamped at 0.75 and halved for non-face
  points), eikonal |grad| - 1 everywhere, exp(-10|sdf|) repulsion at far
  points, latent L2, anchor MSE, and symmetric / middle latent-pair
  consistency.  The four point sets are concatenated into one field
  evaluation, as in the JAX package.
- ``deformation_loss`` == ``compute_loss_corresp_forward`` (:282-322).
- ``joint_loss`` == ``loss_joint`` (:113-279), the joint two-network loss,
  which the reference's pipelines never call; plain torch, no kernel.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from nphm_tpu_torch.models.fields import rematerialized, value_and_spatial_gradient
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
                      training: bool = True, remat: bool = False,
                      fields_fn=None) -> Dict[str, torch.Tensor]:
    """IGR identity-SDF loss dict.

    batch keys: points_face [B,Nf,3], normals_face, points_non_face [B,Nn,3],
    normals_non_face, sup_grad_far [B,Fa,3], sup_grad_near [B,Ne,3],
    gt_anchors [B,K,3] (ensemble decoder).  lat: [B, lat_dim].

    remat: recompute the decoder forward in the backward pass
    (``models.fields.rematerialized``, as the JAX loss wraps its field in
    ``jax.checkpoint``).  The gradients are the same.  Off by default,
    unlike JAX: torch recomputes a checkpointed forward once per backward
    call, and the eikonal term's double backprop makes two, so on an H100
    the NPM stage-1 step takes about 1.3x the time and 1.1x the peak
    memory.

    fields_fn: optional ``(params, pts [B,N,3], lat) -> (sdf [B,N,1],
    grads [B,N,3], anchors)`` replacing the decoder + autograd gradient
    pair (the hook for ``ops.train_fields.apply_nphm_train``, K5/K6).  It
    keeps what it needs itself, so ``remat`` is ignored.
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

        if remat:
            field = rematerialized(field)
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


def _masked_concat_mean(parts):
    """Mean over a virtual concatenation of (values, mask) groups: the
    reference's ``torch.cat([...]).mean()`` over data-dependent row subsets.
    values [B, ...]; mask [B] (bool) or None (every row counts)."""
    total, count = 0.0, 0.0
    for values, mask in parts:
        if mask is None:
            total = total + values.sum()
            count = count + values.numel()
        else:
            per_row = values.reshape(values.shape[0], -1)
            m = mask.reshape(-1, 1).to(per_row.dtype)
            total = total + (per_row * m).sum()
            count = count + m.sum() * per_row.shape[1]
    count = torch.as_tensor(count, dtype=total.dtype, device=total.device)
    return total / torch.clamp(count, min=1.0)


def joint_loss(decoder_shape, params_shape, decoder_expr, params_expr,
               batch: Dict[str, torch.Tensor], lat_shape, lat_expr, epoch: int, *,
               training: bool = True, gen: Optional[torch.Generator] = None,
               draws: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """Joint two-network training loss (reference loss_functions.py:113-279
    ``loss_joint``), the terms of the JAX package's ``joint_loss``.

    The identity SDF is supervised through the backward composition
    ``shape(posed + expr_delta(posed))`` on posed surface points, with
    neutral-scan-only back-of-head and off-surface terms, an off-surface
    SDF target, canonical far-space eikonal and repulsion, latent and
    symmetry regularizers, anchor supervision, the correspondence loss
    gated by epoch (x0.25 after epoch 750, off from 3000), the
    zero-deformation prior and a neutral-scan zero-deformation term.  As in
    the reference, the expression field gets no anchors, so it must be an
    anchor-free mode (``expr_only``, ``glob_only``) or the NPM family's
    offsets network, and draws no noise.

    batch keys: points_surface / normals_surface [B,N,3],
    points_surface_outer / normals_surface_outer [B,No,3],
    points_off_surface / normals_off_surface [B,Nf,3], sdfs_off_surface
    [B,Nf,1], sup_grad_far [B,Fa,3], gt_anchors, corresp_posed /
    corresp_neutral [B,Nc,3], is_neutral [B,1].  The one random draw, the
    prior's U[0, 1) points before they are mapped to [-1.25, 1.25]^3, goes
    through ``draws("samples", shape, device)`` (default
    ``generator_draws(gen)``), so a caller can hand in the JAX loss's.
    """
    draws = draws or generator_draws(gen)
    cond = torch.cat([lat_shape, lat_expr], dim=-1)
    # rows of neutral scans; with none, each masked mean is 0 / 1 = 0
    neutral = batch["is_neutral"].reshape(-1) == 1

    def expr_delta(pts):
        return decoder_expr.apply(params_expr, pts, cond, None, training=training)[0]

    def surf_terms(pts):
        """(sdf [B,N,1], its gradient, the offsets, anchors) of the composition
        at posed points pts, from one forward pass."""
        extra = {}

        def field(p):
            delta = expr_delta(p)
            sdf, anchors = decoder_shape.apply(params_shape, p + delta, lat_shape,
                                               training=training)
            extra.update(delta=delta, anchors=anchors)
            return sdf

        sdf, grads = value_and_spatial_gradient(field, pts)
        return sdf, grads, extra["delta"], extra["anchors"]

    def normal_eik(grads, normals):
        return safe_l2norm(grads - normals), torch.abs(safe_l2norm(grads, dim=-1) - 1.0)

    # on surface, face (all scans)
    sdf_s, g_s, delta_s, anchors = surf_terms(batch["points_surface"])
    nrm_s, eik_s = normal_eik(g_s, batch["normals_surface"])
    sdf_s = sdf_s[..., 0].abs()
    # on surface, back of head (neutral scans only)
    sdf_o, g_o, delta_o, _ = surf_terms(batch["points_surface_outer"])
    nrm_o, eik_o = normal_eik(g_o, batch["normals_surface_outer"])
    sdf_o = sdf_o[..., 0].abs()
    nrm_o = torch.clamp(nrm_o, max=0.75 * 100) / 2  # (sic: reference :154)
    # off surface with SDF targets (neutral scans only)
    sdf_f, g_f, delta_f, _ = surf_terms(batch["points_off_surface"])
    nrm_f, eik_f = normal_eik(g_f, batch["normals_off_surface"])
    sdf_f = (sdf_f - batch["sdfs_off_surface"])[..., 0].abs()
    nrm_f = torch.clamp(nrm_f, max=0.75 * 100) / 2

    # off surface, canonical space only (all scans)
    sdf_far, g_far = value_and_spatial_gradient(
        lambda p: decoder_shape.apply(params_shape, p, lat_shape, training=training)[0],
        batch["sup_grad_far"])
    eik_far = torch.abs(safe_l2norm(g_far, dim=-1) - 1.0)

    out = {
        "surf_sdf_loss": _masked_concat_mean(
            [(sdf_s, None), (sdf_o, neutral), (sdf_f, neutral)]),
        "normal_loss": _masked_concat_mean(
            [(nrm_s, None), (nrm_o, neutral), (nrm_f, neutral)]),
        "space_sdf_loss": torch.mean(torch.exp(-10.0 * sdf_far[..., 0].abs())),
        "eik_loss": _masked_concat_mean(
            [(eik_far, None), (eik_s, None), (eik_o, neutral), (eik_f, neutral)]),
        "reg_shape": torch.mean(sq_norm(lat_shape)),
        "reg_expr": torch.mean(sq_norm(lat_expr)),
    }
    if anchors is not None and "gt_anchors" in batch:
        out["anchors"] = torch.mean((anchors - batch["gt_anchors"]) ** 2)
    if decoder_shape.lat_dim_glob is not None:
        out["symm_dist"], out["middle_dist"] = latent_pair_consistency(decoder_shape,
                                                                       lat_shape)

    # correspondences, gated by epoch (reference :246-256)
    posed = batch["corresp_posed"]
    corresp = torch.mean((posed + expr_delta(posed) - batch["corresp_neutral"]) ** 2)
    out["corresp"] = corresp * (1.0 if epoch <= 750 else (0.25 if epoch < 3000 else 0.0))

    # zero-deformation prior at uniform points in [-1.25, 1.25]^3
    samps = (draws("samples", (lat_shape.shape[0], min(100, posed.shape[1]), 3),
                   posed.device) - 0.5) * 2.5
    out["loss_reg_zero"] = torch.mean(expr_delta(samps) ** 2)

    # neutral scans: small deformations on all three point sets (three
    # separate neutral-row means, summed: reference :263-266)
    out["loss_neutral_zero"] = (_masked_concat_mean([(delta_s**2, neutral)])
                                + _masked_concat_mean([(delta_o**2, neutral)])
                                + _masked_concat_mean([(delta_f**2, neutral)]))
    return out
