"""The NPHM identity decoder (counterpart of ``nphm_tpu/models/ensemble.py``).

An ensemble of 39 anchored local DeepSDF MLPs plus one global background
member, blended with a Gaussian kernel on point-to-anchor distance.  Pairs
of members share weights (``member_map``) and odd pair members see
x-mirrored local coordinates (``mirror_sign``).  Anchors are predicted from
the global latent as offsets to the dataset-mean anchors.

As in the JAX package, the per-member conditioning ``[z_glob, z_k]`` is
folded into per-(member, row) biases, and eval mode pins the background
*member* to SDF 1 (the documented intent of the reference, whose indexing
pins the last point instead).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nphm_tpu_torch.models.mlp import linear, mlp_dims, softplus_beta, torch_linear_init
from nphm_tpu_torch.utils.math import safe_l2norm

SQRT2 = 1.4142135623730951


@dataclasses.dataclass(frozen=True)
class NPHMConfig:
    lat_dim_glob: int = 64
    lat_dim_loc: int = 32
    n_loc: int = 39
    n_symm_pairs: int = 16
    hidden_dim: int = 200
    n_layers: int = 4
    pos_mlp_dim: int = 256
    out_dim: int = 1
    input_dim: int = 3
    beta: float = 100.0
    blend_var: float = 0.1**2
    blend_background_dist: float = -0.2

    @property
    def n_members(self) -> int:
        return self.n_loc + 1

    @property
    def n_distinct(self) -> int:
        return self.n_members - self.n_symm_pairs

    @property
    def lat_dim(self) -> int:
        return self.lat_dim_glob + self.n_members * self.lat_dim_loc

    @property
    def lat_dim_part(self) -> int:
        return self.lat_dim_glob + self.lat_dim_loc

    @property
    def d_in(self) -> int:
        return self.input_dim + self.lat_dim_part

    @property
    def member_map(self) -> np.ndarray:
        """Distinct-weight index per member: pair (2k, 2k+1) shares weight k."""
        pairs = np.repeat(np.arange(self.n_symm_pairs), 2)
        rest = np.arange(self.n_symm_pairs, self.n_distinct)
        return np.concatenate([pairs, rest]).astype(np.int64)

    @property
    def mirror_sign(self) -> np.ndarray:
        """Per-member sign on the local x coordinate (-1 for odd pair members)."""
        sign = np.ones(self.n_members, dtype=np.float32)
        sign[1 : 2 * self.n_symm_pairs : 2] = -1.0
        return sign

    @property
    def layer_shapes(self):
        return mlp_dims(self.d_in, self.hidden_dim, self.n_layers, self.out_dim)


def init_nphm(gen: torch.Generator, cfg: NPHMConfig, mean_anchors, device="cpu"):
    """Full NPHM parameter dict; mean_anchors: [n_loc, 3] (held fixed)."""
    shapes, _ = cfg.layer_shapes
    ensemble = []
    for s_in, s_out in shapes:
        bound = 1.0 / np.sqrt(s_in)
        u = torch.rand((cfg.n_distinct, s_out, s_in), generator=gen)
        v = torch.rand((cfg.n_distinct, s_out), generator=gen)
        ensemble.append(
            {
                "w": ((u * 2 - 1) * bound).to(device),
                "b": ((v * 2 - 1) * bound).to(device),
            }
        )
    g, p = cfg.lat_dim_glob, cfg.pos_mlp_dim
    mlp_pos = [
        torch_linear_init(gen, g, p, device),
        torch_linear_init(gen, p, p, device),
        torch_linear_init(gen, p, cfg.n_loc * 3, device),
    ]
    return {
        "ensemble": ensemble,
        "mlp_pos": mlp_pos,
        "mean_anchors": torch.as_tensor(
            np.asarray(mean_anchors, np.float32), device=device
        ).reshape(cfg.n_loc, 3),
    }


def predict_anchors(params, cfg: NPHMConfig, lat):
    """Anchor positions from the global latent: [..., lat_dim] -> [..., n_loc, 3]."""
    z_glob = lat[..., : cfg.lat_dim_glob]
    h = torch.relu(linear(params["mlp_pos"][0], z_glob))
    h = torch.relu(linear(params["mlp_pos"][1], h))
    offsets = linear(params["mlp_pos"][2], h)
    offsets = offsets.reshape(offsets.shape[:-1] + (cfg.n_loc, 3))
    return offsets + params["mean_anchors"].detach()


def _split_cond(cfg: NPHMConfig, lat):
    """lat [B, lat_dim] -> per-member cond [B, n_members, G+L]."""
    z_glob = lat[..., : cfg.lat_dim_glob]
    z_loc = lat[..., cfg.lat_dim_glob :].reshape(
        lat.shape[:-1] + (cfg.n_members, cfg.lat_dim_loc)
    )
    z_glob = z_glob[..., None, :].expand(z_loc.shape[:-1] + (cfg.lat_dim_glob,))
    return torch.cat([z_glob, z_loc], dim=-1)


def _expand(cfg: NPHMConfig, t):
    """Gather distinct weights to the full member axis (symmetric sharing)."""
    idx = torch.as_tensor(cfg.member_map, device=t.device)
    return torch.index_select(t, 0, idx)


def mirror_scale(cfg: NPHMConfig, device):
    """[A, 3] per-member coordinate scale: the mirror sign on x, 1 elsewhere."""
    sign = torch.as_tensor(cfg.mirror_sign, device=device)[:, None]
    return torch.cat([sign, torch.ones((cfg.n_members, 2), device=device)], dim=1)


def ensemble_trunk(params_ensemble, cfg: NPHMConfig, coords, cond):
    """All ensemble MLPs with conditioning folded into biases.

    coords: [A, B, N, 3] member-local coordinates; cond: [B, A, C].
    Returns [A, B, N, out_dim].
    """
    _shapes, skip_in = cfg.layer_shapes
    n = len(params_ensemble)
    ds = cfg.input_dim

    cond_a = cond.permute(1, 0, 2)  # [A, B, C]
    x = coords
    for i in range(n):
        w = _expand(cfg, params_ensemble[i]["w"])  # [A, out, in]
        b = _expand(cfg, params_ensemble[i]["b"])  # [A, out]
        if i == 0:
            bias = torch.einsum("abc,aoc->abo", cond_a, w[:, :, ds:]) + b[:, None, :]
            x = torch.einsum("abni,aoi->abno", coords, w[:, :, :ds]) + bias[:, :, None, :]
        elif i == skip_in:
            h = w.shape[2] - cfg.d_in
            bias = torch.einsum("abc,aoc->abo", cond_a, w[:, :, h + ds :]) / SQRT2
            x = (
                (
                    torch.einsum("abni,aoi->abno", x, w[:, :, :h])
                    + torch.einsum("abni,aoi->abno", coords, w[:, :, h : h + ds])
                )
                / SQRT2
                + bias[:, :, None, :]
                + b[:, None, None, :]
            )
        else:
            x = torch.einsum("abni,aoi->abno", x, w) + b[:, None, None, :]
        if i < n - 1:
            x = softplus_beta(x, cfg.beta)
    return x


def blend_weights(q, anchors, var, background_dist):
    """Normalized Gaussian blend weights. q [B,N,3], anchors [B,K,3] -> [B,N,K+1]."""
    d = safe_l2norm(anchors[:, None, :, :] - q[:, :, None, :], dim=-1)
    dist = -((d + 1e-5) ** 2)
    dist = torch.cat([dist, torch.full_like(dist[..., :1], background_dist)], dim=-1)
    weight = torch.exp(dist / var)
    return weight / (torch.sum(weight, dim=-1, keepdim=True) + 1e-6)


def gaussian_blend(q, anchors, member_preds, var, background_dist):
    """Blend member predictions [B, N, K+1, C] with the Gaussian kernel."""
    weight = blend_weights(q, anchors, var, background_dist)
    return torch.sum(weight[..., None] * member_preds, dim=2)


def apply_nphm(params, cfg: NPHMConfig, xyz, lat, *, training: bool = False):
    """NPHM identity SDF.

    xyz: [B, N, 3]; lat: [B, lat_dim].  Returns (sdf [B, N, out_dim],
    anchors [B, n_loc, 3]).
    """
    anchors = predict_anchors(params, cfg, lat)
    centers = torch.cat([anchors, torch.zeros_like(anchors[:, :1, :])], dim=1)
    coords = (xyz[:, :, None, :] - centers[:, None, :, :]) * mirror_scale(
        cfg, xyz.device
    )
    cond = _split_cond(cfg, lat)
    preds = ensemble_trunk(params["ensemble"], cfg, coords.permute(2, 0, 1, 3), cond)
    if not training:
        # background member always reports "outside"
        bg = preds[-1:].clone()
        bg[..., 0] = 1.0
        preds = torch.cat([preds[:-1], bg], dim=0)
    preds = preds.permute(1, 2, 0, 3)  # [B, N, A, out]
    sdf = gaussian_blend(xyz, anchors, preds, cfg.blend_var, cfg.blend_background_dist)
    return sdf, anchors
