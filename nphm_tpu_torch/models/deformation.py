"""Forward deformation field (counterpart of ``nphm_tpu/models/deformation.py``).

A DeepSDF trunk (no geometric init) predicts 3-D offsets from canonical to
posed space, conditioned on the expression code plus an identity summary:

- ``compress`` (the shipped configs): ``[z_id, anchors]`` through one Linear
  to ``lat_dim_id``, plus N(0,1)*noise_scale at train time;
- ``glob_only``: ``[z_id_glob, z_ex]``;
- ``expr_only``: ``z_ex`` alone;
- ``GNN``: each anchor's position encoded by a two-layer MLP, added to its
  local code and combined per anchor, then all of them with the global code
  into an ``lat_dim_expr``-wide summary: ``[summary, z_ex]``;
- ``interpolate``: per point, ``[z_id_glob, blend(z_id_loc), z_ex]`` with
  the local codes Gaussian-blended on the point's anchor distances.

Every mode but ``interpolate`` conditions on a row-constant code
(``conditioning``); ``interpolate``'s is per point and is built inside
``apply_deformation``.  Only ``compress`` adds train-time noise.  The
expression latent at call sites is ``lat = [z_id(full), z_ex]``.
"""

from __future__ import annotations

import dataclasses

import torch

from nphm_tpu_torch.models.deepsdf import DeepSDFConfig, apply_deepsdf, init_deepsdf
from nphm_tpu_torch.models.mlp import linear, torch_linear_init
from nphm_tpu_torch.ops import precision
from nphm_tpu_torch.utils.math import safe_l2norm

MODES = ("compress", "glob_only", "expr_only", "interpolate", "GNN")


@dataclasses.dataclass(frozen=True)
class DeformationConfig:
    mode: str = "compress"
    lat_dim_expr: int = 200
    lat_dim_id: int = 32
    lat_dim_glob_shape: int = 64
    lat_dim_loc_shape: int = 32
    n_loc: int = 39
    hidden_dim: int = 512
    n_layers: int = 6
    out_dim: int = 3
    input_dim: int = 3
    noise_scale: float = 1.0 / 200.0

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"Unknown deformation mode: {self.mode}")

    @property
    def per_point(self) -> bool:
        """Does the trunk's conditioning vary per point (``interpolate``)?
        Every other mode's is row-constant, which K2 and K7 fold into biases."""
        return self.mode == "interpolate"

    @property
    def lat_dim_shape_full(self) -> int:
        return self.lat_dim_glob_shape + (self.n_loc + 1) * self.lat_dim_loc_shape

    @property
    def lat_dim(self) -> int:
        """Conditioning width of the inner trunk."""
        if self.mode == "glob_only":
            return self.lat_dim_glob_shape + self.lat_dim_expr
        if self.mode == "expr_only":
            return self.lat_dim_expr
        if self.mode == "interpolate":
            return self.lat_dim_glob_shape + self.lat_dim_expr + self.lat_dim_loc_shape
        if self.mode == "GNN":
            return self.lat_dim_expr * 2
        return self.lat_dim_expr + self.lat_dim_id  # compress

    @property
    def compressor_in(self) -> int:
        return (
            (self.lat_dim_loc_shape + 3) * self.n_loc
            + self.lat_dim_loc_shape
            + self.lat_dim_glob_shape
        )

    @property
    def trunk_cfg(self) -> DeepSDFConfig:
        return DeepSDFConfig(
            lat_dim=self.lat_dim,
            hidden_dim=self.hidden_dim,
            n_layers=self.n_layers,
            geometric_init=False,
            out_dim=self.out_dim,
            input_dim=self.input_dim,
        )


def init_deformation(gen: torch.Generator, cfg: DeformationConfig, device=None):
    params = {"trunk": init_deepsdf(gen, cfg.trunk_cfg, device)}
    if cfg.mode == "compress":
        params["compressor"] = torch_linear_init(
            gen, cfg.compressor_in, cfg.lat_dim_id, device
        )
    elif cfg.mode == "GNN":
        L, G, E = cfg.lat_dim_loc_shape, cfg.lat_dim_glob_shape, cfg.lat_dim_expr

        def mlp(*dims):
            return [torch_linear_init(gen, i, o, device) for i, o in zip(dims, dims[1:])]

        params["pos_enc"] = mlp(3, L, L)
        params["local_combiner"] = mlp(L, L, L)
        params["global_combiner"] = mlp(G + cfg.n_loc * L, 512, E)
    return params


def _mlp2(layers, x):
    """Linear -> ReLU -> Linear."""
    return linear(layers[1], torch.relu(linear(layers[0], x)))


def _interp_local(q, anchors, loc_lat, var: float = 0.1**2):
    """Per-point Gaussian blend [B, N, L] of the local codes loc_lat [B, K, L]
    on the distances of q [B, N, 3] to anchors [B, K, 3] (no background)."""
    d = safe_l2norm(anchors[:, None, :, :] - q[:, :, None, :], dim=-1)
    w = torch.exp(-((d + 1e-5) ** 2) / var)
    w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-6)
    return precision.einsum("bnk,bkc->bnc", w, loc_lat)


def _local_codes(cfg: DeformationConfig, lat):
    """The n_loc local identity codes [B, n_loc, L] of lat [B, D]."""
    G, L = cfg.lat_dim_glob_shape, cfg.lat_dim_loc_shape
    return lat[..., G : G + cfg.n_loc * L].reshape(lat.shape[0], cfg.n_loc, L)


def conditioning(params, cfg: DeformationConfig, lat, anchors, *,
                 training: bool = False, gen=None, noise=None):
    """Row-constant trunk conditioning [B, cfg.lat_dim] from lat [B, D] and
    anchors [B, K, 3] (compress and GNN).

    In compress mode at train time the compressed code gets N(0, 1) *
    ``noise_scale``: ``noise`` [B, lat_dim_id] when given, else drawn from
    ``gen``.  Raises for ``interpolate``, whose conditioning is per point."""
    B = lat.shape[0]
    E = cfg.lat_dim_expr
    z_ex = lat[..., -E:]
    if cfg.per_point:
        raise ValueError("'interpolate' conditioning is per-point")
    if cfg.mode == "glob_only":
        return torch.cat([lat[..., : cfg.lat_dim_glob_shape], z_ex], dim=-1)
    if cfg.mode == "expr_only":
        return z_ex
    if cfg.mode == "GNN":
        G = cfg.lat_dim_glob_shape
        local = _mlp2(params["local_combiner"],
                      _mlp2(params["pos_enc"], anchors) + _local_codes(cfg, lat))
        combined = _mlp2(params["global_combiner"],
                         torch.cat([lat[..., :G], local.reshape(B, -1)], dim=-1))
        return torch.cat([combined, z_ex], dim=-1)
    concat = torch.cat([lat[..., :-E], anchors.reshape(B, -1)], dim=-1)  # compress
    compressed = linear(params["compressor"], concat)
    if training:
        if noise is None:
            if gen is None:
                raise ValueError("compress-mode training needs a generator for noise")
            noise = torch.randn(compressed.shape, generator=gen)
        compressed = compressed + noise.to(compressed.device) * cfg.noise_scale
    return torch.cat([compressed, z_ex], dim=-1)


def apply_deformation(params, cfg: DeformationConfig, xyz, lat, anchors=None, *,
                      training: bool = False, gen=None, noise=None):
    """Offsets for xyz [B, N, 3] under lat [B, lat_dim_shape_full + lat_dim_expr]
    and anchors [B, K, 3] (compress, GNN and interpolate).

    Returns (delta [B, N, 3], extra [B, N, 1]) like the JAX package.
    """
    if cfg.per_point:
        B, N, _ = xyz.shape
        G, E = cfg.lat_dim_glob_shape, cfg.lat_dim_expr
        interp = _interp_local(xyz[..., :3], anchors, _local_codes(cfg, lat))
        cond = torch.cat([lat[:, None, :G].expand(B, N, G), interp,
                          lat[:, None, -E:].expand(B, N, E)], dim=-1)
    else:
        cond = conditioning(params, cfg, lat, anchors, training=training, gen=gen,
                            noise=noise)
    pred = apply_deepsdf(params["trunk"], cfg.trunk_cfg, xyz, cond)
    return pred[..., :3], pred[..., -1:]
