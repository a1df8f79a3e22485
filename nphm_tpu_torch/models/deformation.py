"""Forward deformation field (counterpart of ``nphm_tpu/models/deformation.py``).

A DeepSDF trunk (no geometric init) predicts 3-D offsets from canonical to
posed space, conditioned on the expression code plus an identity summary:

- ``compress`` (the shipped configs): ``[z_id, anchors]`` through one Linear
  to ``lat_dim_id``, plus N(0,1)*noise_scale at train time;
- ``glob_only``: ``[z_id_glob, z_ex]``;
- ``expr_only``: ``z_ex`` alone.

``interpolate`` and ``GNN`` are not ported yet and raise
``NotImplementedError``.  The expression latent at call sites is
``lat = [z_id(full), z_ex]``.
"""

from __future__ import annotations

import dataclasses

import torch

from nphm_tpu_torch.models.deepsdf import DeepSDFConfig, apply_deepsdf, init_deepsdf
from nphm_tpu_torch.models.mlp import linear, torch_linear_init

PORTED_MODES = ("compress", "glob_only", "expr_only")


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
        if self.mode not in PORTED_MODES:
            raise NotImplementedError(f"deformation mode {self.mode!r} is not ported")

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
    return params


def conditioning(params, cfg: DeformationConfig, lat, anchors, *,
                 training: bool = False, gen=None, noise=None):
    """Row-constant trunk conditioning [B, cfg.lat_dim] from lat [B, D].

    In compress mode at train time the compressed code gets N(0, 1) *
    ``noise_scale``: ``noise`` [B, lat_dim_id] when given, else drawn from
    ``gen``."""
    B = lat.shape[0]
    E = cfg.lat_dim_expr
    z_ex = lat[..., -E:]
    if cfg.mode == "glob_only":
        return torch.cat([lat[..., : cfg.lat_dim_glob_shape], z_ex], dim=-1)
    if cfg.mode == "expr_only":
        return z_ex
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
    """Offsets for xyz [B, N, 3] under lat [B, lat_dim_shape_full + lat_dim_expr].

    Returns (delta [B, N, 3], extra [B, N, 1]) like the JAX package.
    """
    cond = conditioning(params, cfg, lat, anchors, training=training, gen=gen, noise=noise)
    pred = apply_deepsdf(params["trunk"], cfg.trunk_cfg, xyz, cond)
    return pred[..., :3], pred[..., -1:]
