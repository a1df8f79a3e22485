"""Global conditioned DeepSDF trunk (counterpart of ``nphm_tpu/models/deepsdf.py``).

The latent code is constant along the point axis at every call site, so its
input-layer and skip-layer contributions are folded into per-row biases
instead of concatenating ``[B, N, lat_dim]`` onto every point.
"""

from __future__ import annotations

import dataclasses

import torch

from nphm_tpu_torch.models.mlp import (
    geometric_last_layer_init,
    linear,
    mlp_dims,
    positional_encoding,
    softplus_beta,
    torch_linear_init,
)

SQRT2 = 1.4142135623730951


@dataclasses.dataclass(frozen=True)
class DeepSDFConfig:
    lat_dim: int
    hidden_dim: int
    n_layers: int = 8
    geometric_init: bool = True
    radius_init: float = 1.0
    beta: float = 100.0
    out_dim: int = 1
    num_freq_bands: int | None = None
    input_dim: int = 3

    @property
    def d_in_spatial(self) -> int:
        if self.num_freq_bands is None:
            return self.input_dim
        return self.input_dim * (2 * self.num_freq_bands + 1)

    @property
    def d_in(self) -> int:
        return self.lat_dim + self.d_in_spatial

    @property
    def layer_shapes(self):
        return mlp_dims(self.d_in, self.hidden_dim, self.n_layers, self.out_dim)


def init_deepsdf(gen: torch.Generator, cfg: DeepSDFConfig, device="cpu"):
    shapes, _skip = cfg.layer_shapes
    n = len(shapes)
    layers = []
    for i, (d_in, d_out) in enumerate(shapes):
        if cfg.geometric_init and i == n - 1:
            layers.append(
                geometric_last_layer_init(gen, d_in, d_out, cfg.radius_init, device)
            )
        else:
            layers.append(torch_linear_init(gen, d_in, d_out, device))
    return {"layers": layers}


def _mm(x, w):
    """x [..., i] @ w[o, i]^T."""
    return torch.matmul(x, w.transpose(0, 1))


def _trunk(params, cfg: DeepSDFConfig, pe, lat):
    """Shared trunk with the latent columns folded into per-row biases.

    pe:  [..., N, d_spatial] point features; lat: [..., 1 or N, lat_dim].
    """
    _shapes, skip_in = cfg.layer_shapes
    layers = params["layers"]
    n = len(layers)
    ds = cfg.d_in_spatial

    x = pe
    for i in range(n):
        w, b = layers[i]["w"], layers[i]["b"]
        if i == 0:
            x = _mm(pe, w[:, :ds]) + _mm(lat, w[:, ds:]) + b
        elif i == skip_in:
            h = w.shape[1] - cfg.d_in
            x = (
                _mm(x, w[:, :h]) + _mm(pe, w[:, h : h + ds]) + _mm(lat, w[:, h + ds :])
            ) / SQRT2 + b
        else:
            x = linear(layers[i], x)
        if i < n - 1:
            x = softplus_beta(x, cfg.beta) if cfg.beta > 0 else torch.relu(x)
    return x


def apply_deepsdf(params, cfg: DeepSDFConfig, xyz, lat):
    """xyz: [..., N, input_dim]; lat: [..., lat_dim] or [..., N, lat_dim]."""
    pe = positional_encoding(xyz, cfg.num_freq_bands)
    if lat.dim() == xyz.dim() - 1:
        lat = lat[..., None, :]
    return _trunk(params, cfg, pe, lat)
