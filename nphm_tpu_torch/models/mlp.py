"""Shared MLP building blocks (counterpart of ``nphm_tpu/models/mlp.py``).

Decoders are plain functions over dicts of tensors.  Initializers draw from
an explicit ``torch.Generator`` (on the CPU, then move to ``device``) with
the distributions of the JAX package: U(+-1/sqrt(fan_in)) for every Linear
and the DeepSDF geometric init for a sphere-SDF last layer.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _uniform(gen, shape, bound, device):
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return ((u * 2.0 - 1.0) * bound).to(device)


def torch_linear_init(gen, in_features: int, out_features: int, device="cpu"):
    """U(+-1/sqrt(fan_in)) weight [out, in] and bias [out]."""
    bound = 1.0 / math.sqrt(in_features) if in_features > 0 else 0.0
    w = _uniform(gen, (out_features, in_features), bound, device)
    b = _uniform(gen, (out_features,), bound, device)
    return {"w": w, "b": b}


def geometric_last_layer_init(gen, in_features: int, out_features: int,
                              radius: float, device="cpu"):
    """DeepSDF geometric init: W ~ sqrt(pi/fan_in) + 1e-5 N(0,1), b = -radius."""
    noise = torch.randn((out_features, in_features), generator=gen)
    w = (math.sqrt(math.pi / in_features) + 1e-5 * noise).to(device)
    b = torch.full((out_features,), -radius, device=device)
    return {"w": w, "b": b}


def linear(params, x):
    """y = x @ W^T + b over the last axis."""
    return torch.matmul(x, params["w"].transpose(0, 1)) + params["b"]


def softplus_beta(x, beta: float = 100.0, threshold: float = 20.0):
    """Softplus(beta*x)/beta, linear where beta*x > threshold (torch's rule)."""
    return F.softplus(x, beta=beta, threshold=threshold)


def mlp_dims(d_in: int, hidden: int, n_layers: int, d_out: int):
    """Per-layer (in, out) dims of a DeepSDF-style trunk with one skip."""
    dims = [d_in] + [hidden] * n_layers + [d_out]
    skip_in = n_layers // 2
    shapes = []
    for layer in range(len(dims) - 1):
        out_d = dims[layer + 1] - d_in if layer + 1 == skip_in else dims[layer + 1]
        shapes.append((dims[layer], out_d))
    return shapes, skip_in


def positional_encoding(xyz, num_freq_bands: int | None):
    """[x, sin(2^k x), cos(2^k x)] band embedding (optional)."""
    if num_freq_bands is None:
        return xyz
    embeds = [xyz]
    for k in range(num_freq_bands):
        f = 2.0**k
        embeds.append(torch.sin(xyz * f))
        embeds.append(torch.cos(xyz * f))
    return torch.cat(embeds, dim=-1)
