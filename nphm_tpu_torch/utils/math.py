"""Small numeric helpers (counterpart of ``nphm_tpu/utils/math.py``)."""

from __future__ import annotations

import torch


def safe_l2norm(x, dim=-1, keepdim=False, eps: float = 1e-20):
    """L2 norm with a finite gradient at 0."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + eps)


def sq_norm(x, dim=-1, keepdim=False):
    """||x||^2 without the norm->square round trip."""
    return torch.sum(x * x, dim=dim, keepdim=keepdim)


def inv3x3(m, eps: float = 0.0):
    """Closed-form batched 3x3 inverse via the adjugate. m: [..., 3, 3]."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d

    det = a * A + b * D + c * G
    inv_det = 1.0 / (det + eps) if eps else 1.0 / det
    adj = torch.stack(
        [
            torch.stack([A, B, C], dim=-1),
            torch.stack([D, E, F], dim=-1),
            torch.stack([G, H, I], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]
