"""Uniform decoder handles (counterpart of ``nphm_tpu/models/decoders.py``).

    decoder.apply(params, xyz, lat, **kw) -> (pred, anchors_or_None)

``lat`` is [B, lat_dim], constant along the point axis.  ``init`` takes a
``torch.Generator`` and a device (default ``utils.params.default_device()``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np

from nphm_tpu_torch.models.deepsdf import DeepSDFConfig, apply_deepsdf, init_deepsdf
from nphm_tpu_torch.models.deformation import (
    DeformationConfig,
    apply_deformation,
    init_deformation,
)
from nphm_tpu_torch.models.ensemble import NPHMConfig, apply_nphm, init_nphm


@dataclasses.dataclass(frozen=True)
class Decoder:
    kind: str
    cfg: Any
    init: Callable
    apply: Callable
    lat_dim: int
    lat_dim_glob: Optional[int] = None
    lat_dim_loc: Optional[int] = None
    n_symm_pairs: Optional[int] = None
    n_loc: Optional[int] = None


def make_npm_decoder(cfg: DeepSDFConfig) -> Decoder:
    """Global DeepSDF identity/expression decoder (the NPM family)."""

    def apply(params, xyz, lat, **_):
        return apply_deepsdf(params, cfg, xyz, lat), None

    return Decoder(
        kind="npm",
        cfg=cfg,
        init=lambda gen, device=None: init_deepsdf(gen, cfg, device),
        apply=apply,
        lat_dim=cfg.lat_dim,
    )


def make_nphm_decoder(cfg: NPHMConfig, mean_anchors) -> Decoder:
    """Anchored local-MLP ensemble identity decoder (the NPHM family)."""
    mean_anchors = np.asarray(mean_anchors, np.float32).reshape(cfg.n_loc, 3)

    def apply(params, xyz, lat, *, training=False, **_):
        return apply_nphm(params, cfg, xyz, lat, training=training)

    return Decoder(
        kind="nphm",
        cfg=cfg,
        init=lambda gen, device=None: init_nphm(gen, cfg, mean_anchors, device),
        apply=apply,
        lat_dim=cfg.lat_dim,
        lat_dim_glob=cfg.lat_dim_glob,
        lat_dim_loc=cfg.lat_dim_loc,
        n_symm_pairs=cfg.n_symm_pairs,
        n_loc=cfg.n_loc,
    )


def make_deformation_decoder(cfg: DeformationConfig) -> Decoder:
    """Forward deformation field; returns the offset head only."""

    def apply(params, xyz, lat, anchors=None, *, training=False, gen=None, noise=None, **_):
        delta, _extra = apply_deformation(
            params, cfg, xyz, lat, anchors, training=training, gen=gen, noise=noise
        )
        return delta, None

    return Decoder(
        kind="deformation",
        cfg=cfg,
        init=lambda gen, device=None: init_deformation(gen, cfg, device),
        apply=apply,
        lat_dim=cfg.lat_dim_expr,
    )
