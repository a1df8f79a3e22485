"""YAML config handling and model constructors (counterpart of ``nphm_tpu/config.py``).

Reads the same ``configs/*.yaml`` files as the JAX package.  Only the NPHM
family is ported: the NPM identity decoder and the NPM offsets network raise
``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import yaml

from nphm_tpu_torch import env_paths
from nphm_tpu_torch.models import (
    DeformationConfig,
    NPHMConfig,
    make_deformation_decoder,
    make_nphm_decoder,
)


def load_yaml(path: str) -> dict:
    with open(path, "r") as f:
        return yaml.safe_load(f)


def load_mean_anchors() -> np.ndarray:
    return np.load(env_paths.ANCHOR_MEAN_PATH).astype(np.float32)


def nphm_config_from_yaml(cfg_decoder: dict) -> NPHMConfig:
    """NPHMConfig from a YAML 'decoder' (or 'id_decoder') block."""
    return NPHMConfig(
        lat_dim_glob=cfg_decoder["decoder_lat_dim_glob"],
        lat_dim_loc=cfg_decoder["decoder_lat_dim_loc"],
        hidden_dim=cfg_decoder["decoder_hidden_dim"],
        n_loc=cfg_decoder["decoder_nloc"],
        n_symm_pairs=cfg_decoder["decoder_nsymm_pairs"],
        n_layers=cfg_decoder["decoder_nlayers"],
        pos_mlp_dim=cfg_decoder.get("pos_mlp_dim", 256),
    )


def deformation_config_from_yaml(cfg: dict, mode: str) -> DeformationConfig:
    """DeformationConfig from a full stage-2 config (ex_decoder + id_decoder)."""
    return DeformationConfig(
        mode=mode,
        lat_dim_expr=cfg["ex_decoder"]["decoder_lat_dim_expr"],
        lat_dim_id=cfg["ex_decoder"]["decoder_lat_dim_id"],
        lat_dim_glob_shape=cfg["id_decoder"]["decoder_lat_dim_glob"],
        lat_dim_loc_shape=cfg["id_decoder"]["decoder_lat_dim_loc"],
        n_loc=cfg["id_decoder"].get("decoder_nloc", 39),
        hidden_dim=cfg["ex_decoder"]["decoder_hidden_dim"],
        n_layers=cfg["ex_decoder"]["decoder_nlayers"],
        out_dim=3,
    )


def build_identity_decoder(cfg_decoder: dict, local: bool, mean_anchors=None):
    """NPHM identity decoder (local=True) from a YAML 'decoder' block.

    mean_anchors defaults to the dataset asset (``load_mean_anchors``).
    """
    if not local:
        raise NotImplementedError("the NPM identity decoder is not ported")
    if mean_anchors is None:
        mean_anchors = load_mean_anchors()
    return make_nphm_decoder(nphm_config_from_yaml(cfg_decoder), mean_anchors)


def build_expression_decoder(cfg: dict, mode: str):
    """Stage-2 expression decoder from a full config."""
    if mode == "npm":
        raise NotImplementedError("the NPM offsets network is not ported")
    return make_deformation_decoder(deformation_config_from_yaml(cfg, mode))


def fitting_overrides_from_cfg(cfg: dict):
    """Joint-fit (lambdas, schedule) overrides from a fitting YAML."""
    from nphm_tpu_torch.fitting.inference import default_joint_lambdas

    lambdas = cfg.get("lambdas") or cfg.get("lambdas_expr")
    if lambdas is not None:
        merged = default_joint_lambdas()
        unknown = set(lambdas) - set(merged)
        if unknown:
            raise ValueError(f"unknown fitting lambdas: {sorted(unknown)}")
        merged.update({k: float(v) for k, v in lambdas.items()})
        lambdas = merged

    schedule = cfg.get("schedule")
    if schedule is not None:
        schedule = {
            str(term): {int(step): float(div) for step, div in rows.items()}
            for term, rows in schedule.items()
        }
    return lambdas, schedule
