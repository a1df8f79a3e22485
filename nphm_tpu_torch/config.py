"""YAML config handling and model constructors (counterpart of ``nphm_tpu/config.py``).

Reads the same ``configs/*.yaml`` files as the JAX package and builds both
model families: the NPHM ensemble with its deformation field, and the NPM
global DeepSDF identity decoder with its DeepSDF offsets network.  An
experiment's config is snapshotted on its first run and reloaded on every
later one (``snapshot_or_reload_config``, reference
scripts/training/train.py:33-43).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import yaml

from nphm_tpu_torch import env_paths
from nphm_tpu_torch.models import (
    DeepSDFConfig,
    DeformationConfig,
    NPHMConfig,
    make_deformation_decoder,
    make_nphm_decoder,
    make_npm_decoder,
)


def load_yaml(path: str) -> dict:
    with open(path, "r") as f:
        return yaml.safe_load(f)


def snapshot_or_reload_config(exp_dir: str, cfg: Optional[dict]) -> dict:
    """First run of an experiment: write ``cfg`` to ``{exp_dir}/configs.yaml``.
    Later runs: reload that file and ignore ``cfg``."""
    fname = os.path.join(exp_dir, "configs.yaml")
    if not os.path.exists(fname):
        if cfg is None:
            raise ValueError("a new experiment needs a config file (-cfg_file)")
        os.makedirs(exp_dir, exist_ok=True)
        with open(fname, "w") as f:
            yaml.safe_dump(cfg, f, default_flow_style=False)
        print(f"Snapshotted config to {fname}")
        return cfg
    print(f"Loading config snapshot from {fname}")
    return load_yaml(fname)


def print_cfg(cfg: dict, title: str = ""):
    if title:
        print(f"#### {title} ####")
    print(json.dumps(cfg, sort_keys=True, indent=4))


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
    """NPHM (local=True) or NPM identity decoder from a YAML 'decoder' (or
    'id_decoder') block.

    mean_anchors (NPHM only) defaults to the dataset asset
    (``load_mean_anchors``).
    """
    if not local:
        return make_npm_decoder(DeepSDFConfig(
            lat_dim=cfg_decoder["decoder_lat_dim"],
            hidden_dim=cfg_decoder["decoder_hidden_dim"],
            n_layers=cfg_decoder.get("decoder_nlayers", 8),
            geometric_init=True,
            out_dim=1,
        ))
    if mean_anchors is None:
        mean_anchors = load_mean_anchors()
    return make_nphm_decoder(nphm_config_from_yaml(cfg_decoder), mean_anchors)


def build_expression_decoder(cfg: dict, mode: str):
    """Stage-2 expression decoder from a full config.

    mode == "npm" selects the NPM family's global DeepSDF offsets network
    over ``[z_id, z_ex]`` (kind ``deformation_npm``); its ``lat_dim`` is the
    expression width and its ``apply`` ignores anchors.
    """
    if mode == "npm":
        base = make_npm_decoder(DeepSDFConfig(
            lat_dim=cfg["id_decoder"]["decoder_lat_dim"]
            + cfg["ex_decoder"]["decoder_lat_dim"],
            hidden_dim=cfg["ex_decoder"].get("decoder_hidden_dim", 1024),
            n_layers=cfg["ex_decoder"].get("decoder_nlayers", 8),
            geometric_init=False,
            out_dim=3,
        ))

        def apply(params, xyz, lat, anchors=None, **_):
            return base.apply(params, xyz, lat)

        return dataclasses.replace(base, kind="deformation_npm", apply=apply,
                                   lat_dim=cfg["ex_decoder"]["decoder_lat_dim"])
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
