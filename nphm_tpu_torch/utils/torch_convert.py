"""Reference-checkpoint conversion (counterpart of
``nphm_tpu/utils/torch_convert.py``).

Maps state dicts of the PyTorch reference implementation onto the port's
parameter trees (keyed like the JAX package's pytrees; leaves are float32
tensors) and back:

- NPHM ensemble (``FastEnsembleDeepSDFMirrored``, reference
  EnsembledDeepSDF.py:153): ``ensembled_deep_sdf.lin{i}.{weight,bias}``
  of shapes ``[n_distinct, out, in]`` / ``[n_distinct, out]`` (the same
  storage layout: symmetric members first, one slot per pair) and
  ``mlp_pos.{0,2,4}.{weight,bias}``.
- NPM / expression DeepSDF (deepSDF.py:6): ``lin{i}.{weight,bias}``.
- DeformationNetwork (deepSDF.py:118): the trunk under ``defDeepSDF.lin{i}.*``
  plus the compress mode's ``compressor.0.*`` (the port has no GNN mode).
- Trainer checkpoints (training.py:190-201): ``decoder_state_dict`` and
  ``latent_codes[_val]_state_dict`` (``Embedding.weight`` tables).

Values may be numpy arrays or CPU tensors.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from nphm_tpu_torch.models.deepsdf import DeepSDFConfig
from nphm_tpu_torch.models.deformation import DeformationConfig
from nphm_tpu_torch.models.ensemble import NPHMConfig


def _np(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float32)


def _t(v) -> torch.Tensor:
    return torch.tensor(_np(v))


def _linear(sd: Mapping, prefix: str) -> Dict:
    return {"w": _t(sd[f"{prefix}.weight"]), "b": _t(sd[f"{prefix}.bias"])}


def load_torch_checkpoint(path: str) -> Dict:
    """A reference trainer checkpoint ``.tar`` as plain dicts of numpy arrays."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    out = {"epoch": int(ckpt.get("epoch", 0))}
    if "decoder_state_dict" in ckpt:
        out["decoder_state_dict"] = {k: _np(v) for k, v in ckpt["decoder_state_dict"].items()}
    for key in ("latent_codes_state_dict", "latent_codes_val_state_dict"):
        if key in ckpt:
            out[key] = {k: _np(v) for k, v in ckpt[key].items()}
    return out


def latent_table_from_state_dict(sd: Mapping) -> torch.Tensor:
    """``Embedding.weight`` -> [n_rows, lat_dim] table."""
    return _t(sd["weight"])


def nphm_params_from_state_dict(sd: Mapping, cfg: NPHMConfig, mean_anchors) -> Dict:
    """FastEnsembleDeepSDFMirrored state dict -> the port's parameter tree.

    mean_anchors: [n_loc, 3] (the reference keeps them as a plain attribute
    loaded from assets/anchors_39.npy, outside the state dict).
    """
    shapes, _ = cfg.layer_shapes
    ensemble = []
    for i in range(len(shapes)):
        w = _np(sd[f"ensembled_deep_sdf.lin{i}.weight"])
        b = _np(sd[f"ensembled_deep_sdf.lin{i}.bias"])
        expect_w = (cfg.n_distinct, shapes[i][1], shapes[i][0])
        if w.shape != expect_w:
            raise ValueError(f"lin{i}.weight has shape {w.shape}, config expects {expect_w}")
        ensemble.append({"w": torch.tensor(w), "b": torch.tensor(b)})
    return {
        "ensemble": ensemble,
        "mlp_pos": [_linear(sd, f"mlp_pos.{j}") for j in (0, 2, 4)],
        "mean_anchors": torch.tensor(_np(mean_anchors).reshape(cfg.n_loc, 3)),
    }


def deepsdf_params_from_state_dict(sd: Mapping, cfg: DeepSDFConfig, prefix: str = "") -> Dict:
    """DeepSDF state dict (``lin{i}.*``) -> the port's parameter tree."""
    shapes, _ = cfg.layer_shapes
    layers = []
    for i in range(len(shapes)):
        lin = _linear(sd, f"{prefix}lin{i}")
        expect = (shapes[i][1], shapes[i][0])
        if tuple(lin["w"].shape) != expect:
            raise ValueError(f"{prefix}lin{i}.weight has shape {tuple(lin['w'].shape)}, "
                             f"config expects {expect}")
        layers.append(lin)
    return {"layers": layers}


def deformation_params_from_state_dict(sd: Mapping, cfg: DeformationConfig) -> Dict:
    """DeformationNetwork state dict -> the port's parameter tree."""
    params = {"trunk": deepsdf_params_from_state_dict(sd, cfg.trunk_cfg,
                                                      prefix="defDeepSDF.")}
    if cfg.mode == "compress":
        params["compressor"] = _linear(sd, "compressor.0")
    return params


def nphm_state_dict_from_params(params) -> Dict[str, np.ndarray]:
    """The inverse mapping (port -> reference layout), for round trips and export."""
    sd = {}
    for i, lin in enumerate(params["ensemble"]):
        sd[f"ensembled_deep_sdf.lin{i}.weight"] = _np(lin["w"])
        sd[f"ensembled_deep_sdf.lin{i}.bias"] = _np(lin["b"])
    for j, lin in zip((0, 2, 4), params["mlp_pos"]):
        sd[f"mlp_pos.{j}.weight"] = _np(lin["w"])
        sd[f"mlp_pos.{j}.bias"] = _np(lin["b"])
    return sd


def deepsdf_state_dict_from_params(params, prefix: str = "") -> Dict[str, np.ndarray]:
    sd = {}
    for i, lin in enumerate(params["layers"]):
        sd[f"{prefix}lin{i}.weight"] = _np(lin["w"])
        sd[f"{prefix}lin{i}.bias"] = _np(lin["b"])
    return sd


def deformation_state_dict_from_params(params) -> Dict[str, np.ndarray]:
    sd = deepsdf_state_dict_from_params(params["trunk"], prefix="defDeepSDF.")
    if "compressor" in params:
        sd["compressor.0.weight"] = _np(params["compressor"]["w"])
        sd["compressor.0.bias"] = _np(params["compressor"]["b"])
    return sd
