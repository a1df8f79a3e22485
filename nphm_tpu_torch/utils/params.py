"""Weight bridge between the JAX package's parameter pytrees and this port.

Parameters are plain nested dicts/lists of tensors keyed exactly like the
JAX pytrees, e.g. ``{"ensemble": [{"w", "b"}, ...], "mlp_pos": [...],
"mean_anchors"}`` for the NPHM decoder and ``{"trunk": {"layers": [...]},
"compressor": {...}}`` for the deformation field.  A JAX pytree converted
leaf by leaf with ``np.asarray`` goes through ``from_numpy_pytree``;
``to_numpy_pytree`` is its inverse.
"""

from __future__ import annotations

import numpy as np
import torch


def from_numpy_pytree(tree, device="cpu", dtype=torch.float32):
    """Nested dict/list/tuple of array-likes -> same structure of tensors."""
    if isinstance(tree, dict):
        return {k: from_numpy_pytree(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy_pytree(v, device, dtype) for v in tree)
    return torch.tensor(np.asarray(tree), dtype=dtype, device=device)


def to_numpy_pytree(tree):
    """Inverse of ``from_numpy_pytree``: tensors -> float32 numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy_pytree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy_pytree(v) for v in tree)
    return tree.detach().cpu().numpy()


def tree_device(tree):
    """Device of the first tensor leaf of a parameter tree."""
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree.device


def tree_to(tree, device):
    """Move every tensor leaf of a parameter tree to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree.to(device)
