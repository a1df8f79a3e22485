"""Weight bridge between the JAX package's parameter pytrees and this port.

Parameters are plain nested dicts/lists of tensors keyed exactly like the
JAX pytrees, e.g. ``{"ensemble": [{"w", "b"}, ...], "mlp_pos": [...],
"mean_anchors"}`` for the NPHM decoder and ``{"trunk": {"layers": [...]},
"compressor": {...}}`` for the deformation field.  A JAX pytree converted
leaf by leaf with ``np.asarray`` goes through ``from_numpy_pytree``;
``to_numpy_pytree`` is its inverse.  ``trainer_state_from_jax`` maps a JAX
identity trainer's whole state onto the port trainer's ``state_dict``.
"""

from __future__ import annotations

import numpy as np
import torch


def default_device() -> torch.device:
    """The device every entry point uses unless the caller names one: the GPU.

    There is no fallback to the CPU: without a GPU, torch's own error on the
    first CUDA allocation is the outcome.  Callers that mean the CPU pass
    ``device="cpu"``.
    """
    return torch.device("cuda")


def from_numpy_pytree(tree, device=None, dtype=torch.float32):
    """Nested dict/list/tuple of array-likes -> same structure of tensors
    on ``device`` (default ``default_device()``)."""
    if device is None:
        device = default_device()
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


def trainer_state_from_jax(state: dict) -> dict:
    """A JAX ``IdentityTrainer``'s state as numpy -> the port trainer's
    ``load_state_dict`` input.

    state: the JAX trainer's ``_state_tree()`` with every leaf converted by
    ``np.asarray`` (NamedTuples kept): params, the optax
    ``inject_hyperparams(adamw)`` state (its first inner state holds the
    Adam count and moments), latent tables and row-Adam states (step,
    exp_avg, exp_avg_sq).
    """
    adam = state["opt_state"].inner_state[0]

    def row(s):
        return {"step": np.asarray(s.step, np.int32), "exp_avg": np.asarray(s.exp_avg),
                "exp_avg_sq": np.asarray(s.exp_avg_sq)}

    return {
        "params": state["params"],
        "opt_state": {"count": np.asarray(adam.count, np.int32), "mu": adam.mu,
                      "nu": adam.nu},
        "latents": np.asarray(state["latents"]),
        "lat_state": row(state["lat_state"]),
        "latents_val": np.asarray(state["latents_val"]),
        "lat_state_val": row(state["lat_state_val"]),
    }
