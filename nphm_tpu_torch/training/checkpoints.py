"""Checkpointing (counterpart of ``nphm_tpu/training/checkpoints.py``).

Single-file checkpoints ``{exp}/checkpoints/checkpoint_epoch_N.pkl`` with
the epoch, decoder params, optimizer states and train + val latent tables,
latest-epoch discovery by file name, and ``val_min=EPOCH.npy`` marker files
(reference training.py:166-247).  The content is plain dicts, lists and
numpy arrays, so a checkpoint loads without torch.  Checkpoints are local
trusted artifacts (pickle, as the reference's torch.save).

``load_checkpoint`` also reads the JAX package's checkpoints without
importing ``jax``: the JAX trainer pickles its optimizer states as optax
NamedTuples, whose classes a plain ``pickle.load`` would import (and
optax imports jax).  Its unpickler resolves numpy, builtins and
``collections`` classes as usual and turns any other class into a plain
tuple of its fields; params and latent tables are numpy arrays either way.

Epoch numbering differs from the JAX package's: the port's
``IdentityTrainer`` writes ``checkpoint_epoch_N`` at the end of epoch N,
after validation (so ``latents_val`` holds epoch N's validation update),
and resumes at epoch N + 1.  The JAX trainer writes it before validation
and resumes at epoch N.  The files share a name and layout, but two
checkpoints of the same N do not hold the same state.
"""

from __future__ import annotations

import glob
import os
import pickle
import re

import numpy as np


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    if hasattr(tree, "detach"):
        return tree.detach().cpu().numpy()
    return tree


def checkpoint_path(checkpoint_dir: str, epoch: int) -> str:
    return os.path.join(checkpoint_dir, f"checkpoint_epoch_{epoch}.pkl")


def save_checkpoint(checkpoint_dir: str, epoch: int, tree) -> str:
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = checkpoint_path(checkpoint_dir, epoch)
    if not os.path.exists(path):
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump({"epoch": epoch, **_to_numpy(tree)}, f, protocol=4)
        os.replace(tmp, path)
    return path


def latest_checkpoint_epoch(checkpoint_dir: str):
    epochs = []
    for p in glob.glob(os.path.join(checkpoint_dir, "checkpoint_epoch_*.pkl")):
        m = re.search(r"checkpoint_epoch_(\d+)\.pkl$", p)
        if m:
            epochs.append(int(m.group(1)))
    return max(epochs) if epochs else None


class _Fields(tuple):
    """Stands in for a class the unpickler does not import: built with the
    pickled fields, it returns them as a plain tuple."""

    def __new__(cls, *fields, **_):
        return tuple(fields)


class _Unpickler(pickle.Unpickler):
    _ADMIT = ("numpy", "builtins", "collections")

    def find_class(self, module, name):
        if module.split(".")[0] in self._ADMIT:
            return super().find_class(module, name)
        return _Fields


def load_checkpoint(checkpoint_dir: str, epoch=None):
    """The checkpoint dict of ``epoch`` (None = latest), or None if none
    exists.  Classes other than numpy's, builtins and ``collections``' (the
    JAX trainer's optax states) come back as plain tuples of their fields,
    positional, without their names: a JAX-written checkpoint's ``params``
    and latent tables load, but ``IdentityTrainer`` does not resume from
    its optimizer state."""
    if epoch is None:
        epoch = latest_checkpoint_epoch(checkpoint_dir)
        if epoch is None:
            return None
    with open(checkpoint_path(checkpoint_dir, epoch), "rb") as f:
        return _Unpickler(f).load()


def update_val_min(exp_path: str, epoch: int, val_loss: float):
    """Keep one best-val marker file (reference training.py:166-173)."""
    for p in glob.glob(os.path.join(exp_path, "val_min=*")):
        os.remove(p)
    np.save(os.path.join(exp_path, f"val_min={epoch}.npy"), [epoch, val_loss])


def read_val_min(exp_path: str):
    files = glob.glob(os.path.join(exp_path, "val_min=*"))
    if not files:
        return None
    arr = np.load(files[0])
    return int(arr[0]), float(arr[1])
