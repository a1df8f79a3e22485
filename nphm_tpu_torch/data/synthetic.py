"""Synthetic analytic identity dataset (ellipsoid "heads"; the identity part
of ``nphm_tpu/data/synthetic.py``).

Batches carry the schema of ``IdentityDataset``, and for the same seed they
are bit-identical to the JAX package's: the same numpy draws in the same
order.  They serve the port's tests and its smoke run without the real
(license-gated) NPHM dataset.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from nphm_tpu_torch.data.datasets import _BatchedDataset
from nphm_tpu_torch.data.sampling import uniform_ball


def _ellipsoid_surface(radii, center, n, rng):
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pts = d * radii + center
    # exact normals of the ellipsoid: grad of ((x-c)/r)^2
    normals = 2 * (pts - center) / np.asarray(radii) ** 2
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    return pts.astype(np.float32), normals.astype(np.float32)


class SyntheticIdentityDataset(_BatchedDataset):
    """Per-subject ellipsoids with identity-SDF supervision batches."""

    def __init__(
        self,
        n_subjects: int = 8,
        n_face: int = 250,
        n_non_face: int = 250,
        batch_size: int = 4,
        sigma_near: float = 0.01,
        n_anchors: Optional[int] = None,
        seed: int = 0,
        radius_range=(0.35, 0.55),
    ):
        rng = np.random.default_rng(seed)
        self.batch_size = batch_size
        self.n_face = n_face
        self.n_non_face = n_non_face
        self.sigma_near = sigma_near
        self.n_anchors = n_anchors
        self.radii = rng.uniform(*radius_range, size=(n_subjects, 3)).astype(
            np.float32
        )
        self.centers = (rng.uniform(-0.05, 0.05, size=(n_subjects, 3))).astype(
            np.float32
        )
        self.subject_steps = list(range(n_subjects))
        self.neutral_expr_index = {i: 0 for i in range(n_subjects)}
        if n_anchors:
            dirs = rng.normal(size=(n_anchors, 3))
            self.anchor_dirs = (
                dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
            ).astype(np.float32)

    def __len__(self):
        return len(self.subject_steps)

    def anchors_of(self, idx: int) -> np.ndarray:
        return self.anchor_dirs * self.radii[idx] + self.centers[idx]

    def _load_item(self, idx: int, rng: np.random.Generator):
        radii, center = self.radii[idx], self.centers[idx]
        pf, nf = _ellipsoid_surface(radii, center, self.n_face, rng)
        pn, nn = _ellipsoid_surface(radii, center, self.n_non_face // 5, rng)
        far = uniform_ball(self.n_face // 8, rad=0.5, rng=rng).astype(np.float32)
        near_base = np.concatenate([pf, pn], axis=0)
        near = (
            near_base + rng.normal(size=near_base.shape) * self.sigma_near
        ).astype(np.float32)
        item = {
            "points_face": pf,
            "normals_face": nf,
            "points_non_face": pn,
            "normals_non_face": nn,
            "sup_grad_far": far,
            "sup_grad_near": near,
            "idx": np.array([idx], np.int32),
        }
        if self.n_anchors:
            item["gt_anchors"] = self.anchors_of(idx).astype(np.float32)
        return item
