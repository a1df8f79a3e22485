"""Synthetic analytic datasets (ellipsoid "heads"; counterpart of
``nphm_tpu/data/synthetic.py``).

``SyntheticIdentityDataset`` batches carry the schema of ``IdentityDataset``,
``SyntheticDeformationDataset`` (per-scan affine warps of those heads) the
schema of ``DeformationDataset``.  For the same seeds both are bit-identical
to the JAX package's: the same numpy draws in the same order.  They serve
the port's accuracy gates, ``synthetic_e2e`` and its smoke run without the
real (license-gated) NPHM dataset.
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


class SyntheticDeformationDataset(_BatchedDataset):
    """Per-(subject, expression) affine warps with correspondence batches."""

    def __init__(
        self,
        identity: SyntheticIdentityDataset,
        n_expressions: int = 3,
        n_points: int = 500,
        batch_size: int = 4,
        seed: int = 1,
        warp_scale: float = 0.05,
    ):
        rng = np.random.default_rng(seed)
        self.identity = identity
        self.batch_size = batch_size
        self.n_points = n_points
        n_sub = len(identity)
        self.subject_steps, self.steps, self.subject_index = [], [], []
        for i in range(n_sub):
            for e in range(n_expressions):
                self.subject_steps.append(i)
                self.steps.append(e)
                self.subject_index.append(i)
        self.neutral_expr_index = {i: 0 for i in range(n_sub)}
        # expression warp: small translation + anisotropic scale per scan
        self.t = (rng.normal(size=(len(self.steps), 3)) * warp_scale).astype(
            np.float32
        )
        self.a = (rng.normal(size=(len(self.steps), 3)) * warp_scale).astype(
            np.float32
        )

    def __len__(self):
        return len(self.steps)

    def warp(self, scan_idx: int, pts: np.ndarray) -> np.ndarray:
        return pts * (1 + self.a[scan_idx]) + self.t[scan_idx]

    def _load_item(self, idx: int, rng: np.random.Generator):
        subj = self.subject_steps[idx]
        radii = self.identity.radii[subj]
        center = self.identity.centers[subj]
        neutral, _ = _ellipsoid_surface(radii, center, self.n_points, rng)
        posed = self.warp(idx, neutral)
        item = {
            "points_neutral": neutral.astype(np.float32),
            "points_posed": posed.astype(np.float32),
            "idx": np.array([idx], np.int32),
            "iden": np.array([subj], np.int32),
            "expr": np.array([self.steps[idx]], np.int32),
            "subj_ind": np.array([self.subject_index[idx]], np.int32),
        }
        if self.identity.n_anchors:
            item["gt_anchors"] = self.identity.anchors_of(subj).astype(np.float32)
        return item
