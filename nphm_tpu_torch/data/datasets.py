"""Training datasets over the preprocessed supervision chunks (counterpart
of ``nphm_tpu/data/datasets.py``).

Behavioural spec: reference ``src/NPHM/data/face_dataset.py``:

- ``IdentityDataset`` == ScannerData (:21-141): one item per train subject
  (its neutral expression); a random 1-of-NUM_SPLITS surface chunk pair
  (face / non_face), ``n_face`` face and ``n_non // 5`` non-face points with
  normals, ``n_face // 8`` uniform-ball far points and Gaussian-perturbed
  near points (sigma_near), the gt anchors and the auto-decoder row index.
  A bad file is retried with another random index.
- ``DeformationDataset`` == ScannerDeformatioData (:144-243): one item per
  (subject, expression) scan; a random correspondence chunk, NaN rows
  filtered, ``n_supervision_points`` (neutral, posed) pairs.

Items load in a thread pool and batches are prefetched one step ahead; each
item draws from its own generator, seeded from the batch seed, so a batch is
the same whichever thread loads it, and byte-equal to the JAX package's for
the same seed and files.  Shapes are static.
"""

from __future__ import annotations

import concurrent.futures as futures
import traceback
from typing import Dict, Iterator, Optional

import numpy as np

from nphm_tpu_torch import env_paths
from nphm_tpu_torch.data.manager import DataManager
from nphm_tpu_torch.data.sampling import uniform_ball


class _BatchedDataset:
    """Shared batching/prefetch machinery. Subclasses implement _load_item."""

    batch_size: int = 32
    n_threads: int = 8

    def __len__(self):
        raise NotImplementedError

    def _load_item(self, idx: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def batch_iter(
        self, seed: int = 0, shuffle: bool = True, drop_remainder: bool = False
    ) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(seed)
        order = np.arange(len(self))
        if shuffle:
            rng.shuffle(order)
        bs = self.batch_size
        batches = [order[i : i + bs] for i in range(0, len(order), bs)]
        if drop_remainder:
            batches = [b for b in batches if len(b) == bs]
        if not batches:
            return

        pool = futures.ThreadPoolExecutor(self.n_threads)

        def assemble(idx_batch, batch_seed):
            seeds = np.random.SeedSequence(batch_seed).spawn(len(idx_batch))
            items = list(
                pool.map(
                    lambda a: self._load_item(a[0], np.random.default_rng(a[1])),
                    zip(idx_batch, seeds),
                )
            )
            return {
                k: np.stack([it[k] for it in items]) for k in items[0]
            }

        try:
            nxt = pool.submit(assemble, batches[0], rng.integers(2**31))
            for i in range(len(batches)):
                cur = nxt.result()
                if i + 1 < len(batches):
                    nxt = pool.submit(assemble, batches[i + 1], rng.integers(2**31))
                yield cur
        finally:
            pool.shutdown(wait=False)


class IdentityDataset(_BatchedDataset):
    def __init__(self, mode: str, n_supervision_points_face: int,
                 n_supervision_points_non_face: int, batch_size: int, sigma_near: float,
                 has_anchors: bool = True, is_closed: bool = False,
                 manager: Optional[DataManager] = None):
        self.manager = manager or DataManager()
        self.mode = mode
        self.batch_size = batch_size
        self.n_face = n_supervision_points_face
        self.n_non_face = n_supervision_points_non_face
        self.sigma_near = sigma_near
        self.has_anchors = has_anchors
        self.neutral_type = "closed" if is_closed else "open"
        self.neutral_expr_index = env_paths.neutrals_closed if is_closed else env_paths.neutrals
        if mode == "train":
            self.subjects = self.manager.get_train_subjects(self.neutral_type)
        else:
            self.subjects = self.manager.get_eval_subjects(self.neutral_type)
        self.subject_steps = list(self.subjects)
        self.gt_anchors = {}
        if has_anchors:
            for iden in self.subject_steps:
                self.gt_anchors[iden] = self.manager.get_facial_anchors(
                    subject=iden, expression=self.neutral_expr_index[iden])

    def __len__(self):
        return len(self.subject_steps)

    def _load_item(self, idx: int, rng: np.random.Generator):
        iden = self.subject_steps[idx]
        expr = self.neutral_expr_index[iden]
        try:
            on_face = np.load(self.manager.get_train_path_identity_face(
                iden, expr, rnd_file=int(rng.integers(env_paths.NUM_SPLITS))))
            non_face = np.load(self.manager.get_train_path_identity_non_face(
                iden, expr, rnd_file=int(rng.integers(env_paths.NUM_SPLITS))))
            sup_idx = rng.integers(0, on_face.shape[0], self.n_face)
            sup_points = on_face[sup_idx, :3]
            sup_normals = on_face[sup_idx, 3:6]
            sup_idx_non = rng.integers(0, non_face.shape[0], self.n_non_face // 5)
            sup_points_non = non_face[sup_idx_non, :3]
            sup_normals_non = non_face[sup_idx_non, 3:6]
        except Exception:
            print(f"SUBJECT: {iden} EXPRESSION: {expr}")
            traceback.print_exc()
            return self._load_item(int(rng.integers(len(self))), rng)

        sup_grad_far = uniform_ball(self.n_face // 8, rad=0.5, rng=rng)
        near_base = np.concatenate([sup_points, sup_points_non], axis=0)
        sup_grad_near = near_base + rng.normal(size=near_base.shape) * self.sigma_near
        item = {
            "points_face": sup_points.astype(np.float32),
            "normals_face": sup_normals.astype(np.float32),
            "points_non_face": sup_points_non.astype(np.float32),
            "normals_non_face": sup_normals_non.astype(np.float32),
            "sup_grad_far": sup_grad_far.astype(np.float32),
            "sup_grad_near": sup_grad_near.astype(np.float32),
            "idx": np.array([idx], np.int32),
        }
        if self.has_anchors:
            item["gt_anchors"] = np.asarray(self.gt_anchors[iden], np.float32)
        return item


class DeformationDataset(_BatchedDataset):
    def __init__(self, mode: str, n_supervision_points: int, batch_size: int,
                 manager: Optional[DataManager] = None):
        self.manager = manager or DataManager()
        self.mode = mode
        self.batch_size = batch_size
        self.n_points = n_supervision_points
        self.neutral_expr_index = env_paths.neutrals
        if mode == "train":
            self.subjects = self.manager.get_train_subjects(neutral_type="open")
        else:
            self.subjects = self.manager.get_eval_subjects(neutral_type="open")
        self.subject_steps = []  # subject id per scan
        self.steps = []  # expression id per scan
        self.subject_index = []  # auto-decoder identity row per scan
        for i, s in enumerate(self.subjects):
            expressions = self.manager.get_expressions(s)
            self.subject_steps += len(expressions) * [s]
            self.subject_index += len(expressions) * [i]
            self.steps += expressions
        self.anchors = {
            iden: self.manager.get_facial_anchors(subject=iden,
                                                  expression=self.neutral_expr_index[iden])
            for iden in self.subjects
        }

    def __len__(self):
        return len(self.steps)

    def _load_item(self, idx: int, rng: np.random.Generator):
        expr = self.steps[idx]
        iden = self.subject_steps[idx]
        try:
            corresp = np.load(self.manager.get_train_path_deformation(
                iden, expr, rnd_file=int(rng.integers(env_paths.NUM_SPLITS_EXPR))))
            valid = ~np.any(np.isnan(corresp), axis=-1)
            corresp = corresp[valid, :].astype(np.float32)
        except Exception:
            print(f"FAILED {iden} {expr}")
            return self._load_item(0, rng)
        sup_idx = rng.integers(0, corresp.shape[0], self.n_points)
        return {
            "points_neutral": corresp[sup_idx, :3],
            "points_posed": corresp[sup_idx, 3:],
            "idx": np.array([idx], np.int32),
            "iden": np.array([self.subjects.index(iden)], np.int32),
            "expr": np.array([expr], np.int32),
            "subj_ind": np.array([self.subject_index[idx]], np.int32),
            "gt_anchors": np.asarray(self.anchors[iden], np.float32),
        }
