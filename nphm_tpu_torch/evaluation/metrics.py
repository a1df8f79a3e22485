"""Point-cloud reconstruction metrics (counterpart of
``nphm_tpu/evaluation/metrics.py``).

Behavioral spec: reference ``src/NPHM/evaluation/metrics.py:46-206``
(eval_pointcloud / distance_p2p / get_threshold_percentage): bidirectional
nearest-neighbor distances -> completeness/accuracy, Chamfer-L1/L2, absolute-
dot normal consistency, and F-scores at {1, 5, 10, 20} mm thresholds, with an
optional rescale to metric millimeters via the stored per-scan 1/s transform.
Everything is float64 numpy on the host but the nearest-neighbour queries,
which run on the card for large problems (``evaluation/nn.py``, brute force
with an exact re-rank) and through scipy's cKDTree otherwise.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from nphm_tpu_torch.data.manager import DataManager
from nphm_tpu_torch.data.sampling import sample_mesh_surface
from nphm_tpu_torch.evaluation.nn import nearest_neighbors


def distance_p2p(
    pointcloud_pred, pointcloud_gt, normals_pred, normals_gt, backend="auto"
):
    """Minimal distances from each pred point to the gt cloud (+ |n.n'|)."""
    dist, idx = nearest_neighbors(pointcloud_pred, pointcloud_gt, backend)
    if normals_pred is None:
        return dist, None
    normals_pred = normals_pred / np.linalg.norm(
        normals_pred, axis=-1, keepdims=True
    )
    normals_gt = normals_gt / np.linalg.norm(normals_gt, axis=-1, keepdims=True)
    dot = (normals_gt[idx] * normals_pred).sum(axis=-1)
    return dist, np.abs(dot)


def get_threshold_percentage(dist, thresholds):
    return [(dist <= t).mean() for t in thresholds]


def eval_pointcloud(
    pointcloud_pred,
    pointcloud_gt,
    normals_pred=None,
    normals_gt=None,
    return_error_pcs: bool = False,
    metric_space: bool = True,
    subject: Optional[int] = None,
    expression: Optional[int] = None,
    scale_to_metric: Optional[float] = None,
    nn_backend: str = "auto",
):
    """Bidirectional point-cloud metrics.

    metric_space=True rescales both clouds to millimeters using the stored
    per-scan similarity transform (1/s); pass ``scale_to_metric`` directly or
    (subject, expression) to look it up via the DataManager.
    """
    if not metric_space:
        thresholds = [0.005, 0.01, 0.015, 0.02]
    else:
        thresholds = [1, 5, 10, 20]  # millimeters

    pointcloud_pred = np.asarray(pointcloud_pred, np.float64)
    pointcloud_gt = np.asarray(pointcloud_gt, np.float64)

    if metric_space:
        if scale_to_metric is None:
            tr = DataManager().get_transform_from_metric(subject, expression)
            scale_to_metric = float(1.0 / tr["s"])
        pointcloud_pred = pointcloud_pred * scale_to_metric
        pointcloud_gt = pointcloud_gt * scale_to_metric

    completeness, completeness_normals = distance_p2p(
        pointcloud_gt, pointcloud_pred, normals_gt, normals_pred, nn_backend
    )
    recall = get_threshold_percentage(completeness, thresholds)
    completeness_pc = completeness
    completeness_pc_normals = completeness_normals
    completeness2 = (completeness**2).mean()
    completeness_m = completeness.mean()

    accuracy, accuracy_normals = distance_p2p(
        pointcloud_pred, pointcloud_gt, normals_pred, normals_gt, nn_backend
    )
    precision = get_threshold_percentage(accuracy, thresholds)
    accuracy_pc = accuracy
    accuracy_pc_normals = accuracy_normals
    accuracy2 = (accuracy**2).mean()
    accuracy_m = accuracy.mean()

    chamfer_l2 = 0.5 * completeness2 + 0.5 * accuracy2
    chamfer_l1 = 0.5 * (completeness_m + accuracy_m)

    F = [
        2 * precision[i] * recall[i] / (precision[i] + recall[i])
        if (precision[i] + recall[i]) > 0
        else 0.0
        for i in range(len(precision))
    ]

    if normals_pred is not None:
        acc_n = accuracy_normals.mean()
        comp_n = completeness_normals.mean()
        normals_correctness = 0.5 * comp_n + 0.5 * acc_n
    else:
        acc_n = comp_n = normals_correctness = np.nan

    out = {
        "completeness": completeness_m,
        "accuracy": accuracy_m,
        "normals completeness": comp_n,
        "normals accuracy": acc_n,
        "normals consistency": normals_correctness,
        "completeness2": completeness2,
        "accuracy2": accuracy2,
        "chamfer_l2": chamfer_l2,
        "chamfer_l1": chamfer_l1,
        "f_score_05": F[0],  # 1mm in metric space
        "f_score_10": F[1],  # 5mm
        "f_score_15": F[2],  # 10mm
        "f_score_20": F[3],  # 20mm
    }
    out = {k: float(v) for k, v in out.items()}  # JSON-serializable
    if return_error_pcs:
        return out, {
            "completeness": completeness_pc,
            "accuracy": accuracy_pc,
            "completeness_normals": completeness_pc_normals,
            "accuracy_normals": accuracy_pc_normals,
        }
    return out


def eval_viz_uni_chamfer(
    pointcloud_pred, pointcloud_gt, normals_pred=None, normals_gt=None
):
    """Unidirectional pred->gt distances for error visualization
    (reference evaluation/metrics.py:148-168): per-point accuracy distance
    and |n.n'| similarity, keyed for viz consumers."""
    pointcloud_pred = np.asarray(pointcloud_pred)
    pointcloud_gt = np.asarray(pointcloud_gt)
    accuracy, accuracy_normals = distance_p2p(
        pointcloud_pred, pointcloud_gt, normals_pred, normals_gt
    )
    if normals_gt is None:
        accuracy_normals = np.nan
    return {"dist_pred2gt": accuracy, "nsim_pred2gt": accuracy_normals}


def eval_mesh_onet(
    mesh_pred,
    gt_mesh,
    n_points: int = 100000,
    remove_wall: bool = False,
    include_cdists_for_viz: bool = False,
    rng=None,
):
    """Occupancy-networks-style mesh evaluation
    (reference evaluation/metrics.py:7-43 ``eval_meshOnet``): sample both
    surfaces with face normals, optionally crop predicted points to the GT
    bounding volume ("remove walls/floor"), then run ``eval_pointcloud`` in
    raw (non-metric) space.  Meshes are ``utils.mesh_io.Mesh``-compatible
    (vertices/faces/face_normals).
    """
    rng = np.random.default_rng(rng)
    pointcloud_gt, _, gt_idx, _ = sample_mesh_surface(
        gt_mesh, 2 * n_points, rng=rng, return_face_idx=True
    )
    normals_gt = gt_mesh.face_normals[gt_idx]

    if remove_wall:
        pointcloud_pred, _, idx, _ = sample_mesh_surface(
            mesh_pred, 2 * n_points, rng=rng, return_face_idx=True
        )
        eps = 0.007
        lo = pointcloud_gt.min(axis=0) - eps
        hi = pointcloud_gt.max(axis=0) + eps
        mask = (
            (pointcloud_pred[:, 0] <= hi[0])
            & (pointcloud_pred[:, 0] >= lo[0])
            & (pointcloud_pred[:, 1] >= lo[1])  # floor only (keep ceiling)
            & (pointcloud_pred[:, 2] <= hi[2])
            & (pointcloud_pred[:, 2] >= lo[2])
        )
        kept = pointcloud_pred[mask]
        sel = rng.integers(0, kept.shape[0], size=n_points)
        pointcloud_pred = kept[sel]
        idx = idx[mask][sel]
    else:
        pointcloud_pred, _, idx, _ = sample_mesh_surface(
            mesh_pred, n_points, rng=rng, return_face_idx=True
        )
    pointcloud_pred = pointcloud_pred.astype(np.float32)
    normals_pred = mesh_pred.face_normals[idx]

    out = eval_pointcloud(
        pointcloud_pred, pointcloud_gt, normals_pred, normals_gt,
        metric_space=False,
    )
    if include_cdists_for_viz:
        out.update(
            eval_viz_uni_chamfer(
                mesh_pred.vertices, pointcloud_gt,
                mesh_pred.vertex_normals, normals_gt,
            )
        )
    return out
