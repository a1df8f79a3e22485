"""Evaluation CLI (counterpart of ``scripts/evaluation/eval.py``, same flags
plus ``--device``):

    python -m nphm_tpu_torch.eval --result_dir FITTING_DIR/forward_EXP/TAG \
        [--num_samps 250000] [--subjects S ...] [--workers N] [--device cuda|cpu]

Per (test subject, valid expression): render-sample ``--num_samps``
visible-surface points on the GT raw scan and on the predicted mesh (10
fibonacci views, ``evaluation.render``), slice below the chin plane, split a
face region by proximity to the FLAME face vertices, cache the samples, and
write ``{result_dir}/evaluation/{s}/expression_{e}/metrics.json`` and
``metrics_face.json`` with Chamfer / normal-consistency / F-score in metric
millimeters.  The GT draws are cached under ``FITTING_DIR/GT``, both caches
keyed by ``num_samps``.  Each scan draws from its own rng,
``default_rng([seed, subject, expression])``.  Scans run in a thread pool
(``--workers``); the rasterizer's threads are split among them
(``NPHM_RASTER_THREADS``).  The nearest-neighbour queries run on the card
for large clouds (``--device``, default the card; ``cpu``: scipy only): the
pool's threads share its one context and keep their tensors to themselves.
"""

import argparse
import json
import os

import numpy as np
import torch
from scipy.spatial import cKDTree as KDTree

from nphm_tpu_torch import env_paths
from nphm_tpu_torch.data.manager import DataManager
from nphm_tpu_torch.evaluation.metrics import eval_pointcloud
from nphm_tpu_torch.evaluation.render import gen_render_samples
from nphm_tpu_torch.utils.mesh_io import load_mesh

NUM_SAMPS = 250000
# chin-plane spanning vertices of the FLAME template (eval.py:31-33)
CHIN_PLANE = (3276, 3207, 3310)


def _slice_indices(regi, surf_points, margin=0.003):
    """Indices of the points above the chin plane (reference eval.py:30-55),
    whose drawn rows alone are then gathered.  The plane test is one GEMV:
    dot(n, p - v1) = p.n - v1.n."""
    v1, v2, v3 = (regi.vertices[i, :].copy() for i in CHIN_PLANE)
    normal = np.cross(v2 - v1, v3 - v1)
    above = surf_points @ normal.astype(surf_points.dtype) > (
        float(normal @ v1) + margin
    )
    return np.flatnonzero(above)


def _face_valid(points, face_verts, face_normals, kdtree):
    """Reference face membership rule (eval.py:71-86): point-to-plane
    distance <= 0.02 at the nearest FLAME face vertex AND point distance
    <= 0.04 to it."""
    dist, nn_idx = kdtree.query(points)
    nn_vertices = face_verts[nn_idx, :]
    nn_normals = face_normals[nn_idx, :]
    p2plane = np.abs(np.sum((points - nn_vertices) * nn_normals, axis=-1))
    return (p2plane <= 0.02) & (dist <= 0.04)


def sample_surface_points(mesh, mesh_flame, face_idx, num_samps, rng):
    samps, samps_normals = gen_render_samples(mesh, 10)
    if len(samps) == 0:
        # Empty/invisible prediction (e.g. an untrained model whose SDF has
        # no zero crossing): score a far-away sentinel so the scan records
        # a terrible-but-finite metric instead of crashing the protocol
        # (the reference would crash here; gather.py-style skip semantics).
        print("WARNING: mesh rendered no samples; scoring a far sentinel")
        samps = np.full((1, 3), 1e3, np.float32)
        samps_normals = np.array([[1.0, 0.0, 0.0]], np.float32)
    keep = _slice_indices(mesh_flame, samps)
    if keep.size == 0:  # whole mesh below the chin plane: degenerate input
        print("WARNING: no samples above the chin plane; using all samples")
        keep = np.arange(len(samps))

    face_verts = np.asarray(mesh_flame.vertices[face_idx, :])
    face_normals = mesh_flame.vertex_normals[face_idx, :]
    kdtree = KDTree(face_verts)

    ri = keep[rng.integers(0, keep.shape[0], num_samps)]

    # Face subset by rejection sampling: a draw uniform over all samples,
    # accepted iff face-valid, is iid uniform over the face-valid population
    # — distribution-identical to the reference's label-everything-then-draw
    # (eval.py:71-91) but labels only ~num_samps/acceptance of the ~6M
    # rendered samples (measured: ~1.5 s vs ~9 s per mesh at 250k draws).
    sel_pts, sel_nrm = [], []
    got, labeled, cap = 0, 0, 3 * len(keep) + 10 * num_samps
    while got < num_samps and labeled < cap:
        batch = keep[rng.integers(0, keep.shape[0], 2 * num_samps)]
        labeled += len(batch)
        pts, nrm = samps[batch], samps_normals[batch]
        ok = _face_valid(pts, face_verts, face_normals, kdtree)
        sel_pts.append(pts[ok])
        sel_nrm.append(nrm[ok])
        got += int(ok.sum())
    if got == 0:
        # Degenerate mesh with (almost) no face-valid samples: fall back to
        # the reference's exhaustive labeling so behavior matches exactly.
        sl_pts, sl_nrm = samps[keep], samps_normals[keep]
        valids = _face_valid(sl_pts, face_verts, face_normals, kdtree)
        samps_face = sl_pts[valids, :]
        samps_normals_face = sl_nrm[valids, :]
        if samps_face.shape[0] == 0:
            # not a single face-valid sample (prediction nowhere near the
            # registration's face): score the face metric on the full
            # region rather than crashing (the reference raises here)
            print("WARNING: no face-valid samples; face metrics use the "
                  "full region")
            samps_face, samps_normals_face = sl_pts, sl_nrm
        rif = rng.integers(0, samps_face.shape[0], num_samps)
        return (
            samps[ri, :], samps_normals[ri, :],
            samps_face[rif, :], samps_normals_face[rif, :],
        )
    samps_face = np.concatenate(sel_pts)[:num_samps]
    samps_normals_face = np.concatenate(sel_nrm)[:num_samps]
    if len(samps_face) < num_samps:  # acceptance ~0: top up with replacement
        extra = rng.integers(0, len(samps_face), num_samps - len(samps_face))
        samps_face = np.concatenate([samps_face, samps_face[extra]])
        samps_normals_face = np.concatenate(
            [samps_normals_face, samps_normals_face[extra]]
        )
    return samps[ri, :], samps_normals[ri, :], samps_face, samps_normals_face


def face_region_indices():
    """Template vertices belonging to the face region: exact matches between
    the full template and the face-region template (reference eval.py:100-105)."""
    m_base = load_mesh(os.path.join(env_paths.ASSETS, "template.ply"))
    face_region = load_mesh(
        os.path.join(env_paths.ASSETS, "better_face_region.ply")
    )
    kdtree = KDTree(face_region.vertices)
    dist, _ = kdtree.query(m_base.vertices)
    return np.where(dist == 0)[0]


def _cached_samples(out_dir, mesh, m_flame, face_idx, num_samps, rng, resample):
    # caches at different draw counts coexist: the file names carry
    # num_samps, so a 25k and a 250k cache live side by side
    paths = [os.path.join(out_dir, f"{name}_{num_samps}.npy")
             for name in ("points", "normals", "points_face", "normals_face")]
    if not resample and all(os.path.exists(p) for p in paths):
        return tuple(np.load(p) for p in paths)
    out = sample_surface_points(mesh, m_flame, face_idx, num_samps, rng)
    os.makedirs(out_dir, exist_ok=True)
    for p, arr in zip(paths, out):
        np.save(p, arr)
    return out


def _eval_scan(manager, face_idx, args, eval_dir, subject, expression):
    """Render-sample + metrics for ONE (subject, expression) scan.

    Each scan draws from its OWN seeded rng (fold of --seed, subject,
    expression), so results are deterministic and independent of worker
    count / scan order — unlike a shared sequential stream."""
    fine = os.path.join(args.result_dir, f"{subject}_{expression}_fine.ply")
    pred_path = (
        fine
        if os.path.exists(fine)
        else os.path.join(args.result_dir, f"{subject}_{expression}.ply")
    )
    if not os.path.exists(pred_path):
        print(f"missing prediction {pred_path}; skipping")
        return
    out_dir_gt = os.path.join(
        env_paths.FITTING_DIR, "GT", str(subject), f"expression_{expression}"
    )
    out_dir = os.path.join(eval_dir, str(subject), f"expression_{expression}")
    os.makedirs(out_dir, exist_ok=True)
    if os.path.exists(os.path.join(out_dir, "metrics.json")):
        print("SKIPPING", subject, expression)
        return
    print("PROCESSING", subject, expression)
    rng = np.random.default_rng([args.seed, subject, expression])

    m_gt = manager.get_raw_mesh(subject, expression, "nphm")
    m_flame = manager.get_flame_mesh(subject, expression, "nphm")
    m_pred = load_mesh(pred_path)

    gt = _cached_samples(
        out_dir_gt, m_gt, m_flame, face_idx, args.num_samps, rng,
        args.resample,
    )
    pred = _cached_samples(
        out_dir, m_pred, m_flame, face_idx, args.num_samps, rng,
        args.resample,
    )

    metrics = eval_pointcloud(
        pred[0], gt[0], pred[1], gt[1],
        metric_space=True, subject=subject, expression=expression,
        nn_backend=args.nn_backend,
    )
    with open(os.path.join(out_dir, "metrics.json"), "w") as f:
        f.write(json.dumps(metrics, indent=4))

    metrics_face = eval_pointcloud(
        pred[2], gt[2], pred[3], gt[3],
        metric_space=True, subject=subject, expression=expression,
        nn_backend=args.nn_backend,
    )
    with open(os.path.join(out_dir, "metrics_face.json"), "w") as f:
        f.write(json.dumps(metrics_face, indent=4))
    print(
        f"  {subject}/{expression}: chamfer_l1={metrics['chamfer_l1']:.3f}mm "
        f"(face {metrics_face['chamfer_l1']:.3f}mm)"
    )


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--result_dir", required=True, type=str)
    parser.add_argument("--num_samps", type=int, default=NUM_SAMPS)
    parser.add_argument("--resample", action="store_true")
    parser.add_argument("--subjects", type=int, nargs="*", default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--workers", type=int, default=min(8, max(2, os.cpu_count() or 1)),
        help="scans evaluated concurrently (host threads; the rasterizer, "
        "KDTree queries, the card's queries and numpy reductions release the "
        "GIL).  1 = serial.",
    )
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="where the nearest-neighbour queries of large clouds run: cuda "
        "(default, the card) or cpu (scipy's cKDTree only)",
    )
    args = parser.parse_args(argv)
    if args.device == "cpu":
        args.nn_backend = "scipy"
    elif torch.device(args.device).type == "cuda" and torch.cuda.is_available():
        args.nn_backend = "auto"
    else:
        parser.error(f"--device {args.device}: no CUDA device here (pass --device cpu)")

    manager = DataManager()
    face_idx = face_region_indices()

    eval_dir = os.path.join(args.result_dir, "evaluation")
    os.makedirs(eval_dir, exist_ok=True)

    subjects = args.subjects or env_paths.subjects_test
    scans = [
        (subject, expression)
        for subject in subjects
        for expression in sorted(manager.get_expressions(subject, testing=True))
    ]
    if args.workers <= 1:
        for subject, expression in scans:
            _eval_scan(manager, face_idx, args, eval_dir, subject, expression)
    else:
        import concurrent.futures as cf

        # scan-level parallelism already saturates the cores: split the
        # rasterizer's internal worker threads across the scan workers
        # instead of oversubscribing workers x hardware_concurrency threads
        if "NPHM_RASTER_THREADS" not in os.environ:
            per = max(1, (os.cpu_count() or 1) // args.workers)
            os.environ["NPHM_RASTER_THREADS"] = str(per)

        with cf.ThreadPoolExecutor(max_workers=args.workers) as ex:
            futs = [
                ex.submit(
                    _eval_scan, manager, face_idx, args, eval_dir, s, e
                )
                for s, e in scans
            ]
            for f in futs:
                f.result()  # propagate failures


if __name__ == "__main__":
    main()
