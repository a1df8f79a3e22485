"""Identity-supervision data prep: surface samples with normals per subject
(counterpart of ``scripts/data_processing/sample_surface.py``, same flags):

    python -m nphm_tpu_torch.data_processing.sample_surface \\
        [--n_samples 25000000] [--n_samples_off 1000000] [--n_workers 10] [--subjects S ...]

Per subject (a worker pool), sample ``--n_samples`` points with interpolated
normals on the raw neutral scan (area-weighted barycentric), cut below the
throat plane, label face / non-face by nearest-neighbour distance (< 5/25)
to the masked registration vertices, and save ``NUM_SPLITS`` chunk files
``{expr}_{i}_{face,non_face}.npy``.  Each subject draws from
``default_rng(subject)``, so the output does not depend on the pool.  The
pool starts by ``spawn``: a worker imports only numpy, scipy and the data
modules, never torch.
"""

import argparse
import functools
import multiprocessing
import os
import traceback

import numpy as np
from scipy.spatial import cKDTree as KDTree

from nphm_tpu_torch import env_paths
from nphm_tpu_torch.data.manager import DataManager
from nphm_tpu_torch.data.sampling import sample_mesh_surface

FACE_DIST_THRESHOLD = 5.0 / 25.0


def sample_fields(n_samps, n_samps_off, s, e, face_mask, rng):
    manager = DataManager()
    mesh = manager.get_raw_mesh(s, e)
    regi = manager.get_registration_mesh(s, e)

    surf_points, surf_normals = sample_mesh_surface(mesh, n_samps, rng)

    above = manager.cut_throat(surf_points, s, e)
    surf_points = surf_points[above, :]
    surf_normals = surf_normals[above, :]

    # face region: proximity to the masked registration vertices
    d_region, _ = KDTree(regi.vertices[face_mask, :]).query(surf_points)
    face_region = d_region < FACE_DIST_THRESHOLD

    n_off = min(n_samps_off, int((~face_region).sum()))
    rnd_idx_non_face = rng.integers(0, max((~face_region).sum(), 1), n_off)
    return {
        "face": {"points": surf_points[face_region, :],
                 "normals": surf_normals[face_region, :]},
        "non_face": {"points": surf_points[~face_region, :][rnd_idx_non_face, :],
                     "normals": surf_normals[~face_region, :][rnd_idx_non_face, :]},
    }


def run_subject(s, n_samples: int, n_samples_off: int):
    manager = DataManager()
    rng = np.random.default_rng(s)
    face_mask = np.load(os.path.join(env_paths.ASSETS, "face.npy"))
    e = manager.get_neutral_expression(subject=s, neutral_type="open")
    if e is None:
        return
    if os.path.exists(manager.get_train_path_identity_face(
            s, e, rnd_file=env_paths.NUM_SPLITS - 1)):
        print("SKIPPING:", s, e)
        return
    try:
        print(s, e)
        results = sample_fields(n_samples, n_samples_off, s, e, face_mask, rng)
        data_face = np.concatenate(
            [results["face"]["points"], results["face"]["normals"]], axis=1
        ).astype(np.float32)
        data_non_face = np.concatenate(
            [results["non_face"]["points"], results["non_face"]["normals"]], axis=1
        ).astype(np.float32)

        os.makedirs(manager.get_train_dir_identity(s), exist_ok=True)
        for i, chunk in enumerate(np.array_split(data_face, env_paths.NUM_SPLITS, axis=0)):
            np.save(manager.get_train_path_identity_face(s, e, rnd_file=i), chunk)
        for i, chunk in enumerate(np.array_split(data_non_face, env_paths.NUM_SPLITS, axis=0)):
            np.save(manager.get_train_path_identity_non_face(s, e, rnd_file=i), chunk)
    except Exception:  # one bad scan must not stop the pool, as in the reference
        print("EXCEPTION", s, e)
        print(traceback.format_exc())


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--n_samples", type=int, default=25_000_000)
    parser.add_argument("--n_samples_off", type=int, default=1_000_000)
    parser.add_argument("--n_workers", type=int, default=10)
    parser.add_argument("--subjects", type=int, nargs="*", default=None)
    args = parser.parse_args(argv)

    manager = DataManager()
    subjects = args.subjects or manager.get_all_subjects()
    print(f"FOUND {len(subjects)} subjects!")
    os.makedirs(env_paths.SUPERVISION_IDENTITY, exist_ok=True)

    work = functools.partial(run_subject, n_samples=args.n_samples,
                             n_samples_off=args.n_samples_off)
    if args.n_workers <= 1:
        for s in subjects:
            work(s)
    else:
        with multiprocessing.get_context("spawn").Pool(args.n_workers) as p:
            p.map(work, subjects)


if __name__ == "__main__":
    main()
