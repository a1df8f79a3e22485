"""Expression-supervision data prep: neutral <-> posed correspondence pairs
(counterpart of ``scripts/data_processing/sample_deformation_field.py``,
same flags):

    python -m nphm_tpu_torch.data_processing.sample_deformation_field \\
        [--n_samples 250000] [--n_workers 10] [--subjects S ...]

Exploits the shared registration topology: sample barycentric points on the
(face-region-cut) neutral registration mesh and evaluate the same
barycentric coordinates on the posed registration mesh to obtain exact
correspondences; add normal-offset noise at two scales (sigma 0.01 and
0.002), in both directions (neutral -> posed and posed -> neutral); shuffle
and save ``NUM_SPLITS_EXPR`` chunk files ``corresp_{i}.npy``.  Each subject
draws from ``default_rng(subject)``.  The pool starts by ``spawn``: a worker
imports only numpy and the data modules, never torch.
"""

import argparse
import functools
import multiprocessing
import os

import numpy as np

from nphm_tpu_torch import env_paths
from nphm_tpu_torch.data.manager import DataManager
from nphm_tpu_torch.data.sampling import barycentric_to_points, sample_mesh_surface
from nphm_tpu_torch.utils.mesh_io import load_mesh


def sample(m_neutral, m_posed, std, n_samps, rng):
    """Correspondences by barycentric transfer + normal-offset noise
    (reference sample_deformation_field.py:14-35)."""
    p_neutral, _normals, fidx, bary = sample_mesh_surface(m_neutral, n_samps, rng,
                                                          return_face_idx=True)
    offsets = (rng.normal(size=p_neutral.shape[0]) * std)[:, None]
    fn_neutral = m_neutral.face_normals[fidx]
    p_neutral = p_neutral + offsets * fn_neutral

    p_posed = barycentric_to_points(m_posed.vertices[m_posed.faces[fidx]], bary)
    fn_posed = m_posed.face_normals[fidx]
    p_posed = p_posed + offsets * fn_posed
    return p_neutral, p_posed, fn_neutral, fn_posed


def main_subject(s, n_samples: int):
    manager = DataManager()
    rng = np.random.default_rng(s)
    template = load_mesh(os.path.join(env_paths.ASSETS, "template_face_up.ply"))
    if template.vertex_colors is not None:
        valid_mask = template.vertex_colors[:, 0] == 255
    else:  # fall back to the face.npy mask
        valid_mask = np.load(os.path.join(env_paths.ASSETS, "face.npy"))

    expressions = manager.get_expressions(subject=s)
    n_expr = manager.get_neutral_expression(s, neutral_type="open")
    if n_expr is None:
        return
    m_neutral = manager.get_registration_mesh(subject=s, expression=n_expr)
    m_neutral = m_neutral.submesh_by_vertex_mask(valid_mask)

    for expression in expressions:
        if os.path.exists(manager.get_train_path_deformation(
                s, expression, rnd_file=env_paths.NUM_SPLITS_EXPR - 1)):
            print("skip", s, expression)
            continue
        m = manager.get_registration_mesh(subject=s, expression=expression)
        m = m.submesh_by_vertex_mask(valid_mask)

        pn1, pp1, _, _ = sample(m_neutral, m, 0.01, n_samples, rng)
        pn2r, pp2r, _, _ = sample(m, m_neutral, 0.01, n_samples, rng)  # reverse
        pn3, pp3, _, _ = sample(m_neutral, m, 0.002, n_samples, rng)
        pn4r, pp4r, _, _ = sample(m, m_neutral, 0.002, n_samples, rng)

        all_p_neutral = np.concatenate([pn1, pp2r, pn3, pp4r], axis=0)
        all_p = np.concatenate([pp1, pn2r, pp3, pn4r], axis=0)

        perm = rng.permutation(all_p.shape[0])
        data = np.concatenate([all_p_neutral[perm], all_p[perm]], axis=-1).astype(np.float32)
        if np.any(np.isnan(data)):
            print("NaNs encountered; skipping", s, expression)
            continue

        os.makedirs(manager.get_train_dir_deformation(s, expression), exist_ok=True)
        for i, chunk in enumerate(np.array_split(data, env_paths.NUM_SPLITS_EXPR, axis=0)):
            np.save(manager.get_train_path_deformation(s, expression, rnd_file=i), chunk)
        print("done", s, expression)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--n_samples", type=int, default=250_000)
    parser.add_argument("--n_workers", type=int, default=10)
    parser.add_argument("--subjects", type=int, nargs="*", default=None)
    args = parser.parse_args(argv)

    manager = DataManager()
    subjects = args.subjects or manager.get_all_subjects()
    print(f"FOUND {len(subjects)} subjects!")
    os.makedirs(env_paths.SUPERVISION_DEFORMATION_OPEN, exist_ok=True)

    work = functools.partial(main_subject, n_samples=args.n_samples)
    if args.n_workers <= 1:
        for s in subjects:
            work(s)
    else:
        with multiprocessing.get_context("spawn").Pool(args.n_workers) as p:
            p.map(work, subjects)


if __name__ == "__main__":
    main()
