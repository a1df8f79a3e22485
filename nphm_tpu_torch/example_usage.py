"""Dataset tour (counterpart of ``scripts/dataset/example_usage.py``, same
flags and printed lines; reference ``scripts/dataset/example_usage.py``):

    python -m nphm_tpu_torch.example_usage [--dummy_path ROOT] [--export_dir DIR]

Iterates subjects and expressions of the configured dataset (the
``NPHM_*`` environment variables, or a dummy tree at ``--dummy_path``),
loads the raw scan, FLAME fit and registration meshes, extracts landmarks
and anchors, applies the throat cut and loads single-view observations,
printing summary statistics (and with ``--export_dir`` writing each scan as
PLY and its anchors as ``.npy``) instead of opening viewer windows.  Host
only.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from nphm_tpu_torch.data.manager import DataManager


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dummy_path", type=str, default=None)
    parser.add_argument("--export_dir", type=str, default=None)
    parser.add_argument("--max_subjects", type=int, default=3)
    args = parser.parse_args(argv)

    manager = DataManager(dummy_path=args.dummy_path)
    subjects = manager.get_all_subjects()[: args.max_subjects]
    print(f"dataset has subjects: {subjects}")

    for subject in subjects:
        expressions = manager.get_expressions(subject)
        print(f"subject {subject}: expressions {expressions}")
        for expression in expressions[:2]:
            scan = manager.get_raw_mesh(subject, expression)
            flame = manager.get_flame_mesh(subject, expression)
            regi = manager.get_registration_mesh(subject, expression)
            lms = manager.get_landmarks(subject, expression)
            anchors = manager.get_facial_anchors(subject, expression)
            print(f"  expr {expression}: scan {len(scan.vertices)}v, "
                  f"flame {len(flame.vertices)}v, regi {len(regi.vertices)}v, "
                  f"landmarks {lms.shape}, anchors {anchors.shape}")

            try:
                obs = manager.get_single_view_obs(subject, expression)
                print(f"    single-view obs: {obs.shape}")
            except FileNotFoundError:
                print("    no single-view obs")

            above = manager.cut_throat(scan.vertices, subject, expression)
            print(f"    throat cut keeps {above.mean():.1%} of scan vertices")

            if args.export_dir:
                os.makedirs(args.export_dir, exist_ok=True)
                scan.export(os.path.join(args.export_dir, f"{subject}_{expression}_scan.ply"))
                np.save(os.path.join(args.export_dir, f"{subject}_{expression}_anchors.npy"),
                        anchors)


if __name__ == "__main__":
    main()
