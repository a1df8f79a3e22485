"""Generate single-view test observations (counterpart of
``scripts/data_processing/generate_single_view_observations.py``, same
flags):

    python -m nphm_tpu_torch.data_processing.generate_single_view_observations \\
        [--n_points 2500] [--subjects S ...] [--seed 0]

Per test subject and valid expression, place a random frontal camera on a
filtered fibonacci sphere (plus one fixed back view per subject, its first
expression), render the raw scan with the host rasterizer, back-project the
depth map to 3D points, cut below the throat plane, subsample ``--n_points``
points, and save ``obs(_back).npy`` + ``full_obs(_back).npy``.  One rng,
``default_rng(seed)``, drawn in the JAX script's order.
"""

import argparse
import os

import numpy as np

from nphm_tpu_torch import env_paths
from nphm_tpu_torch.data.manager import DataManager
from nphm_tpu_torch.evaluation.render import fibonacci_sphere, look_at, rasterize


def render_obs(mesh, eye, res=1000, f=1500.0, znear=0.2, zfar=5.0):
    K = np.array([[f, 0.0, res // 2], [0.0, f, res // 2], [0.0, 0.0, 1.0]], np.float32)
    E = look_at(eye, np.zeros(3), np.array([0, 1, 0]))
    out = rasterize(mesh, K, E, rend_size=(res, res), znear=znear, zfar=zfar)
    return out["points"][out["mask"]]


def process(manager, subject, expression, render_back, rng, n_points):
    mesh = manager.get_raw_mesh(subject, expression)
    # the reference renders in FLAME scale (mesh / 4) with eye * 4: net
    # effect, the camera at |eye| ~ 0.65 * 4 in nphm units
    if render_back:
        angle = np.pi
        eye = np.array([np.sin(angle), 0, np.cos(angle)]) * 0.65
        eye[1] += 0.4
    else:
        eyes = np.array(fibonacci_sphere(1000))
        eyes = eyes[(eyes[:, 2] > 0.6) & (eyes[:, 2] < 0.9)
                    & (eyes[:, 1] < 0.55) & (eyes[:, 1] > -0.55)]
        eye = eyes[rng.integers(0, len(eyes))] * 0.65

    points = render_obs(mesh, eye * 4.0)

    os.makedirs(manager.get_single_view_dir(subject, expression), exist_ok=True)
    np.save(manager.get_single_view_path(subject, expression, full_depth_map=True,
                                         is_back=render_back), points.astype(np.float32))

    above = manager.cut_throat(points, subject, expression)
    points = points[above, :]
    rnd_idx = rng.integers(0, points.shape[0], n_points)
    np.save(manager.get_single_view_path(subject, expression, full_depth_map=False,
                                         is_back=render_back),
            points[rnd_idx, :].astype(np.float32))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--n_points", type=int, default=2500)
    parser.add_argument("--subjects", type=int, nargs="*", default=None)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    manager = DataManager()
    rng = np.random.default_rng(args.seed)
    subjects = args.subjects or env_paths.subjects_test

    for render_back in (False, True):
        for subject in subjects:
            expressions = manager.get_expressions(subject, testing=True)
            if render_back:
                expressions = expressions[:1]
            for expression in expressions:
                process(manager, subject, expression, render_back, rng, args.n_points)
                print("obs done:", subject, expression, "back" if render_back else "front")


if __name__ == "__main__":
    main()
