"""Geometry sampling on the host (the part of ``nphm_tpu/data/sampling.py``
the synthetic datasets use): ``uniform_ball`` draws points uniformly in a
ball by inverse-CDF radius sampling (reference data/utils.py:7-19).
"""

from __future__ import annotations

import numpy as np


def uniform_ball(n_points: int, rad: float = 1.0, rng=None) -> np.ndarray:
    rng = rng or np.random.default_rng()
    angle1 = rng.uniform(-1, 1, n_points)
    angle2 = rng.uniform(0, 1, n_points)
    radius = rng.uniform(0, rad, n_points)
    r = radius ** (1 / 3)
    theta = np.arccos(angle1)
    phi = 2 * np.pi * angle2
    return np.stack(
        [
            r * np.sin(theta) * np.cos(phi),
            r * np.sin(theta) * np.sin(phi),
            r * np.cos(theta),
        ],
        axis=-1,
    )
