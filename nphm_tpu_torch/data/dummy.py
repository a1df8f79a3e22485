"""Synthetic warps for dummy observations (the part of
``nphm_tpu/data/dummy.py`` the port uses)."""

from __future__ import annotations

import numpy as np


def _nonrigid_warp(rng, n_bumps: int = 3, strength: float = 0.06):
    """A smooth, invertible, spatially-varying displacement field.

    Sum of ``n_bumps`` Gaussian bumps plus a small rigid translation.  The
    displacement-gradient bound is ~strength/sigma_min < 0.4 so the warp is
    a diffeomorphism (Broyden's posed->canonical search is well-posed), yet
    genuinely non-rigid: relative point distances change.
    """
    centers = rng.uniform(-0.3, 0.3, size=(n_bumps, 3))
    dirs = rng.normal(size=(n_bumps, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    amps = rng.uniform(0.5, 1.0, size=n_bumps) * strength
    sigmas = rng.uniform(0.18, 0.30, size=n_bumps)
    t = rng.normal(size=3) * 0.02

    def warp(pts: np.ndarray) -> np.ndarray:
        out = pts + t
        for k in range(n_bumps):
            w = np.exp(
                -((pts - centers[k]) ** 2).sum(-1) / (2.0 * sigmas[k] ** 2)
            )
            out = out + (amps[k] * w)[:, None] * dirs[k]
        return out.astype(np.float32)

    return warp
