"""Geometry sampling on the host (counterpart of
``nphm_tpu/data/sampling.py``): ``uniform_ball`` draws points uniformly in a
ball by inverse-CDF radius sampling (reference data/utils.py:7-19);
``sample_mesh_surface`` draws area-weighted surface points with interpolated
vertex normals; ``points_to_barycentric`` / ``barycentric_to_points`` carry
points between meshes of one topology (reference
sample_deformation_field.py:14-35).
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


def sample_barycentric(n: int, rng=None) -> np.ndarray:
    """Uniform barycentric coordinates on a triangle."""
    rng = rng or np.random.default_rng()
    r1 = np.sqrt(rng.uniform(size=n))
    r2 = rng.uniform(size=n)
    return np.stack([1 - r1, r1 * (1 - r2), r1 * r2], axis=-1)


def sample_mesh_surface(mesh, n_samples: int, rng=None, return_face_idx=False):
    """Area-weighted random surface samples with interpolated vertex normals.

    Returns (points [n,3], normals [n,3][, face_idx [n], bary [n,3]]).
    """
    rng = rng or np.random.default_rng()
    areas = mesh.face_areas
    face_idx = rng.choice(len(areas), size=n_samples, p=areas / areas.sum())
    bary = sample_barycentric(n_samples, rng)
    points = np.einsum("nk,nkd->nd", bary, mesh.vertices[mesh.faces[face_idx]])
    normals = np.einsum("nk,nkd->nd", bary, mesh.vertex_normals[mesh.faces[face_idx]])
    normals /= np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True), 1e-20)
    if return_face_idx:
        return points.astype(np.float32), normals.astype(np.float32), face_idx, bary
    return points.astype(np.float32), normals.astype(np.float32)


def points_to_barycentric(triangles: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Barycentric coordinates of points w.r.t. their triangles ([n,3,3], [n,3])."""
    a, b, c = triangles[:, 0], triangles[:, 1], triangles[:, 2]
    v0, v1, v2 = b - a, c - a, points - a
    d00 = np.einsum("nd,nd->n", v0, v0)
    d01 = np.einsum("nd,nd->n", v0, v1)
    d11 = np.einsum("nd,nd->n", v1, v1)
    d20 = np.einsum("nd,nd->n", v2, v0)
    d21 = np.einsum("nd,nd->n", v2, v1)
    denom = np.maximum(d00 * d11 - d01 * d01, 1e-20)
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    u = 1.0 - v - w
    return np.stack([u, v, w], axis=-1)


def barycentric_to_points(triangles: np.ndarray, bary: np.ndarray) -> np.ndarray:
    return np.einsum("nk,nkd->nd", bary, triangles)
