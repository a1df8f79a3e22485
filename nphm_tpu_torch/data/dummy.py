"""Synthetic dummy-dataset generator (counterpart of ``nphm_tpu/data/dummy.py``).

Generates, from analytic ellipsoid "heads", the directory tree the
fitting CLI's ``-demo`` reads, so it runs without the license-gated NPHM
dataset:

    {root}/dataset/{subject}/{expression}/(scan|flame|registration).ply + s,R,t
    {root}/single_view/{subject}/{expression}/obs.npy (+obs_back.npy)
    {root}/supervision_identity/{subject}/{expr}_{i}_(face|non_face).npy
    {root}/supervision_deformation/{subject}/{expr}/corresp_{i}.npy
    {root}/neutrals_open.json, neutrals_closed.json
    {root}/assets/anchors_39.npy, lm_inds_39.npy, template and face meshes

The seeded draws follow the JAX package's generator one for one.  The
ellipsoids are extracted by the port's host marching library, which emits
the same surface as the JAX package's but lists its vertices in another
order, so the two trees hold the same arrays only where the surfaces'
listing does not enter.
"""

from __future__ import annotations

import json
import os

import numpy as np

from nphm_tpu_torch.data.sampling import sample_mesh_surface
from nphm_tpu_torch.ops.marching import marching_tets
from nphm_tpu_torch.utils.mesh_io import Mesh, write_ply

# enough vertices to index the registration topology's landmark and anchor lists
_MIN_VERTS = 3900


def _grid_points(minimum, maximum, res: int) -> np.ndarray:
    """[res^3, 3] 'ij' grid over a box, x-major."""
    axes = [np.linspace(minimum[i], maximum[i], res, dtype=np.float32) for i in range(3)]
    X, Y, Z = np.meshgrid(*axes, indexing="ij")
    return np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)


def _ellipsoid_mesh(radii, center, res=56) -> Mesh:
    pts = _grid_points([-1, -1, -1], [1, 1, 1], res)
    sdf = np.linalg.norm((pts - center) / radii, axis=-1) - 1.0
    v, f = marching_tets((-sdf).reshape(res, res, res), 0.0)
    v = v * (2.0 / (res - 1)) - 1.0
    mesh = Mesh(v.astype(np.float32), f.astype(np.int64))
    assert len(mesh.vertices) >= _MIN_VERTS, len(mesh.vertices)
    return mesh


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


def _expression_warp(rng, e: int, expression_mode: str):
    if expression_mode == "translate":
        # e == 0 still consumes its draw, as the JAX package's generator does
        t = rng.normal(size=3) * (0.0 if e == 0 else 0.04)
        return lambda p: (p + t).astype(np.float32)
    if expression_mode != "nonrigid":
        raise ValueError(f"unknown expression_mode {expression_mode!r}")
    if e == 0:
        return lambda p: np.asarray(p, np.float32)
    return _nonrigid_warp(rng)


def _write_assets(root: str, rng) -> Mesh:
    """Anchors, landmark indices and the template meshes; returns the
    template, whose topology every flame and registration mesh shares."""
    assets = os.path.join(root, "assets")
    os.makedirs(assets, exist_ok=True)
    anchor_dirs = rng.normal(size=(39, 3))
    anchor_dirs /= np.linalg.norm(anchor_dirs, axis=-1, keepdims=True)
    np.save(os.path.join(assets, "anchors_39.npy"), anchor_dirs * 0.4)
    np.save(os.path.join(assets, "lm_inds_39.npy"), np.arange(39))
    template = _ellipsoid_mesh(np.array([0.42, 0.42, 0.42]), np.zeros(3))
    write_ply(os.path.join(assets, "template.ply"), template.vertices, template.faces)
    face = template.vertices[:, 2] > 0.0
    face_sub = template.submesh_by_vertex_mask(face)
    write_ply(os.path.join(assets, "better_face_region.ply"), face_sub.vertices,
              face_sub.faces)
    np.save(os.path.join(assets, "face.npy"), face)
    write_ply(
        os.path.join(assets, "template_face_up.ply"), template.vertices, template.faces,
        colors=np.where(face[:, None], np.array([[255, 0, 0, 255]], np.uint8),
                        np.array([[0, 0, 0, 255]], np.uint8)),
    )
    return template


def _write_splits(directory: str, pattern: str, data: np.ndarray, num_splits: int):
    for i, chunk in enumerate(np.array_split(data, num_splits)):
        np.save(os.path.join(directory, pattern.format(i)), chunk.astype(np.float32))


def generate_dummy_data(
    root: str,
    subjects=(351, 365),
    n_expressions: int = 2,
    n_supervision: int = 20000,
    num_splits: int = 2,
    seed: int = 0,
    expression_mode: str = "translate",
):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for name in ("neutrals_open.json", "neutrals_closed.json"):
        with open(os.path.join(root, name), "w") as f:
            json.dump({str(s): 0 for s in subjects}, f)
    template = _write_assets(root, rng)

    for s in subjects:
        radii = rng.uniform(0.35, 0.5, size=3)
        center = rng.uniform(-0.03, 0.03, size=3)
        neutral_mesh = _ellipsoid_mesh(radii, center)
        # registration and flame meshes: the template scaled to the subject
        reg_neutral = Mesh((template.vertices / 0.42 * radii + center).astype(np.float32),
                           template.faces)
        for e in range(n_expressions):
            scan_dir = os.path.join(root, "dataset", f"{s:03d}", f"{e:03d}")
            os.makedirs(scan_dir, exist_ok=True)
            warp = _expression_warp(rng, e, expression_mode)
            mesh = Mesh(warp(neutral_mesh.vertices), neutral_mesh.faces)
            reg = Mesh(warp(reg_neutral.vertices), reg_neutral.faces)
            write_ply(os.path.join(scan_dir, "scan.ply"), mesh.vertices, mesh.faces)
            for name in ("flame.ply", "registration.ply"):
                write_ply(os.path.join(scan_dir, name), reg.vertices, reg.faces)
            np.save(os.path.join(scan_dir, "s.npy"), np.float64(1.0 / 25.0))
            np.save(os.path.join(scan_dir, "R.npy"), np.eye(3))
            np.save(os.path.join(scan_dir, "t.npy"), np.zeros(3))

            # single-view observations: surface points of one hemisphere
            pts, _normals = sample_mesh_surface(mesh, 6000, rng)
            sv_dir = os.path.join(root, "single_view", f"{s:03d}", f"{e}")
            os.makedirs(sv_dir, exist_ok=True)
            np.save(os.path.join(sv_dir, "obs.npy"),
                    pts[pts[:, 2] > 0][:2500].astype(np.float32))
            np.save(os.path.join(sv_dir, "obs_back.npy"),
                    pts[pts[:, 2] <= 0][:2500].astype(np.float32))

            sup_dir = os.path.join(root, "supervision_identity", f"{s:03d}")
            os.makedirs(sup_dir, exist_ok=True)
            pts_s, nrm_s = sample_mesh_surface(mesh, n_supervision, rng)
            face = pts_s[:, 2] > 0.0
            _write_splits(sup_dir, f"{e}_{{}}_face.npy",
                          np.concatenate([pts_s[face], nrm_s[face]], -1), num_splits)
            _write_splits(sup_dir, f"{e}_{{}}_non_face.npy",
                          np.concatenate([pts_s[~face], nrm_s[~face]], -1), num_splits)

            # deformation supervision: shared-topology correspondences
            def_dir = os.path.join(root, "supervision_deformation", f"{s:03d}", f"{e:03d}")
            os.makedirs(def_dir, exist_ok=True)
            pn, _, fidx, bary = sample_mesh_surface(neutral_mesh, n_supervision // 2, rng,
                                                    return_face_idx=True)
            pp = np.einsum("nk,nkd->nd", bary, mesh.vertices[mesh.faces[fidx]])
            _write_splits(def_dir, "corresp_{}.npy", np.concatenate([pn, pp], axis=-1),
                          num_splits)
    return root


def dummy_env(root: str) -> dict:
    """Environment variables pointing all NPHM paths at a dummy tree."""
    return {
        "NPHM_ROOT": root,
        "NPHM_DATA": os.path.join(root, "dataset"),
        "NPHM_DATA_SINGLE_VIEW": os.path.join(root, "single_view"),
        "NPHM_SUPERVISION_IDENTITY": os.path.join(root, "supervision_identity"),
        "NPHM_SUPERVISION_DEFORMATION": os.path.join(root, "supervision_deformation"),
        "NPHM_EXPERIMENT_DIR": os.path.join(root, "experiments"),
        "NPHM_FITTING_DIR": os.path.join(root, "fitting"),
        "NPHM_ASSETS": os.path.join(root, "assets"),
        "NPHM_DUMMY_DATA": root,
        "NPHM_NUM_SPLITS": "2",
        "NPHM_NUM_SPLITS_EXPR": "2",
    }
