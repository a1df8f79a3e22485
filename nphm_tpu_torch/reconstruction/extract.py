"""Dense-grid logits, mesh extraction and mesh deformation (counterpart of
``nphm_tpu/reconstruction/extract.py``).

Grid logits come from K1's brick-ordered dense-grid evaluation for the NPHM
ensemble (``ops.ensemble.nphm_grid_sdf``) and from K7 for the NPM family's
DeepSDF (``ops.trunk.npm_grid_sdf``); marching runs on the host through the
port's C++ ``ops.marching.mesh_from_logits``.  Deformation pushes mesh
vertices through the row-constant deformation trunk: K7 on the GPU
(``ops.trunk``), the decoder's plain chunked ``apply`` on the CPU.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nphm_tpu_torch.ops.ensemble import nphm_grid_sdf
from nphm_tpu_torch.ops.marching import mesh_from_logits
from nphm_tpu_torch.ops.trunk import deepsdf_trunk, deformation, npm_grid_sdf
from nphm_tpu_torch.utils.mesh_io import Mesh as TriMesh
from nphm_tpu_torch.utils.params import default_device, tree_device, tree_to

DEFAULT_CHUNK = 1 << 16


def _as_lat(encoding, device):
    return torch.tensor(np.asarray(encoding, np.float32), device=device).reshape(1, -1)


def grid_logits(decoder, params, encoding, mini, maxi, resolution: int):
    """Dense-grid logits [res^3] (natural x-major order) as float32 numpy."""
    lat = _as_lat(encoding, tree_device(params))[0]
    if decoder.kind == "nphm":
        out = nphm_grid_sdf(params, decoder.cfg, lat, mini, maxi, int(resolution))
    elif decoder.kind == "npm":
        out = npm_grid_sdf(params, decoder.cfg, lat, mini, maxi, int(resolution))
    else:
        raise NotImplementedError(f"no grid logits for decoder kind {decoder.kind!r}")
    return out.cpu().numpy()


def extract_mesh(decoder, params, encoding, mini=(-0.55, -0.5, -0.95),
                 maxi=(0.55, 0.75, 0.4), resolution: int = 256, device=None,
                 return_timing: bool = False):
    """Grid-evaluate through K1 or K7 (their plain versions on the CPU), then
    march.

    The parameters move to ``device`` first (default ``default_device()``).
    With ``return_timing`` also returns {"grid_s", "march_s"}: the grid
    evaluation including its device->host copy, and host marching.
    """
    dev = default_device() if device is None else torch.device(device)
    params = tree_to(params, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    logits = grid_logits(decoder, params, encoding, mini, maxi, resolution)
    t1 = time.perf_counter()
    mesh = mesh_from_logits(logits, mini, maxi, resolution)
    t2 = time.perf_counter()
    if return_timing:
        return mesh, {"grid_s": t1 - t0, "march_s": t2 - t1}
    return mesh


@torch.no_grad()
def _deltas(deformer, params, verts, lats, anchors, chunk_size):
    """Deformation offsets [E, M, 3] of vertices [M, 3] under lats [E, 1, L]:
    K7 for CUDA tensors (it chunks the points itself), the decoder's plain
    ``apply`` in chunks otherwise."""
    out = torch.empty((lats.shape[0],) + verts.shape, device=verts.device)
    if verts.is_cuda:
        for e in range(lats.shape[0]):
            if deformer.kind == "deformation":
                out[e] = deformation(params, deformer.cfg, verts, lats[e, 0], anchors)
            elif deformer.kind == "deformation_npm":
                out[e] = deepsdf_trunk(params, deformer.cfg, verts, lats[e, 0])[:, :3]
            else:
                raise NotImplementedError(f"no posing for decoder kind {deformer.kind!r}")
        return out
    for e in range(lats.shape[0]):
        for s in range(0, verts.shape[0], chunk_size):
            delta, _ = deformer.apply(params, verts[None, s : s + chunk_size],
                                      lats[e], anchors)
            out[e, s : s + chunk_size] = delta[0]
    return out


def deform_mesh_batch(mesh: TriMesh, deformer, params, lat_exprs, anchors=None,
                      lat_shape=None, chunk_size: int = DEFAULT_CHUNK,
                      device=None) -> list:
    """Forward-warp mesh vertices through the deformation field for each of
    E expression latents (identity latent prepended when given).  The
    parameters move to ``device`` first (default ``default_device()``).
    ``chunk_size`` is the plain path's chunk of vertices (CPU); K7 sizes
    its own chunks."""
    dev = default_device() if device is None else torch.device(device)
    params = tree_to(params, dev)
    lats = torch.stack([_as_lat(le, dev) for le in lat_exprs])  # [E, 1, L]
    if lat_shape is not None:
        ls = _as_lat(lat_shape, dev)
        lats = torch.cat([ls.expand(lats.shape[0], 1, -1), lats], dim=-1)
    anc = None if anchors is None else torch.tensor(
        np.asarray(anchors, np.float32), device=dev
    ).reshape(1, -1, 3)
    verts = torch.tensor(np.asarray(mesh.vertices, np.float32), device=dev)
    deltas = _deltas(deformer, params, verts, lats, anc, chunk_size).cpu().numpy()
    return [TriMesh(mesh.vertices + d, mesh.faces.copy()) for d in deltas]


def deform_mesh(mesh: TriMesh, deformer, params, lat_expr, anchors=None,
                lat_shape=None, chunk_size: int = DEFAULT_CHUNK,
                device=None) -> TriMesh:
    """Forward-warp mesh vertices through the deformation field."""
    return deform_mesh_batch(mesh, deformer, params, [lat_expr], anchors, lat_shape,
                             chunk_size, device)[0]
