"""How much of the lattice the sparse extraction evaluates as an NPHM
identity model trains, on the GPU.

    python -m nphm_tpu_torch.profile_sparse [--steps 0 50 150 300 600]

Trains the decoder of ``configs/nphm.yaml`` from a seed with the
``IdentityTrainer`` of ``profile_train`` (K5/K6, 32 synthetic heads, one
batch of 32 a step, fresh points each step).  At each step count of
``--steps`` it extracts training latent 0 at res 256 densely (K1 at
tile 1024, the sparse block's tile) and through ``extract_mesh_sparse``
at ``lip="auto"``, 2.0 (the fitting CLI's default) and 4.0, f32, and
prints one JSON line: the field's percentiles over the grid and, per lip,
the candidate and transfer counts, ``lip_observed`` (and ``lip_auto``),
whether a RuntimeWarning was raised, whether the vertex set is the dense
one, and the sparse call's seconds, with the card's name and power
limit.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
import warnings

import numpy as np
import torch

from nphm_tpu_torch.ops.ensemble import nphm_grid_sdf
from nphm_tpu_torch.ops.marching import mesh_from_logits
from nphm_tpu_torch.profile_train import _card, _trainer
from nphm_tpu_torch.reconstruction.sparse import extract_mesh_sparse

GRID_MIN = (-0.55, -0.5, -0.95)
GRID_MAX = (0.55, 0.75, 0.4)
RES = 256
LIPS = ("auto", 2.0, 4.0)


def _sorted(v):
    return v[np.lexsort(v.T)]


def sparse_report(tr) -> dict:
    """The dense and sparse meshes of training latent 0 at RES."""
    dev = tr.device
    lat = tr.latents[0].detach()
    logits = nphm_grid_sdf(tr.params, tr.decoder.cfg, lat, GRID_MIN, GRID_MAX, RES,
                           tile=1024).cpu().numpy()
    dense = _sorted(mesh_from_logits(logits, GRID_MIN, GRID_MAX, RES).vertices)
    out = {"field_percentiles_0_5_50_95_100":
           [float(np.percentile(logits, q)) for q in (0, 5, 50, 95, 100)],
           "dense_vertices": len(dense)}
    for lip in LIPS:
        stats = {}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mesh = extract_mesh_sparse(tr.decoder, tr.params, lat.cpu().numpy(), GRID_MIN,
                                       GRID_MAX, RES, lip=lip, stats=stats, device=dev)
            seconds = time.perf_counter() - t0
        same = len(mesh.vertices) == len(dense) and np.array_equal(_sorted(mesh.vertices),
                                                                     dense)
        out[f"at_lip_{lip}"] = dict(stats, warned=bool(caught), equals_dense=bool(same),
                                    seconds=seconds)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, nargs="+", default=[0, 50, 150, 300, 600])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_sparse needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    with tempfile.TemporaryDirectory() as tmp:
        tr, _ = _trainer(32, tmp)
        done = 0
        for target in sorted(args.steps):
            while done < target:
                for batch in tr.train_dataset.batch_iter(seed=done):
                    tr._train_step(tr._batch(batch), 5e-4, 1e-3)
                done += 1
            print(json.dumps({"card": card, "steps": done, "res": RES,
                              **sparse_report(tr)}), flush=True)


if __name__ == "__main__":
    main()
