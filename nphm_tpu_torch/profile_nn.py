"""Nearest neighbours on the card against scipy's cKDTree, at the eval
draws' sizes (``python -m nphm_tpu_torch.profile_nn``; needs a GPU):

For each of 25 000 (the smoke protocol's draws), 50 000 (the protocol's)
and 250 000 points (the reference's): two seeded noisy spheres at a head's
millimetre scale, one directed query each way, as ``eval_pointcloud`` makes
them.  The card's time (``evaluation.nn.brute_force_directed``, host clock
around the call, its host-to-device and device-to-host copies included) of
the process's first call, which starts CUDA, and the mean of three later
calls; scipy's time (tree build and query, host clock).  Prints one line
per size and a last JSON line with pairs per second, from which
``evaluation/nn.py::AUTO_DEVICE_PAIRS`` is set.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch
from scipy.spatial import cKDTree

from nphm_tpu_torch.evaluation.nn import brute_force_directed

SIZES = (25_000, 50_000, 250_000)


def cloud(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (d * (100.0 + rng.normal(size=(n, 1)) * 0.5)).astype(np.float32)


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_nn needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    rows = []
    first = True
    for n in SIZES:
        a, b = cloud(1, n), cloud(2, n)
        (d_sp, i_sp), scipy_s = timed(lambda: cKDTree(b).query(a))
        (d, i), card_first_s = timed(lambda: brute_force_directed(a, b, "cuda"))
        steady = [timed(lambda: brute_force_directed(b, a, "cuda"))[1] for _ in range(3)]
        card_s = float(np.mean(steady))
        row = {"points": n, "pairs": n * n, "scipy_s": scipy_s,
               "card_first_s": card_first_s, "card_first_starts_cuda": first,
               "card_s": card_s, "pairs_per_s_scipy": n * n / scipy_s,
               "pairs_per_s_card": n * n / card_s,
               "index_mismatches": int((i != i_sp).sum()),
               "max_abs_err": float(np.abs(d - d_sp).max())}
        first = False
        rows.append(row)
        print(f"[nn] {n} x {n}: scipy {scipy_s:.4f} s, card first call {card_first_s:.4f} s, "
              f"steady {card_s:.4f} s ({row['pairs_per_s_card']:.3e} pairs/s against "
              f"{row['pairs_per_s_scipy']:.3e}); {row['index_mismatches']} index mismatches, "
              f"max |dist - scipy| {row['max_abs_err']:.3e}", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "rows": rows}), flush=True)


if __name__ == "__main__":
    main()
