"""Where the time of one identity train step goes, on the GPU.

    python -m nphm_tpu_torch.profile_train [--steps 10] [--batch 32]

Builds the NPHM decoder of ``configs/nphm.yaml`` from a seed, an
``IdentityTrainer`` through K5/K6 on synthetic heads (750 face / 250
non-face points a row), runs two warm-up steps, then:

- times ``--steps`` steps with a synchronised host clock (no profiler);
- traces the same number of steps with ``torch.profiler`` and sums the
  device time of every kernel by name: K5 (``train_fwd_kernel``), K6
  (its two passes ``train_bwd_fwd_kernel`` and ``train_bwd_rev_kernel``,
  the lane contraction and the fixed-order sums), the optimizer (the
  kernels launched inside the trainer's ``optimizer`` profiler range:
  clips, AdamW, row-Adam) and the autograd glue (every other kernel).

Prints one JSON line with the card's name and power limit beside every
number.  Needs a GPU; nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K5_KERNELS = ("train_fwd_kernel",)
K6_KERNELS = ("train_bwd_fwd_kernel", "train_bwd_rev_kernel", "lane_contract", "sum_splits",
              "sum_block_partials")


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return out


def _trainer(batch: int, exp_dir: str):
    from nphm_tpu_torch.config import load_yaml, nphm_config_from_yaml
    from nphm_tpu_torch.data.synthetic import SyntheticIdentityDataset
    from nphm_tpu_torch.models import make_nphm_decoder
    from nphm_tpu_torch.training.trainer import IdentityTrainer
    from nphm_tpu_torch.utils.logging_utils import MetricsLogger

    cfg = load_yaml(os.path.join(ROOT, "configs", "nphm.yaml"))
    ncfg = nphm_config_from_yaml(cfg["decoder"])
    rng = np.random.default_rng(0)
    d = rng.normal(size=(ncfg.n_loc, 3))
    anchors = (0.4 * d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    dec = make_nphm_decoder(ncfg, anchors)
    params = dec.init(torch.Generator().manual_seed(0))
    kw = dict(n_face=750, n_non_face=250, n_anchors=ncfg.n_loc, batch_size=batch)
    ds = SyntheticIdentityDataset(n_subjects=batch, seed=0, **kw)
    tr = IdentityTrainer(dec, params, cfg, ds, ds, "profile", exp_dir=exp_dir,
                         logger=MetricsLogger(quiet=True))
    if tr._fields_fn is None:
        raise RuntimeError("the trainer did not route to K5/K6")
    b = next(iter(ds.batch_iter(seed=0)))
    return tr, tr._batch(b)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    with tempfile.TemporaryDirectory() as tmp:
        tr, batch = _trainer(args.batch, tmp)
        lr, lr_lat = 5e-4, 1e-3
        for _ in range(2):
            tr._train_step(batch, lr, lr_lat)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            tr._train_step(batch, lr, lr_lat)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / args.steps * 1e3

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.steps):
                tr._train_step(batch, lr, lr_lat)
            torch.cuda.synchronize()
        by_name = {}  # device kernels only: a CPU op's device time repeats its kernels'
        opt_ms = 0.0
        for ev in prof.key_averages():
            t = ev.device_time_total / 1e3 / args.steps
            if ev.key == "optimizer":  # the range: its CPU side sums its kernels
                if ev.device_type == torch.autograd.DeviceType.CPU:
                    opt_ms = t
                continue
            if ev.device_type == torch.autograd.DeviceType.CUDA and t > 0:
                by_name[ev.key] = by_name.get(ev.key, 0.0) + t

    def share(names):
        return sum(v for k, v in by_name.items() if any(n in k for n in names))

    device_ms = sum(by_name.values())
    if device_ms > wall_ms:
        # one stream: kernel time cannot exceed the step's wall time, so the
        # sum counted something twice
        raise RuntimeError(f"device kernels sum to {device_ms:.3f} ms a step, more than "
                           f"the {wall_ms:.3f} ms wall time: the device-time count is wrong "
                           f"({sorted(by_name.items(), key=lambda kv: -kv[1])[:8]})")
    k5, k6 = share(K5_KERNELS), share(K6_KERNELS)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(json.dumps({
        "card": card,
        "batch_rows": args.batch,
        "points_per_row": 1693,
        "steps": args.steps,
        "step_wall_ms": wall_ms,
        "device_ms_per_step": device_ms,
        "idle_share": 1.0 - device_ms / wall_ms,
        "k5_ms": k5,
        "k6_ms": k6,
        "k6_parts_ms": {n: share((n,)) for n in K6_KERNELS},
        "optimizer_ms": opt_ms,
        "autograd_glue_ms": device_ms - k5 - k6 - opt_ms,
        "top_kernels_ms": dict(top),
    }), flush=True)


if __name__ == "__main__":
    main()
