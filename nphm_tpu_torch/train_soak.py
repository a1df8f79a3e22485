"""Long stage-1 training soak past the lr decay, with a crash and a resume
(counterpart of ``scripts/validation/train_soak.py``, same flags):

    python -m nphm_tpu_torch.train_soak [--root DIR] [--epochs 5200]
        [--kill_at 2600] [--n_train_subjects 16] [--ckpt_interval 250]
        [--out FILE] [--cpu] [--tiny] [--recon_res 128]

The reference trains stage 1 for 30001 epochs with step-decay learning
rates, always resuming from the latest checkpoint and keeping a
``val_min=EPOCH`` marker.  This runs the port's training CLI at the widths
and lr of ``configs/nphm.yaml`` (decay interval 5000, factor 0.5) on a
synthetic dummy tree (``data/dummy.py``) to ``--epochs``:

1. ``python -m nphm_tpu_torch.train -local`` in a child process (on the
   card, or ``-device cpu`` with ``--cpu``);
2. SIGKILL once ``metrics.jsonl`` passes ``--kill_at``, then the same
   command again, which must resume from the latest checkpoint;
3. from the metrics (torn lines skipped) it asserts that the relaunch
   starts at the last checkpoint N + 1 (the port's numbering: the
   checkpoint of epoch N is written after that epoch), not at 0; that
   ``lr`` and ``lr_lat`` hold through epoch 4999 and halve exactly at 5000
   (with ``--epochs`` past 5000); that the ``val_min`` marker advanced
   past its pre-kill epoch; and that the mean loss of the last 100 epochs
   beats that of epochs 200-300 (when the run reaches them);
4. prints one JSON line with the keys of the JAX package's record
   (``SOAK_r04.json``), and writes it to ``--out`` when given.

Run it alone on its machine: a concurrent job on the host slows every
epoch it times.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import yaml

from nphm_tpu_torch import env_paths
from nphm_tpu_torch.data.dummy import dummy_env, generate_dummy_data
from nphm_tpu_torch.training import checkpoints as ckpt

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLL_S = 1.0  # how often run 1's metrics are read


def read_metrics(path):
    recs = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    recs.append(json.loads(line))
                except json.JSONDecodeError:
                    pass  # torn write from the SIGKILL
    return recs


def launch(cmd, env, log_path):
    with open(log_path, "a") as log:
        return subprocess.Popen(cmd, cwd=_REPO, env=env, stdout=log,
                                stderr=subprocess.STDOUT)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=str, default=None,
                    help="keep the tree here (default: a temporary directory)")
    ap.add_argument("--epochs", type=int, default=5200)
    ap.add_argument("--kill_at", type=int, default=2600)
    ap.add_argument("--n_train_subjects", type=int, default=16)
    ap.add_argument("--ckpt_interval", type=int, default=250)
    ap.add_argument("--out", type=str, default=None,
                    help="also write the JSON line to this file")
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (plumbing smoke; the lr asserts need "
                         "--epochs > 5000)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny decoder widths (plumbing smoke only)")
    ap.add_argument("--recon_res", type=int, default=128,
                    help="log_recs reconstruction resolution")
    return ap.parse_args(argv)


def soak_config(args) -> dict:
    """configs/nphm.yaml with its widths, lr and decay; batch size to the
    dataset, the checkpoint interval and log_recs resolution from the flags."""
    with open(os.path.join(_REPO, "configs", "nphm.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["training"].update(batch_size=min(args.n_train_subjects, 32), nepochs=args.epochs,
                           ckpt_interval=args.ckpt_interval, recon_resolution=args.recon_res)
    if args.tiny:
        cfg["decoder"].update(decoder_lat_dim_glob=8, decoder_lat_dim_loc=4,
                              decoder_hidden_dim=16)
    return cfg


def main(argv=None):
    args = parse_args(argv)
    out = {"epochs": args.epochs, "kill_at": args.kill_at}
    keep = args.root is not None
    root = args.root or tempfile.mkdtemp(prefix="train_soak_")
    os.makedirs(root, exist_ok=True)

    t0 = time.time()
    train_subjects = [1000 + i for i in range(args.n_train_subjects)]
    if not os.path.isdir(os.path.join(root, "dataset")):
        generate_dummy_data(root, subjects=tuple(train_subjects + env_paths.subjects_eval[:2]),
                            n_expressions=2, n_supervision=100000)
    out["dataset_s"] = round(time.time() - t0, 1)

    cfg = soak_config(args)
    base_lr, base_lr_lat = cfg["training"]["lr"], cfg["training"]["lr_lat"]
    cfg_dir = os.path.join(root, "cfg")
    os.makedirs(cfg_dir, exist_ok=True)
    cfg_path = os.path.join(cfg_dir, "soak_id.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)

    env = {**os.environ, **dummy_env(root)}
    exp_dir = os.path.join(root, "experiments", "soak_id")
    metrics_path = os.path.join(exp_dir, "metrics.jsonl")
    log_path = os.path.join(root, "soak_train.log")
    cmd = [sys.executable, "-m", "nphm_tpu_torch.train", "-exp_name", "soak_id",
           "-cfg_file", cfg_path, "-local"] + (["-device", "cpu"] if args.cpu else [])

    # ---- run 1: train until the kill point, then SIGKILL ------------------
    t0 = time.time()
    proc = launch(cmd, env, log_path)
    killed = False
    while proc.poll() is None:
        time.sleep(POLL_S)
        recs = read_metrics(metrics_path)
        if recs and recs[-1].get("step", 0) >= args.kill_at:
            proc.send_signal(signal.SIGKILL)
            proc.wait()
            killed = True
            break
    if not killed:
        raise RuntimeError(f"run 1 exited (rc={proc.returncode}) before epoch "
                           f"{args.kill_at}; see {log_path}")
    out["run1_s"] = round(time.time() - t0, 1)
    pre = read_metrics(metrics_path)
    n_pre = len(pre)
    killed_at = int(pre[-1]["step"])
    out["killed_at_epoch"] = killed_at
    last_ckpt = ckpt.latest_checkpoint_epoch(os.path.join(exp_dir, "checkpoints"))
    vm_pre = ckpt.read_val_min(exp_dir)
    out["val_min_pre_kill"] = None if vm_pre is None else int(vm_pre[0])

    # ---- run 2: the same command; it must resume --------------------------
    t0 = time.time()
    rc = launch(cmd, env, log_path).wait()
    out["run2_s"] = round(time.time() - t0, 1)
    if rc != 0:
        raise RuntimeError(f"run 2 failed rc={rc}; see {log_path}")

    recs = read_metrics(metrics_path)
    by_step = {}
    for r in recs:
        by_step[r["step"]] = r  # later wins: epochs run again after the resume
    steps = sorted(by_step)
    out["last_epoch"] = steps[-1]
    assert steps[-1] == args.epochs - 1, (steps[-1], args.epochs)

    # resume point: the checkpoint of epoch N is written after that epoch's
    # validation and before its metrics line (so at most one epoch past the
    # last line logged), and run 2 starts at N + 1 for the latest one
    run2_first = min((r["step"] for r in recs[n_pre:]), default=None)
    out["resume_from_epoch"] = run2_first
    assert last_ckpt is not None and last_ckpt > 0, last_ckpt
    assert last_ckpt % args.ckpt_interval == 0, (last_ckpt, args.ckpt_interval)
    assert last_ckpt <= killed_at + 1, (last_ckpt, killed_at)
    assert run2_first == last_ckpt + 1, (run2_first, last_ckpt)
    out["last_checkpoint_pre_kill"] = last_ckpt

    # ---- lr gates ----------------------------------------------------------
    def lr_at(step, key):
        return by_step[step][key]

    def _assert_lr(e, key, expect):
        # the logged lr is the float32 value the step used: compare at f32
        # resolution
        got = lr_at(e, key)
        assert abs(got - expect) <= 1e-6 * expect, (e, key, got, expect)

    if args.epochs > 5000:
        for e in (999, 1000, 1001, 2500, 4999):
            _assert_lr(e, "lr", base_lr)
            _assert_lr(e, "lr_lat", base_lr_lat)
        for e in range(5000, min(args.epochs, 5200)):
            _assert_lr(e, "lr", base_lr * 0.5)
            _assert_lr(e, "lr_lat", base_lr_lat * 0.5)
        out["lr_gate_ok"] = True
        out["lr_at_4999"] = lr_at(4999, "lr")
        out["lr_at_5000"] = lr_at(5000, "lr")
        out["lr_lat_at_5000"] = lr_at(5000, "lr_lat")

    # ---- val_min advanced past its pre-kill epoch ---------------------------
    vm_post = ckpt.read_val_min(exp_dir)
    out["val_min_post"] = int(vm_post[0])
    assert vm_post[0] > (vm_pre[0] if vm_pre else -1), (vm_post, vm_pre)

    # ---- loss trend and timing ---------------------------------------------
    early = [by_step[e]["loss"] for e in range(200, 300) if e in by_step]
    late = [by_step[e]["loss"] for e in steps[-100:]]
    if early:  # short smoke runs never reach epoch 200
        out["loss_epoch_200_300"] = round(float(np.mean(early)), 5)
        out["loss_last_100"] = round(float(np.mean(late)), 5)
        assert np.mean(late) < np.mean(early), "loss did not improve"

    ts = [by_step[e]["t"] for e in steps]
    gaps = np.diff(ts)
    # an epoch's metrics line follows its log_recs and checkpoint: those
    # epochs' gaps, and the one after them (the resume boundary), are left
    # out of the steady estimate and the former reported apart
    steady = [g for e, g in zip(steps[1:], gaps)
              if e % args.ckpt_interval not in (0, 1) and abs(g) < 60]
    out["epoch_s_median"] = round(float(np.median(steady)), 3)
    out["epoch_s_p90"] = round(float(np.percentile(steady, 90)), 3)
    ck = [g for e, g in zip(steps[1:], gaps) if e % args.ckpt_interval == 0]
    if ck:
        out["ckpt_epoch_s_median"] = round(float(np.median(ck)), 3)
    out["extrapolated_30001_epochs_h"] = round(float(np.median(steady)) * 30001 / 3600, 2)
    out["total_s"] = round(out["run1_s"] + out["run2_s"], 1)
    if not keep:
        shutil.rmtree(root, ignore_errors=True)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
