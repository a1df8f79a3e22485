"""The evaluation protocol end to end through the port's CLIs (counterpart
of ``scripts/validation/protocol_e2e.py``, same flags but ``--device`` for
``--cpu``):

    python -m nphm_tpu_torch.protocol_e2e [--family nphm|npm] [--nonrigid]
        [--fit_steps 1000] [--resolution 256] [--batch_subjects 8]
        [--num_samps 50000] [--train_epochs 151] [--def_epochs 151]
        [--n_expressions 4] [--fit_subjects N] [--skip_eval] [--root DIR]
        [--reuse_root] [--exp_tag T] [--fit_args '...'] [--tiny] [--device D]

The reference's deliverable is the 23-subject evaluation protocol: fit the
single-view point clouds of every test subject, extract and pose the meshes,
evaluate them with render-based sampling, and aggregate per-subject and
total CSVs.  This module runs that chain on a synthetic dummy tree
(``data/dummy.py``), every stage a child process running ``python -m
nphm_tpu_torch.<cli>``:

1. the dataset: train and eval subjects for training, and the test split's
   identities with ``--n_expressions`` posed expressions and single-view
   observations (with ``--fit_subjects N``, only the first N of them);
2. stage 1, ``train`` (``-local`` for NPHM), and stage 2, ``train_corresp
   -mode compress`` (NPHM) or ``-mode npm``, at the configs' widths
   (``--tiny``: a few units, for the CPU);
3. ``fitting_pointclouds -batch_subjects N``: the batched fit, extraction
   and posing (``local_shape: false`` for NPM);
4. ``eval`` and ``gather`` to the two CSVs.

It prints one JSON line: each phase's wall seconds, the fitting CLI's
``FIT_PHASE_TIMINGS`` (as ``fit_phase_*``), ``n_fitted_meshes``,
``n_empty_meshes``, ``crashes`` and the ``full_*`` / ``face_*`` aggregates
of the two CSVs.  ``--device`` goes to every child that runs on a device
(default: the card).  The models are quick-trained, so the absolute Chamfer
says how the chain runs, not how good a trained model is.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import yaml

from nphm_tpu_torch import env_paths
from nphm_tpu_torch.data.dummy import dummy_env, generate_dummy_data

_CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
_REPO = os.path.dirname(_CONFIGS)


def run_cli(module: str, argv, env, timeout=7200) -> str:
    """``python -m module argv`` in a child process; its stdout, or an error
    with the ends of both streams."""
    proc = subprocess.run([sys.executable, "-m", module, *argv], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"CLI failed: {module} {' '.join(argv)}\nSTDOUT:\n"
                           f"{proc.stdout[-4000:]}\nSTDERR:\n{proc.stderr[-4000:]}")
    return proc.stdout


def load_cfg(name: str) -> dict:
    with open(os.path.join(_CONFIGS, name)) as f:
        return yaml.safe_load(f)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=str, default=None,
                    help="keep the tree here (default: a temporary directory)")
    ap.add_argument("--n_train_subjects", type=int, default=16)
    ap.add_argument("--n_expressions", type=int, default=4)
    ap.add_argument("--train_epochs", type=int, default=None,
                    help="stage-1 epochs (default 151; 3 with --tiny)")
    ap.add_argument("--def_epochs", type=int, default=None,
                    help="stage-2 epochs (default 151; 3 with --tiny)")
    ap.add_argument("--fit_steps", type=int, default=1000)
    ap.add_argument("--resolution", type=int, default=256)
    ap.add_argument("--batch_subjects", type=int, default=8)
    ap.add_argument("--num_samps", type=int, default=50000)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device of every child (default: the GPU)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny widths and, by default, 3 epochs a stage (CPU smoke runs)")
    ap.add_argument("--fit_subjects", type=int, default=0,
                    help="fit only the first N test subjects (0 = all 23)")
    ap.add_argument("--skip_eval", action="store_true",
                    help="stop after the fit phase (no eval / gather)")
    ap.add_argument("--nonrigid", action="store_true",
                    help="non-rigid smooth-bump expression warps instead of translations")
    ap.add_argument("--reuse_root", action="store_true",
                    help="skip dataset generation and training when --root already holds them")
    ap.add_argument("--exp_tag", type=str, default="protocol",
                    help="fitting output tag (variant runs under one root)")
    ap.add_argument("--fit_args", type=str, default="",
                    help="extra arguments appended verbatim to the fitting CLI")
    ap.add_argument("--family", choices=("nphm", "npm"), default="nphm",
                    help="nphm: the local ensemble (configs/nphm*.yaml); npm: the global "
                         "DeepSDF (configs/npm*.yaml, train without -local, train_corresp "
                         "-mode npm, a local_shape: false fitting config)")
    return ap.parse_args(argv)


def model_configs(args):
    """Stage-1 and stage-2 configs of ``--family`` with the protocol's
    training schedule; returns (id_cfg, def_cfg, epochs, def_epochs)."""
    nphm = args.family == "nphm"
    id_cfg = load_cfg("nphm.yaml" if nphm else "npm.yaml")
    def_cfg = load_cfg("nphm_def.yaml" if nphm else "npm_def.yaml")
    default_epochs = 3 if args.tiny else 151
    epochs = default_epochs if args.train_epochs is None else args.train_epochs
    def_epochs = default_epochs if args.def_epochs is None else args.def_epochs
    if args.tiny:
        if nphm:
            # nloc stays 39: the dummy assets ship 39 mean anchors
            id_cfg["decoder"].update(decoder_lat_dim_glob=8, decoder_lat_dim_loc=4,
                                     decoder_hidden_dim=16)
            def_cfg["ex_decoder"].update(decoder_hidden_dim=32, decoder_lat_dim_expr=8,
                                         decoder_lat_dim_id=8)
        else:
            id_cfg["decoder"].update(decoder_lat_dim=16, decoder_hidden_dim=32,
                                     decoder_nlayers=4)
            def_cfg["ex_decoder"].update(decoder_lat_dim=8, decoder_hidden_dim=32,
                                         decoder_nlayers=4)
    # stage 2 loads the stage-1 model through its own decoder block
    # (configs/nphm_def.yaml's anchor-MLP width is not nphm.yaml's)
    def_cfg["id_decoder"] = dict(id_cfg["decoder"])
    bs = min(args.n_train_subjects, 32)
    recon_res = 32 if args.tiny else 128  # log_recs' cost, not the protocol's
    # The NPM family keeps configs/npm.yaml's lr (0.0005).  At the quick
    # schedule's 0.002 the first AdamW step throws the 8 x 1024 trunk's field
    # from about -0.4 to +3 over the whole box, and in some init draws the
    # next steps leave the skip layer's softplus units negative everywhere:
    # the field turns constant and never gets a zero set (PERF.md, section 6).
    id_cfg["training"].update(batch_size=bs, nepochs=epochs, ckpt_interval=max(epochs - 1, 1),
                              lr=0.002 if nphm else id_cfg["training"]["lr"], lr_lat=0.005,
                              recon_resolution=recon_res)
    def_cfg["training"].update(batch_size=bs, nepochs=def_epochs,
                               ckpt_interval=max(def_epochs - 1, 1), lr=0.001, lr_lat=0.005,
                               recon_resolution=recon_res, shape_exp_name="proto_id",
                               shape_ckpt=max(epochs - 1, 1))
    return id_cfg, def_cfg, epochs, def_epochs


def count_meshes(result_dir: str):
    """(fitted PLY files, those with no vertex), from each PLY's header."""
    fitted = sorted(f for f in os.listdir(result_dir) if f.endswith(".ply"))
    n_empty = 0
    for f in fitted:
        with open(os.path.join(result_dir, f), "rb") as fh:
            head = fh.read(512).decode("latin1", "ignore")
        m = re.search(r"element vertex (\d+)", head)
        if m and int(m.group(1)) == 0:
            n_empty += 1
    return fitted, n_empty


def read_totals(result_dir: str) -> dict:
    """The ``full_*`` / ``face_*`` aggregates of gather's two CSVs (a header
    of metric names, one row of means)."""
    out = {}
    for csv_name, tag in (("total_merics.csv", "full"), ("total_metrics_face.csv", "face")):
        with open(os.path.join(result_dir, "evaluation", csv_name)) as f:
            header, total = list(csv.reader(f))[:2]
        for name, val in zip(header, total):
            key = name.strip().lower().replace(" ", "_")
            if key in ("chamfer_l1", "chamfer_l2", "normals_consistency", "f_score_05",
                       "f_score_10"):
                out[f"{tag}_{key}"] = round(float(val), 5)
    return out


def main(argv=None):
    args = parse_args(argv)
    nphm = args.family == "nphm"
    out = {"production_dims": not args.tiny, "family": args.family}
    t_all = time.time()
    keep = args.root is not None
    root = args.root or tempfile.mkdtemp(prefix="protocol_e2e_")
    os.makedirs(root, exist_ok=True)
    device_arg = [] if args.device is None else ["-device", args.device]

    # phase 1: the dataset
    t0 = time.time()
    train_subjects = [1000 + i for i in range(args.n_train_subjects)]
    test_subjects = list(env_paths.subjects_test)
    if args.fit_subjects:
        test_subjects = test_subjects[: args.fit_subjects]
    reuse = args.reuse_root and os.path.isdir(os.path.join(root, "dataset"))
    if reuse:
        print(f"Reusing dataset + checkpoints under {root}")
    else:
        generate_dummy_data(
            root, subjects=tuple(train_subjects + list(env_paths.subjects_eval[:2])
                                 + test_subjects),
            n_expressions=args.n_expressions,
            n_supervision=20000 if args.tiny else 100000,
            expression_mode="nonrigid" if args.nonrigid else "translate")
    out["expression_mode"] = "nonrigid" if args.nonrigid else "translate"
    env = {**os.environ, **dummy_env(root)}
    out["n_test_subjects"] = len(test_subjects)
    out["dataset_s"] = round(time.time() - t0, 1)

    # phase 2: two-stage training
    id_cfg, def_cfg, epochs, def_epochs = model_configs(args)
    cfg_dir = os.path.join(root, "cfg")
    os.makedirs(cfg_dir, exist_ok=True)
    paths = {}
    for name, cfg in (("proto_id", id_cfg), ("proto_def", def_cfg)):
        paths[name] = os.path.join(cfg_dir, f"{name}.yaml")
        with open(paths[name], "w") as f:
            yaml.safe_dump(cfg, f)
    if not reuse:
        t0 = time.time()
        run_cli("nphm_tpu_torch.train", ["-exp_name", "proto_id", "-cfg_file",
                                         paths["proto_id"]] + (["-local"] if nphm else [])
                + device_arg, env)
        out["train_s"] = round(time.time() - t0, 1)
        t0 = time.time()
        run_cli("nphm_tpu_torch.train_corresp",
                ["-exp_name", "proto_def", "-cfg_file", paths["proto_def"],
                 "-mode", "compress" if nphm else "npm"] + device_arg, env)
        out["def_train_s"] = round(time.time() - t0, 1)

    # phase 3: the batched fit, extraction and posing
    fit_cfg = {
        "exp_name_shape": "proto_id",
        # on --reuse_root, the latest checkpoint: the reused tree's epoch
        # count need not match this invocation's
        "checkpoint_shape": None if reuse else max(epochs - 1, 1),
        "mode": "compress" if nphm else "npm",
        "local_shape": nphm, "local_expr": False,
        "exp_name_expr": "proto_def",
        "checkpoint_expr": None if reuse else max(def_epochs - 1, 1),
    }
    fit_cfg_path = os.path.join(cfg_dir, "proto_fit.yaml")
    with open(fit_cfg_path, "w") as f:
        yaml.safe_dump(fit_cfg, f)
    fit_argv = ["-cfg_file", fit_cfg_path, "-exp_name", "proto", "-exp_tag", args.exp_tag,
                "-batch_subjects", str(args.batch_subjects), "-n_steps", str(args.fit_steps),
                "-resolution", str(args.resolution)] + device_arg + args.fit_args.split()
    subject_argv = ["-subjects"] + [str(s) for s in test_subjects] if args.fit_subjects else []
    t0 = time.time()
    fit_out = run_cli("nphm_tpu_torch.fitting_pointclouds", fit_argv + subject_argv, env)
    out["fit_extract_s"] = round(time.time() - t0, 1)
    for line in fit_out.splitlines():
        if line.startswith("FIT_PHASE_TIMINGS "):
            for k, v in json.loads(line.split(" ", 1)[1]).items():
                out[f"fit_phase_{k}"] = v
    result_dir = os.path.join(root, "fitting", "forward_proto", args.exp_tag)
    fitted, n_empty = count_meshes(result_dir)
    out["n_fitted_meshes"] = len(fitted)
    # an empty prediction (no zero crossing in the box) scores eval's far
    # sentinel and poisons the aggregate: count them
    out["n_empty_meshes"] = n_empty
    out["n_subjects_fit"] = len({f.split("_")[0] for f in fitted})
    out["crashes"] = fit_out.count("fit failed")

    # phase 4: evaluation and gather
    if not args.skip_eval:
        eval_subjects = ["--subjects"] + [str(s) for s in test_subjects]
        t0 = time.time()
        run_cli("nphm_tpu_torch.eval",
                ["--result_dir", result_dir, "--num_samps", str(args.num_samps)]
                + eval_subjects + ([] if args.device is None else ["--device", args.device]),
                env, timeout=14400)
        out["eval_s"] = round(time.time() - t0, 1)
        t0 = time.time()
        run_cli("nphm_tpu_torch.gather", ["--result_dir", result_dir] + eval_subjects, env)
        out["gather_s"] = round(time.time() - t0, 1)
        out.update(read_totals(result_dir))

    out["total_s"] = round(time.time() - t_all, 1)
    out["root"] = root if keep else "(temp, removed)"
    if not keep:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
