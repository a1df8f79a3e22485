"""The port's fitting CLI (``python -m nphm_tpu_torch.fitting_pointclouds``)
end to end on the CPU, in a subprocess where ``jax`` cannot be imported.

On a dummy tree from the port's ``generate_dummy_data`` with tiny-width
port checkpoints of an NPHM identity model and a compress-mode
deformation model, it runs ``-demo`` (10 steps, res 32, one subject at a
time through ``fit_joint``), ``-demo -batch_subjects 2`` (both subjects in
one ``fit_joint_batch``) and ``-sample -n_samples 1``, and checks the JAX
script's output layout: ``configs.yaml``, ``{subj}_{expr}.ply`` with a
non-empty mesh, ``_lat_shape.npy`` and ``_lat_expr.npy`` per expression,
``mesh_0000.ply`` / ``lat_0000.npy`` of the sample, and one parseable
``FIT_PHASE_TIMINGS`` line per fit.  ``-sparse`` is accepted, with
``-sparse_lip`` (default 2.0).

The whole pipeline of ``tests/test_cli.py`` on the port, at tiny widths, in
a subprocess where ``jax`` cannot be imported: ``python -m
nphm_tpu_torch.train -local`` (2 epochs), ``train_corresp -mode compress``
(2 epochs) on that experiment, then ``fitting_pointclouds -demo -sparse``
and ``-sample`` on both; the checkpoints, config snapshots,
reconstruction logs and meshes exist, and a rerun of ``train`` reloads its
snapshot and resumes.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import yaml

from nphm_tpu_torch.config import build_expression_decoder, build_identity_decoder
from nphm_tpu_torch.data.dummy import dummy_env, generate_dummy_data
from nphm_tpu_torch.fitting_pointclouds import main, parse_args
from nphm_tpu_torch.training.checkpoints import save_checkpoint
from nphm_tpu_torch.utils.mesh_io import read_ply
from nphm_tpu_torch.utils.params import to_numpy_pytree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBJECTS, N_EXPR = (351, 365), 2
ID_DECODER = {"decoder_lat_dim_glob": 8, "decoder_lat_dim_loc": 4, "decoder_hidden_dim": 16,
              "decoder_nlayers": 2, "decoder_nloc": 39, "decoder_nsymm_pairs": 16,
              "pos_mlp_dim": 16}
EX_DECODER = {"decoder_hidden_dim": 32, "decoder_lat_dim_expr": 8, "decoder_lat_dim_id": 8,
              "decoder_nlayers": 2, "mode": "compress"}


def write_experiment(exp_dir, name, cfg, params):
    os.makedirs(os.path.join(exp_dir, name), exist_ok=True)
    with open(os.path.join(exp_dir, name, "configs.yaml"), "w") as f:
        yaml.safe_dump(cfg, f)
    save_checkpoint(os.path.join(exp_dir, name, "checkpoints"), 1,
                    {"params": to_numpy_pytree(params)})


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dummy"))
    generate_dummy_data(root, subjects=SUBJECTS, n_expressions=N_EXPR, n_supervision=2000)
    env = dummy_env(root)
    anchors = np.load(os.path.join(env["NPHM_ASSETS"], "anchors_39.npy"))
    shape = build_identity_decoder(ID_DECODER, local=True, mean_anchors=anchors)
    expr = build_expression_decoder({"ex_decoder": EX_DECODER, "id_decoder": ID_DECODER},
                                    "compress")
    gen = torch.Generator().manual_seed(0)
    write_experiment(env["NPHM_EXPERIMENT_DIR"], "tiny_id", {"decoder": ID_DECODER},
                     shape.init(gen, "cpu"))
    write_experiment(env["NPHM_EXPERIMENT_DIR"], "tiny_def",
                     {"ex_decoder": EX_DECODER, "id_decoder": ID_DECODER},
                     expr.init(gen, "cpu"))
    lat_dim = shape.lat_dim
    np.save(os.path.join(env["NPHM_ASSETS"], "nphm_lat_mean.npy"), np.zeros(lat_dim, np.float32))
    np.save(os.path.join(env["NPHM_ASSETS"], "nphm_lat_std.npy"),
            np.full(lat_dim, 0.1, np.float32))
    fit_cfg = {"exp_name_shape": "tiny_id", "checkpoint_shape": 1, "mode": "compress",
               "local_shape": True, "local_expr": False, "exp_name_expr": "tiny_def",
               "checkpoint_expr": 1}
    cfg_path = os.path.join(root, "fitting_tiny.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(fit_cfg, f)
    return root, env, cfg_path


def test_cli_demo_batch_and_sample(tree, tmp_path):
    root, env, cfg_path = tree
    base = ["-cfg_file", cfg_path, "-exp_name", "tiny", "-device", "cpu",
            "-resolution", "32", "-batch_points", "4096"]
    runs = [base + ["-exp_tag", "demo", "-demo", "-n_steps", "10"],
            base + ["-exp_tag", "demo_batch", "-demo", "-batch_subjects", "2",
                    "-n_steps", "10"],
            base + ["-exp_tag", "sample", "-sample", "-n_samples", "1"]]
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None  # importing jax fails
        sys.path.insert(0, {ROOT!r})
        from nphm_tpu_torch.fitting_pointclouds import main, parse_args
        for argv in {runs!r}:
            main(argv)
        print("FOREIGN_LOADED", sorted(m for m in sys.modules
                                       if m.startswith("nphm_tpu.") or m == "nphm_tpu"
                                       or (m.startswith("jax") and sys.modules[m])))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(tmp_path), env={**os.environ, **env, "OMP_NUM_THREADS": "1"},
                         timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "FOREIGN_LOADED []" in out.stdout
    timings = [json.loads(line.split(" ", 1)[1]) for line in out.stdout.splitlines()
               if line.startswith("FIT_PHASE_TIMINGS ")]
    assert len(timings) == 2
    assert len(timings[0]["fit_group_walls_s"]) == 2  # one subject at a time
    assert len(timings[1]["fit_group_walls_s"]) == 1  # both in one batched fit
    for t in timings:
        assert {"fit_s", "extract_s", "deform_export_s", "mean_broyden_iters"} <= set(t)
    for tag in ("demo", "demo_batch"):
        out_dir = os.path.join(env["NPHM_FITTING_DIR"], "forward_tiny", tag)
        assert os.path.exists(os.path.join(out_dir, "configs.yaml"))
        for s in SUBJECTS:
            for e in range(N_EXPR):
                mesh = read_ply(os.path.join(out_dir, f"{s}_{e}.ply"))
                assert len(mesh.vertices) > 0 and len(mesh.faces) > 0
                assert np.isfinite(mesh.vertices).all()
                assert np.load(os.path.join(out_dir, f"{s}_{e}_lat_shape.npy")).shape == (1, 168)
                assert np.load(os.path.join(out_dir, f"{s}_{e}_lat_expr.npy")).shape == (1, 8)
    samples = tmp_path / "nphm_shape_space_samples_085"
    assert len(read_ply(str(samples / "mesh_0000.ply")).vertices) > 0
    assert np.load(samples / "lat_0000.npy").shape == (1, 168)
    assert os.path.exists(os.path.join(env["NPHM_FITTING_DIR"], "forward_tiny", "sample",
                                       "configs.yaml"))


def test_cli_refuses_sparse(tmp_path):
    """``-sparse`` is no longer refused: it parses with ``-sparse_lip`` (JAX
    default 2.0) and the run goes on to read its config."""
    argv = ["-cfg_file", str(tmp_path / "none.yaml"), "-exp_name", "x", "-exp_tag", "y",
            "-sparse"]
    args = parse_args(argv)
    assert args.sparse and args.sparse_lip == 2.0
    assert parse_args(argv + ["-sparse_lip", "3.5"]).sparse_lip == 3.5
    with pytest.raises(FileNotFoundError):
        main(argv)


TRAIN_ID_CFG = {
    "decoder": ID_DECODER,
    "training": {"batch_size": 2, "ckpt_interval": 1, "grad_clip": 0.1, "grad_clip_lat": 0.1,
                 "lr": 0.0005, "lr_lat": 0.001, "lr_decay_factor": 0.5,
                 "lr_decay_factor_lat": 0.5, "lr_decay_interval": 5000,
                 "lr_decay_interval_lat": 5000, "npoints_decoder": 100,
                 "npoints_decoder_non": 50, "sigma_near": 0.01, "weight_decay": 0.01,
                 "nepochs": 2, "recon_resolution": 32,
                 "lambdas": {"lat_reg": 0.01, "surf_sdf": 2.0, "normals": 0.3,
                             "space_sdf": 0.01, "grad": 0.1, "anchors": 7.5,
                             "symm_dist": 0.01, "middle_dist": 0.0}},
}
TRAIN_DEF_CFG = {
    "ex_decoder": {k: v for k, v in EX_DECODER.items() if k != "mode"},
    "id_decoder": ID_DECODER,
    "training": {"batch_size": 2, "ckpt_interval": 1, "grad_clip": 0.025,
                 "grad_clip_lat": 0.025,
                 "lambdas": {"corresp": 100.0, "lat_reg": 5.0e-05, "loss_reg_zero": 5.0e-05},
                 "lr": 0.0001, "lr_decay_factor": 0.5, "lr_decay_factor_lat": 0.5,
                 "lr_decay_interval": 600, "lr_decay_interval_lat": 600, "lr_lat": 0.0005,
                 "npoints_decoder": 200, "shape_ckpt": 1, "shape_exp_name": "cli_id",
                 "sigma_near": 0.01, "weight_decay": 0.0005, "nepochs": 2,
                 "recon_resolution": 32},
}


def test_cli_training_pipeline(tmp_path_factory, tmp_path):
    root = str(tmp_path_factory.mktemp("pipeline"))
    generate_dummy_data(root, subjects=SUBJECTS + (199,), n_expressions=N_EXPR,
                        n_supervision=2000)
    env = dummy_env(root)
    exp = env["NPHM_EXPERIMENT_DIR"]
    paths = {}
    for name, cfg in (("id", TRAIN_ID_CFG), ("def", TRAIN_DEF_CFG),
                      ("fit", {"exp_name_shape": "cli_id", "checkpoint_shape": 1,
                               "mode": "compress", "local_shape": True,
                               "local_expr": False, "exp_name_expr": "cli_def",
                               "checkpoint_expr": 1})):
        paths[name] = os.path.join(root, f"{name}.yaml")
        with open(paths[name], "w") as f:
            yaml.safe_dump(cfg, f)
    lat_dim = 8 + 40 * 4
    np.save(os.path.join(env["NPHM_ASSETS"], "nphm_lat_mean.npy"), np.zeros(lat_dim, np.float32))
    np.save(os.path.join(env["NPHM_ASSETS"], "nphm_lat_std.npy"),
            np.full(lat_dim, 0.1, np.float32))
    fit = ["-cfg_file", paths["fit"], "-exp_name", "cli", "-device", "cpu", "-resolution", "32"]
    runs = [
        ("nphm_tpu_torch.train", ["-exp_name", "cli_id", "-cfg_file", paths["id"], "-local",
                                  "-device", "cpu"]),
        ("nphm_tpu_torch.train_corresp", ["-exp_name", "cli_def", "-cfg_file", paths["def"],
                                          "-mode", "compress", "-device", "cpu", "-wandb"]),
        ("nphm_tpu_torch.fitting_pointclouds", fit + ["-exp_tag", "demo", "-demo", "-sparse",
                                                      "-n_steps", "10"]),
        ("nphm_tpu_torch.fitting_pointclouds", fit + ["-exp_tag", "sample", "-sample",
                                                      "-n_samples", "1"]),
        # a rerun ignores -cfg_file, reloads the snapshot and resumes after epoch 1
        ("nphm_tpu_torch.train", ["-exp_name", "cli_id", "-local", "-device", "cpu"]),
    ]
    code = textwrap.dedent(f"""
        import importlib
        import sys
        sys.modules["jax"] = None  # importing jax fails
        sys.path.insert(0, {ROOT!r})
        for mod, argv in {runs!r}:
            print("RUN", mod, flush=True)
            importlib.import_module(mod).main(argv)
        print("FOREIGN_LOADED", sorted(m for m in sys.modules
                                       if m.startswith("nphm_tpu.") or m == "nphm_tpu"
                                       or (m.startswith("jax") and sys.modules[m])))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(tmp_path), env={**os.environ, **env, "OMP_NUM_THREADS": "1"},
                         timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "FOREIGN_LOADED []" in out.stdout
    assert "Loading config snapshot" in out.stdout.split("RUN nphm_tpu_torch.train")[-1]
    for name in ("cli_id", "cli_def"):
        assert os.path.exists(os.path.join(exp, name, "configs.yaml"))
        assert sorted(os.listdir(os.path.join(exp, name, "checkpoints"))) == [
            "checkpoint_epoch_0.pkl", "checkpoint_epoch_1.pkl"]
    with open(os.path.join(exp, "cli_def", "configs.yaml")) as f:
        assert yaml.safe_load(f)["ex_decoder"]["mode"] == "compress"
    assert os.listdir(os.path.join(exp, "cli_id", "recs", "epoch_1"))
    recs = os.listdir(os.path.join(exp, "cli_def", "recs", "val_epoch_1"))
    assert {"mesh_199_neutral.ply", "mesh_199_e0.ply"} <= set(recs)
    out_dir = os.path.join(env["NPHM_FITTING_DIR"], "forward_cli", "demo")
    for s in SUBJECTS:
        for e in range(N_EXPR):
            mesh = read_ply(os.path.join(out_dir, f"{s}_{e}.ply"))
            assert len(mesh.vertices) > 0 and len(mesh.faces) > 0
            assert np.isfinite(mesh.vertices).all()
    sample = read_ply(str(tmp_path / "nphm_shape_space_samples_085" / "mesh_0000.ply"))
    assert len(sample.vertices) > 0
