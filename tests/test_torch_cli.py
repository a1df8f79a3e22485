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
``FIT_PHASE_TIMINGS`` line per fit.  ``-sparse`` is refused with a message
that names ROADMAP A3.
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
from nphm_tpu_torch.fitting_pointclouds import main
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
        from nphm_tpu_torch.fitting_pointclouds import main
        for argv in {runs!r}:
            main(argv)
        print("FOREIGN_LOADED", sorted(m for m in sys.modules
                                       if m.startswith("nphm_tpu.") or m == "nphm_tpu"
                                       or (m.startswith("jax") and sys.modules[m])))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(tmp_path), env={**os.environ, **env}, timeout=600)
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
    with pytest.raises(NotImplementedError, match="ROADMAP A3"):
        main(["-cfg_file", str(tmp_path / "none.yaml"), "-exp_name", "x", "-exp_tag", "y",
              "-sparse"])
