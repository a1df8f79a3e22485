"""The port's synthetic quality run and training soak on the CPU at tiny
widths, each a child process with ``jax`` and the JAX package blocked:

- ``python -m nphm_tpu_torch.synthetic_e2e --tiny --device cpu`` with a
  few epochs and steps: exit 0, one JSON line with exactly the keys of
  ``scripts/validation/synthetic_e2e.py``'s line, every Chamfer finite;
- ``python -m nphm_tpu_torch.train_soak --tiny --cpu`` with a short run,
  an early kill and a small checkpoint interval: the relaunch resumes at
  the last checkpoint N + 1 and the JSON line parses with the keys of
  ``SOAK_r04.json`` that a run short of epoch 5000 reports.
"""

import json
import math
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = 'import sys\nsys.modules["jax"] = None\nsys.modules["nphm_tpu"] = None\n'


def child_env(tmp_path):
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(BLOCK)
    # one intra-op thread a child: the tiny widths gain nothing from more, and
    # the suite runs beside other tests
    return {**os.environ, "OMP_NUM_THREADS": "1",
            "PYTHONPATH": str(site) + os.pathsep + os.environ.get("PYTHONPATH", "")}


def run_module(module, argv, env, timeout):
    p = subprocess.run([sys.executable, "-m", module, *argv], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def jax_script_keys():
    """The keys of the JAX script's JSON line, read from its source."""
    with open(os.path.join(ROOT, "scripts", "validation", "synthetic_e2e.py")) as f:
        src = f.read()
    keys = set(re.findall(r'out\["(\w+)"\]\s*=', src))
    keys |= set(re.findall(r'"(\w+)":', re.search(r"out = \{(.*?)\}", src).group(1)))
    return keys


def test_synthetic_e2e_runs_on_cpu(tmp_path):
    out = run_module("nphm_tpu_torch.synthetic_e2e",
                     ["--tiny", "--device", "cpu", "--epochs", "40", "--def_epochs", "3",
                      "--subjects", "4", "--resolution", "32", "--fit_steps", "5"],
                     child_env(tmp_path), timeout=600)
    assert set(out) == jax_script_keys()
    assert len(jax_script_keys()) == 15
    assert out["backend"] == "cpu" and out["production_dims"] is False
    assert out["train_steps"] == 40
    for key in ("recon_chamfer", "heldout_fit_chamfer", "def_neutral_chamfer_vs_posed",
                "def_deformed_chamfer_vs_posed", "joint_canonical_chamfer",
                "joint_posed_chamfer", "train_s", "fit_s", "joint_fit_s", "total_s"):
        assert math.isfinite(out[key]), key


def test_train_soak_resumes_on_cpu(tmp_path):
    root = tmp_path / "soak"
    out = run_module("nphm_tpu_torch.train_soak",
                     ["--tiny", "--cpu", "--root", str(root), "--epochs", "40", "--kill_at",
                      "12", "--ckpt_interval", "5", "--n_train_subjects", "2",
                      "--recon_res", "16"],
                     child_env(tmp_path), timeout=600)
    with open(os.path.join(ROOT, "SOAK_r04.json")) as f:
        jax_keys = set(json.loads(f.readline()))
    # short of epoch 5000 and of epoch 200: no lr or loss-trend keys
    short = {"lr_gate_ok", "lr_at_4999", "lr_at_5000", "lr_lat_at_5000",
             "loss_epoch_200_300", "loss_last_100"}
    assert set(out) == (jax_keys - short) | {"last_checkpoint_pre_kill"}
    n = out["last_checkpoint_pre_kill"]
    assert out["killed_at_epoch"] >= 12 and n > 0 and n % 5 == 0
    assert out["resume_from_epoch"] == n + 1
    assert out["last_epoch"] == 39
    assert out["val_min_post"] > (out["val_min_pre_kill"] or -1)
    assert (root / "experiments" / "soak_id" / "checkpoints" / "checkpoint_epoch_35.pkl").exists()
