"""The port's protocol CLI on the CPU at tiny widths, both families:
``python -m nphm_tpu_torch.protocol_e2e --tiny --device cpu`` on one test
subject (2 expressions), 2 training subjects, 3 epochs a stage, 5 fit
steps, res 32 and 2000 eval draws.  Every stage runs as a child ``python -m
nphm_tpu_torch.<cli>`` with ``jax`` blocked; the run must reach its JSON
line with both meshes fitted and non-empty, ``crashes`` 0, every metrics
file written and the CSV aggregates finite.  NPM's stage 1 runs 201 epochs
(2 subjects, one step each): at its config's lr the tiny field gets no zero
set within 120 epochs, and its fit would then extract empty meshes.
"""

import json
import math
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# on the children's path: every process of the run starts with jax and the
# JAX package unimportable
BLOCK = 'import sys\nsys.modules["jax"] = None\nsys.modules["nphm_tpu"] = None\n'


@pytest.mark.parametrize("family", ["nphm", "npm"])
def test_protocol_runs_on_cpu(family, tmp_path):
    root = tmp_path / "proto"
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(BLOCK)
    # one intra-op thread a child: the tiny widths gain nothing from more, and
    # the suite runs beside other tests
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(site) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    epochs = ["--train_epochs", "201"] if family == "npm" else []
    p = subprocess.run(
        [sys.executable, "-m", "nphm_tpu_torch.protocol_e2e", "--family", family, "--tiny",
         "--device", "cpu", "--fit_subjects", "1", "--n_train_subjects", "2",
         "--n_expressions", "2", "--fit_steps", "5", "--resolution", "32", "--num_samps",
         "2000", "--batch_subjects", "2", "--root", str(root)] + epochs,
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["family"] == family and out["crashes"] == 0
    assert out["n_fitted_meshes"] == 2 and out["n_subjects_fit"] == 1
    assert out["n_empty_meshes"] == 0
    for key in ("dataset_s", "train_s", "def_train_s", "fit_extract_s", "eval_s", "gather_s",
                "fit_phase_fit_s", "full_chamfer_l1", "face_f_score_05"):
        assert math.isfinite(out[key]), key
    result = root / "fitting" / "forward_proto" / "protocol" / "evaluation"
    for e in (0, 1):
        for name in ("metrics.json", "metrics_face.json"):
            assert (result / "99" / f"expression_{e}" / name).exists()
    assert (result / "total_merics.csv").exists() and (result / "total_metrics_face.csv").exists()
