"""The port's data-processing CLIs vs the JAX package's scripts, on the CPU.

One raw dummy tree (subjects 3: train, 341: test, 199: eval; 2 expressions
each) with its supervision and observations removed; each package's CLI
writes into its own output directories, and every file written is
``array_equal`` to the JAX script's:

- ``sample_surface`` (identity supervision; the port's pool of 2 ``spawn``
  workers against the JAX script's serial loop: each subject draws from its
  own rng),
- ``sample_deformation_field`` (correspondences),
- ``generate_single_view_observations`` (rasterized observations).
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from nphm_tpu_torch.data.dummy import dummy_env, generate_dummy_data

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _subproc import cpu_subprocess_env  # noqa: E402

OUTPUTS = ("NPHM_SUPERVISION_IDENTITY", "NPHM_SUPERVISION_DEFORMATION",
           "NPHM_DATA_SINGLE_VIEW")


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("raw"))
    generate_dummy_data(root, subjects=(3, 341, 199), n_expressions=2, n_supervision=2000)
    for d in ("supervision_identity", "supervision_deformation", "single_view"):
        shutil.rmtree(os.path.join(root, d))
    written = {}
    for pkg in ("jax", "torch"):
        out = os.path.join(root, f"out_{pkg}")
        env = cpu_subprocess_env({**dummy_env(root), **{k: os.path.join(out, k) for k in OUTPUTS}})
        if pkg == "jax":
            cmds = [["scripts/data_processing/sample_surface.py", "--n_workers", "1"],
                    ["scripts/data_processing/sample_deformation_field.py", "--n_workers", "1"],
                    ["scripts/data_processing/generate_single_view_observations.py"]]
        else:
            cmds = [["-m", "nphm_tpu_torch.data_processing.sample_surface", "--n_workers", "2"],
                    ["-m", "nphm_tpu_torch.data_processing.sample_deformation_field",
                     "--n_workers", "1"],
                    ["-m", "nphm_tpu_torch.data_processing.generate_single_view_observations"]]
        cmds[0] += ["--n_samples", "40000", "--n_samples_off", "5000"]
        cmds[1] += ["--n_samples", "3000"]
        cmds[2] += ["--subjects", "341", "--n_points", "700"]
        for cmd in cmds:
            p = subprocess.run([sys.executable, *cmd], cwd=ROOT, env=env, capture_output=True,
                               text=True, timeout=600)
            assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
        written[pkg] = out
    return written


@pytest.mark.parametrize("kind", OUTPUTS)
def test_cli_outputs_array_equal_jax(outputs, kind):
    def files(pkg):
        base = os.path.join(outputs[pkg], kind)
        return sorted(os.path.relpath(os.path.join(d, f), base)
                      for d, _, fs in os.walk(base) for f in fs)

    names = files("torch")
    assert names == files("jax")
    assert len(names) >= 4, names
    for name in names:
        ours, ref = (np.load(os.path.join(outputs[p], kind, name)) for p in ("torch", "jax"))
        assert ours.dtype == ref.dtype and len(ours) > 0, name
        np.testing.assert_array_equal(ours, ref, err_msg=name)
