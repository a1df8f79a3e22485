"""The port's dataset CLIs vs ``scripts/dataset/``, as subprocesses on the CPU.

- ``python -m nphm_tpu_torch.make_dummy_data`` and
  ``scripts/dataset/make_dummy_data.py`` with the same flags (plain and
  ``--print-env``): the same stdout once each tree's root is replaced by
  ``ROOT``, the same files, and the same content: every file byte-equal
  but those whose arrays follow the order in which marching lists a
  surface's vertices (the two host marching libraries list them in other
  orders, ``tests/test_torch_experiment_io.py``), whose PLY vertex sets
  match within 1e-6.
- ``python -m nphm_tpu_torch.example_usage`` and
  ``scripts/dataset/example_usage.py`` on one dummy tree with
  ``--export_dir``: identical stdout and byte-equal exported files.
The port's children run with ``jax`` blocked.
"""

import glob
import os
import subprocess
import sys

import numpy as np
from scipy.spatial import cKDTree

from _subproc import cpu_subprocess_env
from nphm_tpu_torch.utils.mesh_io import read_ply

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--subjects", "351", "199", "--n_expressions", "2", "--n_supervision", "2000"]
# listing-independent files: byte-equal between the two generators
SAME_BYTES = ("anchors_39.npy", "lm_inds_39.npy", "s.npy", "R.npy", "t.npy",
              "neutrals_open.json", "neutrals_closed.json")


def run(argv, port: bool, cwd):
    """A port module (``jax`` unimportable) or a JAX-package script; stdout."""
    if port:
        code = ("import runpy, sys\nsys.modules['jax'] = None\n"
                f"sys.path.insert(0, {ROOT!r})\nsys.argv = {argv!r}\n"
                f"runpy.run_module({argv[0]!r}, run_name='__main__')\n")
        cmd, env = [sys.executable, "-c", code], dict(os.environ)
    else:
        cmd, env = [sys.executable] + argv, cpu_subprocess_env()
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=cwd, env=env, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    return out.stdout


def files(root):
    return sorted(os.path.relpath(p, root) for p in glob.glob(os.path.join(root, "**", "*"),
                                                              recursive=True)
                  if os.path.isfile(p))


def test_make_dummy_data_matches_script(tmp_path):
    roots = {k: str(tmp_path / k) for k in ("port", "jax")}
    for extra in ([], ["--print-env"]):
        outs = {}
        for k, port in (("port", True), ("jax", False)):
            prog = "nphm_tpu_torch.make_dummy_data" if port else os.path.join(
                ROOT, "scripts", "dataset", "make_dummy_data.py")
            outs[k] = run([prog, "--root", roots[k]] + FLAGS + extra, port, str(tmp_path))
            outs[k] = outs[k].replace(roots[k], "ROOT")
        assert outs["port"] == outs["jax"]
        assert "NPHM_DUMMY_DATA=ROOT" in outs["port"]
    names = files(roots["jax"])
    assert len(names) > 40 and files(roots["port"]) == names
    listed = 0
    for f in names:
        a, b = (os.path.join(roots[k], f) for k in ("port", "jax"))
        with open(a, "rb") as fa, open(b, "rb") as fb:
            same = fa.read() == fb.read()
        if f.endswith(".ply"):
            va, vb = read_ply(a).vertices, read_ply(b).vertices
            assert va.shape == vb.shape, f
            assert cKDTree(va).query(vb)[0].max() <= 1e-6, f
            listed += not same
        elif os.path.basename(f) in SAME_BYTES:
            assert same, f
    assert listed > 0  # the two marching libraries do list vertices apart


def test_example_usage_matches_script(tmp_path):
    tree = str(tmp_path / "tree")
    run(["nphm_tpu_torch.make_dummy_data", "--root", tree] + FLAGS, True, str(tmp_path))
    outs = {}
    for k, port in (("port", True), ("jax", False)):
        prog = "nphm_tpu_torch.example_usage" if port else os.path.join(
            ROOT, "scripts", "dataset", "example_usage.py")
        outs[k] = run([prog, "--dummy_path", tree, "--export_dir", str(tmp_path / k)], port,
                      str(tmp_path))
    assert outs["port"] == outs["jax"]
    assert "dataset has subjects: [199, 351]" in outs["port"]
    assert "throat cut keeps" in outs["port"] and "single-view obs: (" in outs["port"]
    names = files(str(tmp_path / "jax"))
    assert names == files(str(tmp_path / "port")) and len(names) == 8
    for f in names:
        with open(tmp_path / "port" / f, "rb") as a, open(tmp_path / "jax" / f, "rb") as b:
            assert a.read() == b.read(), f
    assert np.load(tmp_path / "port" / "351_0_anchors.npy").shape == (39, 3)
