"""The GNN and interpolate deformation modes through the port's entry points
vs the JAX package, on the CPU.

Tiny NPHM identity decoder and deformation fields of both modes (expr 8,
hidden 32, 4 layers), JAX weights bridged with ``from_numpy_pytree``.

- ``fit_joint_batch`` for 5 steps on 2 subjects with ragged observation
  counts, handed the JAX batched fit's own draws: GNN with the kernels
  "on" (the plain K2 twin against Pallas in interpret mode) and "off";
  interpolate "off" (its per-point conditioning keeps it off K2 in both
  packages).  Latents at rtol 1e-3 / atol 5e-4, the loss history at rtol
  1e-3 / atol 1e-5, executed Broyden iterations equal per subject (the
  bounds of ``tests/test_torch_fit_batch.py``).  The symmetric-pair
  distance weighs 0 here: from zero codes its gradient is the direction of
  a pair's difference, which rounding sets (``chip_smoke.py``'s
  ``check_batch_reference``), so it would compare summation orders, not
  the modes; the compress fits of that file keep it.
- ``deform_mesh_batch`` and the backward-warp SDF ``get_logits_backward``
  from the fitted codes against JAX's: vertices and logits at atol 1e-5;
  a GNN field's offsets go through K7's wrapper (``ops.trunk.deformation``,
  its plain twin here), an interpolate field's never do.
- The reference checkpoint mapping of a GNN field (fabricated state dict)
  equals ``nphm_tpu.utils.torch_convert``'s and round-trips key for key.
- ``train_corresp -mode GNN|interpolate`` in a subprocess where ``jax``
  cannot be imported: two epochs with checkpoints and ``log_recs`` meshes,
  a resume from epoch 0 whose checkpoint holds the field's list-valued
  parameters, then ``fitting_pointclouds -demo -batch_subjects 2``, which
  reads the mode back from the experiment's ``configs.yaml``.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp
import torch

from nphm_tpu.fitting import FittingConfig as JFittingConfig, fit_joint_batch as jfit_joint_batch
from nphm_tpu.models import (
    DeformationConfig as JDeformationConfig,
    NPHMConfig as JNPHMConfig,
    make_deformation_decoder as jmake_deformation,
    make_nphm_decoder as jmake_nphm,
)
from nphm_tpu.reconstruction.extract import (
    deform_mesh_batch as jdeform_mesh_batch,
    extract_mesh as jextract_mesh,
    get_logits_backward as jget_logits_backward,
)
from nphm_tpu.utils import torch_convert as jconv
from nphm_tpu_torch.data.dummy import dummy_env, generate_dummy_data
from nphm_tpu_torch.fitting import FittingConfig, fit_joint_batch
from nphm_tpu_torch.fitting.inference import default_joint_lambdas
from nphm_tpu_torch.models import (
    DeformationConfig,
    NPHMConfig,
    make_deformation_decoder,
    make_nphm_decoder,
)
from nphm_tpu_torch.reconstruction import extract
from nphm_tpu_torch.utils import torch_convert as tconv
from nphm_tpu_torch.utils.mesh_io import read_ply
from test_torch_cli import ID_DECODER, TRAIN_DEF_CFG, TRAIN_ID_CFG
from test_torch_fit_batch import batch_draws
from test_torch_slice import MINI, MAXI, SHAPE_KW, bridge, nonrigid_observations

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEF_KW = dict(lat_dim_glob_shape=8, lat_dim_loc_shape=4, n_loc=6, lat_dim_expr=8,
              lat_dim_id=8, hidden_dim=32, n_layers=4)
FIT = dict(n_steps=5, n_obs_per_batch=2, n_points_per_obs=40, broyden_warm_steps=8,
           log_every=10**9)
N_OBS = (3, 2)
TOL = dict(rtol=1e-3, atol=5e-4)
TOL_LOSS = dict(rtol=1e-3, atol=1e-5)
ATOL_MESH = 1e-5
MODES = ("GNN", "interpolate")
LAMBDAS = dict(default_joint_lambdas(), symm_dist=0.0)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(6)
    anchors = (rng.normal(size=(SHAPE_KW["n_loc"], 3)) * 0.25).astype(np.float32)
    js = jmake_nphm(JNPHMConfig(**SHAPE_KW), anchors)
    jps = js.init(jax.random.PRNGKey(0))
    subjects = [[o * size for o in nonrigid_observations(rng, n_obs=n, n_pts=240 - 20 * i)]
                for i, (n, size) in enumerate(zip(N_OBS, (1.0, 2.0)))]
    out = dict(js=js, jps=jps, ts=make_nphm_decoder(NPHMConfig(**SHAPE_KW), anchors),
               tps=bridge(jps), subjects=subjects, ref={},
               draws=batch_draws(0, subjects, FIT["n_steps"], FIT["n_obs_per_batch"],
                                 FIT["n_points_per_obs"]))
    for mode in MODES:
        je = jmake_deformation(JDeformationConfig(mode=mode, **DEF_KW))
        jpe = je.init(jax.random.PRNGKey(1))
        out[mode] = dict(je=je, jpe=jpe, tpe=bridge(jpe),
                         te=make_deformation_decoder(DeformationConfig(mode=mode, **DEF_KW)))
    return out


def reference(m, mode, fused):
    if (mode, fused) not in m["ref"]:
        m["ref"][mode, fused] = jfit_joint_batch(
            m["js"], m["jps"], m[mode]["je"], m[mode]["jpe"], m["subjects"], LAMBDAS,
            cfg=JFittingConfig(fused_search=fused, fused_shape_fields=fused, **FIT),
            verbose=False)
    return m["ref"][mode, fused]


@pytest.mark.parametrize("mode,fused", [("GNN", "on"), ("GNN", "off"), ("interpolate", "off")])
def test_fit_joint_batch_matches_jax(models, mode, fused):
    m = models
    le, ls, an, hist = fit_joint_batch(
        m["ts"], m["tps"], m[mode]["te"], m[mode]["tpe"], m["subjects"], LAMBDAS,
        cfg=FittingConfig(fused_search=fused, fused_shape_fields=fused, **FIT),
        verbose=False, device="cpu", sample_draws=m["draws"])
    rle, rls, ran, rhist = reference(m, mode, fused)
    for s, n in enumerate(N_OBS):
        assert le[s].shape == rle[s].shape == (n, DEF_KW["lat_dim_expr"])
        np.testing.assert_allclose(ls[s], rls[s], **TOL)
        np.testing.assert_allclose(le[s], rle[s], **TOL)
        np.testing.assert_allclose(an[s], ran[s], **TOL)
    np.testing.assert_allclose(hist["loss"], rhist["loss"], **TOL_LOSS)
    np.testing.assert_array_equal(hist["broyden_iters"], rhist["broyden_iters"])
    assert np.abs(le[0]).max() > 0


@pytest.mark.parametrize("mode", MODES)
def test_deform_and_backward_warp_match_jax(models, mode, monkeypatch):
    m = models
    rle, rls, ran, _ = reference(m, mode, "off")
    lat_s, lat_e, anchors = rls[0], rle[0], ran[0]
    mesh = jextract_mesh(m["js"], m["jps"], lat_s, MINI, MAXI, 24)
    assert len(mesh.vertices) > 0
    k7_calls = []
    deformation = extract.deformation
    monkeypatch.setattr(extract, "deformation",
                        lambda *a, **kw: k7_calls.append(1) or deformation(*a, **kw))
    je, jpe, te, tpe = (m[mode][k] for k in ("je", "jpe", "te", "tpe"))
    posed_ref = jdeform_mesh_batch(mesh, je, jpe, lat_e, anchors=anchors, lat_shape=lat_s)
    posed = extract.deform_mesh_batch(mesh, te, tpe, lat_e, anchors=anchors, lat_shape=lat_s,
                                      chunk_size=1000, device="cpu")
    assert len(posed) == len(posed_ref) == N_OBS[0]
    for a, b in zip(posed, posed_ref):
        np.testing.assert_allclose(a.vertices, b.vertices, atol=ATOL_MESH)
        assert np.abs(a.vertices - mesh.vertices).max() > 1e-3
    pts = (np.random.default_rng(1).uniform(-0.5, 0.5, size=(3000, 3))).astype(np.float32)
    enc = np.concatenate([lat_s.reshape(-1), lat_e[1]])
    ref = jget_logits_backward(m["js"], je, m["jps"], jpe, lat_s, enc, pts,
                               anchors=jnp.asarray(anchors).reshape(1, -1, 3), chunk_size=1024)
    out = extract.get_logits_backward(m["ts"], te, m["tps"], tpe, lat_s, enc, pts,
                                      anchors=anchors, chunk_size=1024, device="cpu")
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL_MESH)
    # GNN is row-constant: K7's wrapper, once per 1024-point chunk
    assert len(k7_calls) == (3 if mode == "GNN" else 0)


def test_gnn_checkpoint_mapping_matches_jax():
    cfg = DeformationConfig(mode="GNN", **DEF_KW)
    jcfg = JDeformationConfig(mode="GNN", **DEF_KW)
    shapes, _ = cfg.trunk_cfg.layer_shapes
    dims = {"pos_enc": (3, 4, 4), "local_combiner": (4, 4, 4),
            "global_combiner": (8 + 6 * 4, 512, 8)}
    keys = [(f"defDeepSDF.lin{i}.{p}", (o, n) if p == "weight" else (o,))
            for i, (n, o) in enumerate(shapes) for p in ("weight", "bias")]
    keys += [(f"{name}.{j}.{p}", (d[k + 1], d[k]) if p == "weight" else (d[k + 1],))
             for name, d in dims.items() for k, j in enumerate((0, 2))
             for p in ("weight", "bias")]
    rng = np.random.default_rng(7)
    sd = {k: rng.normal(size=s).astype(np.float32) for k, s in keys}
    ours = tconv.deformation_params_from_state_dict(sd, cfg)
    ref = jconv.deformation_params_from_state_dict(sd, jcfg)
    assert sorted(ours) == sorted(ref) == ["global_combiner", "local_combiner", "pos_enc",
                                           "trunk"]
    flat = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, ref))
    mine = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: t.numpy(), ours))
    assert len(flat) == len(mine) == len(sd)
    for a, b in zip(mine, flat):
        np.testing.assert_array_equal(a, b)
    back = tconv.deformation_state_dict_from_params(ours)
    assert back.keys() == jconv.deformation_state_dict_from_params(ref).keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k])
    # the mapped field runs
    delta, _ = make_deformation_decoder(cfg).apply(
        ours, torch.zeros(1, 5, 3), torch.zeros(1, cfg.lat_dim_shape_full + 8),
        torch.zeros(1, 6, 3))
    assert delta.shape == (1, 5, 3) and torch.isfinite(delta).all()


def test_train_corresp_cli_modes(tmp_path):
    root = str(tmp_path / "dummy")
    generate_dummy_data(root, subjects=(351, 365, 199), n_expressions=2, n_supervision=2000)
    env = dummy_env(root)
    exp = env["NPHM_EXPERIMENT_DIR"]
    id_cfg = {"decoder": ID_DECODER, "training": dict(TRAIN_ID_CFG["training"], nepochs=1)}
    def_cfg = dict(TRAIN_DEF_CFG, training=dict(TRAIN_DEF_CFG["training"], shape_ckpt=0))
    paths = {"id": str(tmp_path / "id.yaml"), "def": str(tmp_path / "def.yaml")}
    for name, cfg in (("id", id_cfg), ("def", def_cfg)):
        with open(paths[name], "w") as f:
            yaml.safe_dump(cfg, f)
    runs = [("nphm_tpu_torch.train", ["-exp_name", "cli_id", "-cfg_file", paths["id"],
                                      "-local", "-device", "cpu"])]
    for mode in MODES:
        fit_path = str(tmp_path / f"fit_{mode}.yaml")
        with open(fit_path, "w") as f:
            yaml.safe_dump({"exp_name_shape": "cli_id", "checkpoint_shape": 0,
                            "local_shape": True, "local_expr": False,
                            "exp_name_expr": f"def_{mode}", "checkpoint_expr": 1}, f)
        runs += [
            ("nphm_tpu_torch.train_corresp", ["-exp_name", f"def_{mode}", "-cfg_file",
                                              paths["def"], "-mode", mode, "-device", "cpu"]),
            # resume from epoch 0's checkpoint: epoch 1 again
            ("nphm_tpu_torch.train_corresp", ["-exp_name", f"def_{mode}", "-mode", mode,
                                              "-ckpt", "0", "-device", "cpu"]),
            ("nphm_tpu_torch.fitting_pointclouds", [
                "-cfg_file", fit_path, "-exp_name", mode, "-exp_tag", "demo", "-demo",
                "-batch_subjects", "2", "-n_steps", "5", "-resolution", "32",
                "-device", "cpu"]),
        ]
    code = textwrap.dedent(f"""
        import importlib
        import sys
        sys.modules["jax"] = None  # importing jax fails
        sys.path.insert(0, {ROOT!r})
        for mod, argv in {runs!r}:
            print("RUN", mod, argv[1], flush=True)
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
    from nphm_tpu_torch.training.checkpoints import load_checkpoint

    for mode in MODES:
        name = f"def_{mode}"
        resumed = out.stdout.split(f"RUN nphm_tpu_torch.train_corresp {name}")[2]
        assert "Resumed after epoch 0" in resumed.split("RUN ")[0]
        with open(os.path.join(exp, name, "configs.yaml")) as f:
            assert yaml.safe_load(f)["ex_decoder"]["mode"] == mode
        ckpts = os.path.join(exp, name, "checkpoints")
        assert sorted(os.listdir(ckpts)) == ["checkpoint_epoch_0.pkl", "checkpoint_epoch_1.pkl"]
        params = load_checkpoint(ckpts, 1)["params"]
        if mode == "GNN":
            assert [len(params[k]) for k in ("pos_enc", "local_combiner", "global_combiner")] \
                == [2, 2, 2]
            assert params["global_combiner"][0]["w"].shape == (512, 8 + 39 * 4)
        else:
            assert sorted(params) == ["trunk"]
        recs = os.listdir(os.path.join(exp, name, "recs", "val_epoch_1"))
        assert {"mesh_199_neutral.ply", "mesh_199_e0.ply"} <= set(recs)
        out_dir = os.path.join(env["NPHM_FITTING_DIR"], f"forward_{mode}", "demo")
        for s in (351, 365):
            for e in (0, 1):
                mesh = read_ply(os.path.join(out_dir, f"{s}_{e}.ply"))
                assert len(mesh.vertices) > 0 and np.isfinite(mesh.vertices).all()
