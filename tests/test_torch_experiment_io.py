"""Loading of experiments and the fitting data layer of the port, on the CPU.

- A checkpoint written by the JAX package's ``save_checkpoint`` from the
  JAX identity trainer's state tree (an optax ``inject_hyperparams(adamw)``
  state and row-Adam NamedTuples included) loads through the port's
  ``load_checkpoint`` in a subprocess where ``jax`` and ``optax`` cannot be
  imported; its params and latent tables are array-equal to the saved
  ones.  The port trainer refuses to resume from its optimizer state
  (positional tuples).  The port's own checkpoints load back bit for bit.
- ``utils.torch_convert``: the port's mappings of fabricated reference
  state dicts equal the JAX package's and round-trip.
- ``data.dummy.generate_dummy_data``: with the JAX package's marching in
  place of the port's, the port writes the JAX generator's tree byte for
  byte; with its own marching, the same files, the same surfaces (vertices
  matched within 1e-6; the two libraries list them in different orders)
  and the same arrays wherever the listing does not enter.
- ``data.manager.DataManager``: expressions and single-view observations
  (front and back, throat cut) array-equal to the JAX one's on that tree.
"""

import glob
import os
import pickle
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

import jax
import optax
import torch

from nphm_tpu.data.dummy import generate_dummy_data as jgenerate
from nphm_tpu.data.manager import DataManager as JDataManager
from nphm_tpu.models import (
    DeepSDFConfig as JDeepSDFConfig,
    DeformationConfig as JDeformationConfig,
    NPHMConfig as JNPHMConfig,
    make_nphm_decoder as jmake_nphm,
)
from nphm_tpu.ops.marching import marching_tets as jmarching_tets
from nphm_tpu.training.checkpoints import save_checkpoint as jsave_checkpoint
from nphm_tpu.training.latents import row_adam_init
from nphm_tpu.training.trainer import _adamw_mask
from nphm_tpu.utils import torch_convert as jconv
from nphm_tpu_torch.data import dummy as tdummy
from nphm_tpu_torch.data.manager import DataManager
from nphm_tpu_torch.models import DeepSDFConfig, DeformationConfig, NPHMConfig
from nphm_tpu_torch.training.checkpoints import load_checkpoint, save_checkpoint
from nphm_tpu_torch.training.trainer import IdentityTrainer
from nphm_tpu_torch.utils import torch_convert as tconv
from nphm_tpu_torch.utils.mesh_io import read_ply

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE_KW = dict(lat_dim_glob=8, lat_dim_loc=4, n_loc=6, n_symm_pairs=2, hidden_dim=16,
                n_layers=4, pos_mlp_dim=16)
DEF_KW = dict(mode="compress", lat_dim_glob_shape=8, lat_dim_loc_shape=4, n_loc=6,
              lat_dim_expr=8, lat_dim_id=8, hidden_dim=32, n_layers=4)


def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [np.asarray(tree)]


def assert_trees_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


def test_jax_checkpoint_loads_without_jax(tmp_path):
    anchors = np.random.default_rng(0).normal(size=(6, 3)).astype(np.float32) * 0.3
    params = jmake_nphm(JNPHMConfig(**SHAPE_KW), anchors).init(jax.random.PRNGKey(0))
    opt = optax.inject_hyperparams(optax.adamw)(learning_rate=5e-4, weight_decay=0.01,
                                                mask=_adamw_mask(params))
    latents = jax.random.normal(jax.random.PRNGKey(1), (4, 32)) * 0.01
    tree = {"params": params, "opt_state": opt.init(params), "latents": latents,
            "lat_state": row_adam_init(latents), "latents_val": latents[:2],
            "lat_state_val": row_adam_init(latents[:2])}
    jsave_checkpoint(str(tmp_path / "checkpoints"), 7, tree)
    code = textwrap.dedent(f"""
        import pickle, sys
        sys.modules["jax"] = None
        sys.modules["optax"] = None
        sys.path.insert(0, {ROOT!r})
        from nphm_tpu_torch.training.checkpoints import load_checkpoint
        data = load_checkpoint({str(tmp_path / "checkpoints")!r})
        assert data["epoch"] == 7, data["epoch"]
        assert isinstance(data["opt_state"], tuple)
        with open({str(tmp_path / "loaded.pkl")!r}, "wb") as f:
            pickle.dump({{k: data[k] for k in ("params", "latents", "latents_val")}}, f)
        print("FOREIGN_LOADED", sorted(m for m in sys.modules
                                       if (m.startswith(("jax", "optax")) and sys.modules[m])
                                       or m == "nphm_tpu" or m.startswith("nphm_tpu.")))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOREIGN_LOADED []" in out.stdout, out.stdout
    with open(tmp_path / "loaded.pkl", "rb") as f:
        loaded = pickle.load(f)
    assert_trees_equal(loaded["params"], jax.tree_util.tree_map(np.asarray, params))
    np.testing.assert_array_equal(loaded["latents"], np.asarray(latents))
    np.testing.assert_array_equal(loaded["latents_val"], np.asarray(latents[:2]))


def test_trainer_refuses_jax_optimizer_state(tmp_path):
    params = jmake_nphm(JNPHMConfig(**SHAPE_KW), np.zeros((6, 3), np.float32)).init(
        jax.random.PRNGKey(0))
    opt = optax.inject_hyperparams(optax.adamw)(learning_rate=5e-4, weight_decay=0.01,
                                                mask=_adamw_mask(params))
    jsave_checkpoint(str(tmp_path), 3, {"params": params, "opt_state": opt.init(params)})
    data = load_checkpoint(str(tmp_path))
    with pytest.raises(ValueError, match="does not resume"):
        IdentityTrainer.load_state_dict(types.SimpleNamespace(device="cpu"), data)


def test_port_checkpoint_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    tree = {"params": {"layers": [{"w": rng.normal(size=(4, 3)).astype(np.float32),
                                   "b": rng.normal(size=4).astype(np.float32)}]},
            "opt_state": {"count": np.int32(3), "mu": [rng.normal(size=2)]},
            "latents": rng.normal(size=(5, 2)).astype(np.float32)}
    save_checkpoint(str(tmp_path), 2, tree)
    data = load_checkpoint(str(tmp_path))
    assert data["epoch"] == 2
    for key in tree:
        assert_trees_equal(data[key], tree[key])
        assert [x.dtype for x in leaves(data[key])] == [x.dtype for x in leaves(tree[key])]


def fabricated(keys_shapes, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32) for k, s in keys_shapes}


@pytest.mark.parametrize("family", ["nphm", "deepsdf", "deformation"])
def test_torch_convert_matches_jax(family):
    if family == "nphm":
        cfg, jcfg = NPHMConfig(**SHAPE_KW), JNPHMConfig(**SHAPE_KW)
        shapes, _ = cfg.layer_shapes
        keys = [(f"ensembled_deep_sdf.lin{i}.{p}",
                 (cfg.n_distinct, o, n) if p == "weight" else (cfg.n_distinct, o))
                for i, (n, o) in enumerate(shapes) for p in ("weight", "bias")]
        jref = jmake_nphm(jcfg, np.zeros((6, 3), np.float32)).init(jax.random.PRNGKey(0))
        keys += [(f"mlp_pos.{j}.{p}", np.asarray(lin["w" if p == "weight" else "b"]).shape)
                 for j, lin in zip((0, 2, 4), jref["mlp_pos"]) for p in ("weight", "bias")]
        sd = fabricated(keys, 2)
        anchors = np.random.default_rng(3).normal(size=(6, 3)).astype(np.float32)
        ours = tconv.nphm_params_from_state_dict(sd, cfg, anchors)
        ref = jconv.nphm_params_from_state_dict(sd, jcfg, anchors)
        back = tconv.nphm_state_dict_from_params(ours)
    elif family == "deepsdf":
        kw = dict(lat_dim=8, hidden_dim=16, n_layers=4)
        cfg, jcfg = DeepSDFConfig(**kw), JDeepSDFConfig(**kw)
        shapes, _ = cfg.layer_shapes
        sd = fabricated([(f"lin{i}.{p}", (o, n) if p == "weight" else (o,))
                         for i, (n, o) in enumerate(shapes) for p in ("weight", "bias")], 4)
        ours = tconv.deepsdf_params_from_state_dict(sd, cfg)
        ref = jconv.deepsdf_params_from_state_dict(sd, jcfg)
        back = tconv.deepsdf_state_dict_from_params(ours)
    else:
        cfg, jcfg = DeformationConfig(**DEF_KW), JDeformationConfig(**DEF_KW)
        shapes, _ = cfg.trunk_cfg.layer_shapes
        keys = [(f"defDeepSDF.lin{i}.{p}", (o, n) if p == "weight" else (o,))
                for i, (n, o) in enumerate(shapes) for p in ("weight", "bias")]
        keys += [("compressor.0.weight", (cfg.lat_dim_id, cfg.compressor_in)),
                 ("compressor.0.bias", (cfg.lat_dim_id,))]
        sd = fabricated(keys, 5)
        ours = tconv.deformation_params_from_state_dict(sd, cfg)
        ref = jconv.deformation_params_from_state_dict(sd, jcfg)
        back = tconv.deformation_state_dict_from_params(ours)
    assert isinstance(next(iter(ours.values())), (dict, list))
    assert_trees_equal(ours, ref)
    layer = ours["ensemble"][0] if family == "nphm" else (
        ours["layers"][0] if family == "deepsdf" else ours["trunk"]["layers"][0])
    assert isinstance(layer["w"], torch.Tensor) and layer["w"].dtype == torch.float32
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k])


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("trees")
    paths = {k: str(base / k) for k in ("jax", "port", "port_jax_marching")}
    kw = dict(subjects=(351, 365), n_expressions=2, n_supervision=2000, seed=3,
              expression_mode="nonrigid")
    jgenerate(paths["jax"], **kw)
    tdummy.generate_dummy_data(paths["port"], **kw)
    saved = tdummy.marching_tets
    tdummy.marching_tets = jmarching_tets
    try:
        tdummy.generate_dummy_data(paths["port_jax_marching"], **kw)
    finally:
        tdummy.marching_tets = saved
    return paths


def files(root):
    return sorted(os.path.relpath(p, root) for p in glob.glob(os.path.join(root, "**", "*"),
                                                              recursive=True)
                  if os.path.isfile(p))


def test_dummy_tree_matches_jax(trees):
    ref = files(trees["jax"])
    assert len(ref) > 40
    for name in ("port", "port_jax_marching"):
        assert files(trees[name]) == ref
    for f in ref:
        with open(os.path.join(trees["jax"], f), "rb") as a, \
                open(os.path.join(trees["port_jax_marching"], f), "rb") as b:
            assert a.read() == b.read(), f
    from scipy.spatial import cKDTree

    for f in ref:
        a, b = (os.path.join(trees[k], f) for k in ("jax", "port"))
        if f.endswith(".ply"):
            va, vb = read_ply(a).vertices, read_ply(b).vertices
            assert va.shape == vb.shape, f
            assert cKDTree(va).query(vb)[0].max() <= 1e-6, f
        elif os.path.basename(f) in ("anchors_39.npy", "lm_inds_39.npy", "s.npy", "R.npy",
                                     "t.npy", "neutrals_open.json", "neutrals_closed.json"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), f


def test_data_manager_matches_jax(trees):
    root = trees["jax"]
    ours, ref = DataManager(dummy_path=root), JDataManager(dummy_path=root)
    for s in (351, 365):
        inds = ours.get_expressions(s, testing=True)
        assert inds == ref.get_expressions(s, testing=True) == [0, 1]
        for k, e in enumerate(inds):
            a = ours.get_single_view_obs(s, e, include_back=(k == 0))
            b = ref.get_single_view_obs(s, e, include_back=(k == 0))
            assert len(a) > 1000
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(ours.cut_throat(a, s, e), ref.cut_throat(a, s, e))
            np.testing.assert_array_equal(
                ours.get_single_view_obs(s, e, coordinate_system="raw"),
                ref.get_single_view_obs(s, e, coordinate_system="raw"))
