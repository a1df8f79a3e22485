"""PyTorch port vs the JAX package: models, config and the weight bridge.

Both packages get the same weights (the JAX ``Decoder.init``, bridged with
``from_numpy_pytree``) and the same numpy inputs; every comparison is fp32
on the CPU at atol 1e-5 (only summation order differs).
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from nphm_tpu.models import (
    DeformationConfig as JDeformationConfig,
    NPHMConfig as JNPHMConfig,
    make_deformation_decoder as jmake_deformation,
    make_nphm_decoder as jmake_nphm,
    predict_anchors as jpredict_anchors,
)
from nphm_tpu.utils.math import inv3x3 as jinv3x3
from nphm_tpu_torch.models import (
    DeformationConfig,
    NPHMConfig,
    make_deformation_decoder,
    make_nphm_decoder,
    predict_anchors,
)
from nphm_tpu_torch.utils.math import inv3x3
from nphm_tpu_torch.utils.params import from_numpy_pytree, to_numpy_pytree

ATOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE_KW = dict(lat_dim_glob=8, lat_dim_loc=4, n_loc=6, n_symm_pairs=2,
                hidden_dim=16, n_layers=4, pos_mlp_dim=16)


def bridge(tree):
    return from_numpy_pytree(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def shape_pair(seed=0):
    rng = np.random.default_rng(seed)
    anchors = (rng.normal(size=(SHAPE_KW["n_loc"], 3)) * 0.25).astype(np.float32)
    jd = jmake_nphm(JNPHMConfig(**SHAPE_KW), anchors)
    td = make_nphm_decoder(NPHMConfig(**SHAPE_KW), anchors)
    jp = jd.init(jax.random.PRNGKey(seed))
    return jd, jp, td, bridge(jp)


def deform_pair(mode, seed=1):
    kw = dict(mode=mode, lat_dim_glob_shape=8, lat_dim_loc_shape=4, n_loc=6,
              lat_dim_expr=8, lat_dim_id=8, hidden_dim=32, n_layers=4)
    jd = jmake_deformation(JDeformationConfig(**kw))
    td = make_deformation_decoder(DeformationConfig(**kw))
    jp = jd.init(jax.random.PRNGKey(seed))
    return jd, jp, td, bridge(jp)


@pytest.mark.parametrize("training", [False, True])
def test_apply_nphm_matches_jax(training):
    jd, jp, td, tp = shape_pair()
    rng = np.random.default_rng(1)
    xyz = (rng.normal(size=(2, 257, 3)) * 0.3).astype(np.float32)
    lat = (rng.normal(size=(2, jd.lat_dim)) * 0.1).astype(np.float32)
    ref, ref_a = jd.apply(jp, jnp.asarray(xyz), jnp.asarray(lat), training=training)
    out, out_a = td.apply(tp, torch.tensor(xyz), torch.tensor(lat), training=training)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(out_a.numpy(), np.asarray(ref_a), atol=ATOL)


def test_eval_mode_pins_background_member():
    """Far from every anchor only the background member weighs in: eval
    mode blends its pinned SDF of 1 with the background's normalized weight
    (the 1e-6 floor dominates the normalizer); train mode does not."""
    _jd, _jp, td, tp = shape_pair()
    far = torch.full((1, 4, 3), 5.0)
    lat = torch.zeros((1, td.lat_dim))
    sdf_eval, _ = td.apply(tp, far, lat, training=False)
    sdf_train, _ = td.apply(tp, far, lat, training=True)
    w_bg = np.exp(td.cfg.blend_background_dist / td.cfg.blend_var)
    np.testing.assert_allclose(sdf_eval.numpy(), w_bg / (w_bg + 1e-6), rtol=1e-4)
    assert np.abs(sdf_train.numpy() - sdf_eval.numpy()).max() > 1e-6


def test_predict_anchors_matches_jax():
    jd, jp, _td, tp = shape_pair(seed=2)
    lat = (np.random.default_rng(3).normal(size=(3, jd.lat_dim)) * 0.5).astype(np.float32)
    ref = jpredict_anchors(jp, jd.cfg, jnp.asarray(lat))
    out = predict_anchors(tp, NPHMConfig(**SHAPE_KW), torch.tensor(lat))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


DEFORM_CASES = [pytest.param(m, False, id=m) for m in
                ("compress", "glob_only", "expr_only", "interpolate", "GNN")]
DEFORM_CASES += [pytest.param(m, True, id=f"{m}-train") for m in ("interpolate", "GNN")]


@pytest.mark.parametrize("mode,training", DEFORM_CASES)
def test_apply_deformation_matches_jax(mode, training):
    """Every mode in eval mode; GNN and interpolate at train time too, which
    adds no noise in either (only compress draws it, tested with the loss in
    ``test_torch_train_corresp.py``)."""
    jd, jp, td, tp = deform_pair(mode)
    rng = np.random.default_rng(4)
    cfg = jd.cfg
    xyz = (rng.normal(size=(2, 300, 3)) * 0.3).astype(np.float32)
    lat = (rng.normal(size=(2, cfg.lat_dim_shape_full + cfg.lat_dim_expr)) * 0.1)
    lat = lat.astype(np.float32)
    anchors = (rng.normal(size=(2, cfg.n_loc, 3)) * 0.3).astype(np.float32)
    ref, _ = jd.apply(jp, jnp.asarray(xyz), jnp.asarray(lat), jnp.asarray(anchors),
                      training=training, rng=jax.random.PRNGKey(0) if training else None)
    out, _ = td.apply(tp, torch.tensor(xyz), torch.tensor(lat), torch.tensor(anchors),
                      training=training)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_weight_bridge_round_trip():
    _jd, jp, _td, tp = shape_pair()
    back = to_numpy_pytree(tp)
    flat_ref = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jp))
    flat_out = jax.tree_util.tree_leaves(back)
    assert len(flat_ref) == len(flat_out)
    for a, b in zip(flat_ref, flat_out):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert sorted(tp) == ["ensemble", "mean_anchors", "mlp_pos"]
    assert sorted(tp["ensemble"][0]) == ["b", "w"]


def test_torch_init_matches_jax_distributions():
    """Generator-drawn inits: same shapes and U(+-1/sqrt(fan_in)) bounds as
    the JAX inits, and identical draws from identical torch seeds."""
    jd, jp, td, _ = shape_pair()
    tp = td.init(torch.Generator().manual_seed(0), "cpu")
    tp2 = td.init(torch.Generator().manual_seed(0), "cpu")
    ref = jax.tree_util.tree_map(np.asarray, jp)
    for i, lay in enumerate(tp["ensemble"]):
        w = lay["w"].numpy()
        assert w.shape == ref["ensemble"][i]["w"].shape
        bound = 1.0 / np.sqrt(w.shape[-1])
        assert np.abs(w).max() <= bound and np.abs(w).max() > 0.5 * bound
        np.testing.assert_array_equal(w, tp2["ensemble"][i]["w"].numpy())
    _, _, te, _ = deform_pair("compress")
    pe = te.init(torch.Generator().manual_seed(1), "cpu")
    assert pe["compressor"]["w"].shape == (8, te.cfg.compressor_in)


def test_inv3x3_matches_jax():
    m = np.random.default_rng(5).normal(size=(64, 3, 3)).astype(np.float32)
    m += 3 * np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(
        inv3x3(torch.tensor(m)).numpy(), np.asarray(jinv3x3(jnp.asarray(m))), atol=ATOL
    )


def test_config_reads_the_shipped_yaml():
    from nphm_tpu import config as jconfig
    from nphm_tpu_torch import config

    cfg_s = config.load_yaml(os.path.join(ROOT, "configs", "nphm.yaml"))
    cfg_e = config.load_yaml(os.path.join(ROOT, "configs", "nphm_def.yaml"))
    anchors = np.zeros((39, 3), np.float32)
    shape = config.build_identity_decoder(cfg_s["decoder"], local=True,
                                          mean_anchors=anchors)
    expr = config.build_expression_decoder(cfg_e, "compress")
    jexpr = jconfig.build_expression_decoder(cfg_e, "compress")
    assert shape.cfg.layer_shapes == JNPHMConfig().layer_shapes
    assert expr.cfg.trunk_cfg.layer_shapes == jexpr.cfg.trunk_cfg.layer_shapes
    assert expr.lat_dim == jexpr.lat_dim == 200
    cfg_npm = config.load_yaml(os.path.join(ROOT, "configs", "npm_def.yaml"))
    assert config.build_expression_decoder(cfg_npm, "npm").kind == "deformation_npm"
    lam, sched = config.fitting_overrides_from_cfg(
        {"lambdas": {"surface": 3.0}, "schedule": {"lr": {"100": 2}}}
    )
    assert lam == jconfig.fitting_overrides_from_cfg(
        {"lambdas": {"surface": 3.0}})[0]
    assert sched == {"lr": {100: 2.0}}
