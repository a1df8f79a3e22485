"""The port's NPM family (global DeepSDF identity decoder + DeepSDF offsets
network) vs the JAX package, on the CPU.

- Decoders and config constructors: the NPM identity decoder and the
  ``deformation_npm`` handle at atol 1e-5 on bridged JAX weights; the
  shipped ``configs/npm*.yaml`` build the same architectures; the seeded
  torch inits have the JAX inits' shapes and distributions.
- ``fit_joint`` for 5 steps on the JAX fit's own draws, ``fused_search``
  "on" and "off", vs the JAX fit (Pallas search in interpret mode): latents
  and loss at rtol 1e-3 / atol 5e-4, as the NPHM slice test.
- ``extract_mesh`` (K7's dense-grid wrapper, plain on the CPU) and
  ``deform_mesh_batch`` from the JAX fit's latents: vertices at 1e-5.
- The K2 shared-memory gate: "auto" skips the production NPM offsets trunk.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from nphm_tpu import config as jconfig
from nphm_tpu.fitting import FittingConfig as JFittingConfig, fit_joint as jfit_joint
from nphm_tpu.models import DeepSDFConfig as JDeepSDFConfig, make_npm_decoder as jmake_npm
from nphm_tpu.reconstruction.extract import (
    deform_mesh_batch as jdeform_mesh_batch,
    extract_mesh as jextract_mesh,
)
from nphm_tpu_torch import config
from nphm_tpu_torch.fitting import inference
from nphm_tpu_torch.fitting.inference import FittingConfig, fit_joint
from nphm_tpu_torch.models import DeepSDFConfig, make_npm_decoder
from nphm_tpu_torch.reconstruction.extract import deform_mesh_batch, extract_mesh
from nphm_tpu_torch.utils.params import from_numpy_pytree

from test_torch_slice import assert_same_vertices, jax_draws, nonrigid_observations

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ID_KW = dict(lat_dim=16, hidden_dim=32, n_layers=4, radius_init=0.4)
EXPR_CFG = {"id_decoder": {"decoder_lat_dim": 16},
            "ex_decoder": {"decoder_lat_dim": 8, "decoder_hidden_dim": 32,
                           "decoder_nlayers": 4}}
FIT = dict(n_steps=5, n_obs_per_batch=2, n_points_per_obs=64, log_every=10**9)
MINI, MAXI = (-1.1, -1.1, -1.1), (1.1, 1.1, 1.1)


def bridge(tree):
    return from_numpy_pytree(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def npm_decoders():
    js = jmake_npm(JDeepSDFConfig(**ID_KW))
    je = jconfig.build_expression_decoder(EXPR_CFG, "npm")
    ts = make_npm_decoder(DeepSDFConfig(**ID_KW))
    te = config.build_expression_decoder(EXPR_CFG, "npm")
    return js, je, ts, te


@pytest.mark.parametrize("which", ["identity", "offsets"])
def test_npm_decoders_match_jax(which):
    js, je, ts, te = npm_decoders()
    jd, td = (js, ts) if which == "identity" else (je, te)
    assert td.kind == jd.kind and td.lat_dim == jd.lat_dim
    jp = jd.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    xyz = (rng.normal(size=(2, 257, 3)) * 0.4).astype(np.float32)
    lat = (rng.normal(size=(2, jd.cfg.lat_dim)) * 0.1).astype(np.float32)
    # the offsets network ignores anchors, as its JAX counterpart does
    kw = {} if which == "identity" else {"anchors": np.zeros((2, 5, 3), np.float32)}
    ref, ref_a = jd.apply(jp, jnp.asarray(xyz), jnp.asarray(lat), **kw)
    out, out_a = td.apply(bridge(jp), torch.tensor(xyz), torch.tensor(lat), **kw)
    assert ref_a is None and out_a is None
    assert out.shape == ref.shape == (2, 257, 1 if which == "identity" else 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_config_builds_npm_from_shipped_yaml():
    cfg_s = config.load_yaml(os.path.join(ROOT, "configs", "npm.yaml"))
    cfg_e = config.load_yaml(os.path.join(ROOT, "configs", "npm_def.yaml"))
    for local_dec, jax_dec in (
        (config.build_identity_decoder(cfg_s["decoder"], local=False),
         jconfig.build_identity_decoder(cfg_s["decoder"], local=False)),
        (config.build_expression_decoder(cfg_e, "npm"),
         jconfig.build_expression_decoder(cfg_e, "npm")),
    ):
        assert local_dec.kind == jax_dec.kind
        assert local_dec.lat_dim == jax_dec.lat_dim
        assert local_dec.cfg.layer_shapes == jax_dec.cfg.layer_shapes
        for f in ("lat_dim", "hidden_dim", "n_layers", "geometric_init", "out_dim"):
            assert getattr(local_dec.cfg, f) == getattr(jax_dec.cfg, f)
    ident = config.build_identity_decoder(cfg_s["decoder"], local=False)
    assert (ident.kind, ident.cfg.lat_dim, ident.cfg.hidden_dim) == ("npm", 512, 1024)
    offsets = config.build_expression_decoder(cfg_e, "npm")
    assert (offsets.kind, offsets.lat_dim, offsets.cfg.lat_dim) == ("deformation_npm", 200,
                                                                     712)
    assert offsets.cfg.out_dim == 3 and not offsets.cfg.geometric_init


def test_npm_init_matches_jax_distributions():
    """Seeded torch inits: the JAX inits' shapes, U(+-1/sqrt(fan_in)) for
    every layer but the identity head, the geometric head (w ~ sqrt(pi /
    fan_in) + 1e-5 N(0, 1), b = -radius), identical draws from one seed."""
    js, je, ts, te = npm_decoders()
    for jd, td in ((js, ts), (je, te)):
        ref = jax.tree_util.tree_map(np.asarray, jd.init(jax.random.PRNGKey(0)))
        tp = td.init(torch.Generator().manual_seed(0), "cpu")
        tp2 = td.init(torch.Generator().manual_seed(0), "cpu")
        n = len(ref["layers"])
        assert len(tp["layers"]) == n
        for i, lay in enumerate(tp["layers"]):
            w, b = lay["w"].numpy(), lay["b"].numpy()
            assert w.shape == ref["layers"][i]["w"].shape
            assert b.shape == ref["layers"][i]["b"].shape
            np.testing.assert_array_equal(w, tp2["layers"][i]["w"].numpy())
            if td.cfg.geometric_init and i == n - 1:
                mean = np.sqrt(np.pi / w.shape[1])
                assert np.abs(w - mean).max() < 1e-4
                np.testing.assert_allclose(w, ref["layers"][i]["w"], atol=1e-4)
                np.testing.assert_array_equal(b, np.float32(-td.cfg.radius_init))
            else:
                bound = 1.0 / np.sqrt(w.shape[1])
                assert np.abs(w).max() <= bound and np.abs(w).max() > 0.5 * bound


@pytest.fixture(scope="module")
def fitted():
    """A random NPM field is nearly constant: its U(+-1/sqrt(fan_in)) hidden
    layers damp the spatial signal layer by layer, and only the head has the
    geometric init.  A flat field's vertex positions are ill-conditioned
    (fp32 rounding / |grad|), so the hidden weights are scaled by 3, and the
    head bias is shifted by the field's median over the observed points,
    which puts the zero set through them."""
    js, je, ts, te = npm_decoders()
    jps, jpe = js.init(jax.random.PRNGKey(0)), je.init(jax.random.PRNGKey(1))
    for lay in jps["layers"][:-1]:
        lay["w"] = lay["w"] * 3.0
    obs = nonrigid_observations(np.random.default_rng(3))
    sdf, _ = js.apply(jps, jnp.asarray(np.concatenate(obs))[None], jnp.zeros((1, 16)))
    jps["layers"][-1]["b"] = jps["layers"][-1]["b"] - jnp.median(sdf)
    ref = jfit_joint(js, jps, je, jpe, obs,
                     cfg=JFittingConfig(fused_search="on", fused_shape_fields="on", **FIT),
                     verbose=False)
    draws = jax_draws(0, obs, FIT["n_steps"], FIT["n_obs_per_batch"],
                      FIT["n_points_per_obs"])
    return dict(js=js, jps=jps, je=je, jpe=jpe, ts=ts, tps=bridge(jps), te=te,
                tpe=bridge(jpe), obs=obs, ref=ref, draws=draws)


@pytest.mark.parametrize("fused", ["on", "off"])
def test_npm_fit_joint_matches_jax(fitted, fused):
    f = fitted
    le, ls, anchors, hist = fit_joint(
        f["ts"], f["tps"], f["te"], f["tpe"], f["obs"],
        cfg=FittingConfig(fused_search=fused, fused_shape_fields=fused, **FIT),
        verbose=False, sample_draws=f["draws"], device="cpu",
    )
    rle, rls, ranchors, rhist = f["ref"]
    assert anchors is None and ranchors is None
    np.testing.assert_allclose(ls, rls, rtol=1e-3, atol=5e-4)
    np.testing.assert_allclose(le, rle, rtol=1e-3, atol=5e-4)
    np.testing.assert_allclose(hist["loss"], rhist["loss"], rtol=1e-3, atol=1e-5)
    for k in ("reg_global", "surface"):
        np.testing.assert_allclose(hist[k], rhist[k], rtol=1e-3, atol=1e-5)
    for k in ("reg_loc", "reg_unobserved", "symm_dist"):
        assert not hist[k].any() and not np.asarray(rhist[k]).any()
    np.testing.assert_array_equal(hist["n_valid"], rhist["n_valid"])
    assert hist["n_valid"].min() > 0 and hist["surface"].max() > 0
    np.testing.assert_array_equal(hist["broyden_iters"], rhist["broyden_iters"])


def test_npm_extract_and_deform_match_jax(fitted):
    f = fitted
    rle, rls, _, _ = f["ref"]
    ref = jextract_mesh(f["js"], f["jps"], rls, MINI, MAXI, 32, use_pallas=True)
    mesh = extract_mesh(f["ts"], f["tps"], rls, MINI, MAXI, 32, device="cpu")
    assert len(mesh.vertices) > 0
    assert mesh.faces.shape == ref.faces.shape
    assert_same_vertices(mesh.vertices, ref.vertices)

    posed_ref = jdeform_mesh_batch(ref, f["je"], f["jpe"], rle, lat_shape=rls)
    posed = deform_mesh_batch(ref, f["te"], f["tpe"], rle, lat_shape=rls, device="cpu")
    assert len(posed) == len(posed_ref) == len(f["obs"])
    for a, b in zip(posed, posed_ref):
        np.testing.assert_allclose(a.vertices, b.vertices, atol=1e-5)
        np.testing.assert_array_equal(a.faces, b.faces)


@pytest.mark.parametrize("mode,device,npm,nphm", [
    ("auto", "cuda", False, True),
    ("auto", "cpu", False, False),
    ("on", "cpu", True, True),
])
def test_k2_shared_memory_gate(mode, device, npm, nphm):
    """K2 takes layers at most 512 wide (the NPM offsets trunk's are 1024;
    its shared memory would be 169,632 bytes) and needs 104,096 bytes of
    shared memory at the NPHM 6x512 trunk (the card gives a block 232,448):
    "auto" fuses only the latter; "on" always routes to K2."""
    from nphm_tpu_torch.ops.search import search_smem_bytes

    npm_dec = config.build_expression_decoder(
        config.load_yaml(os.path.join(ROOT, "configs", "npm_def.yaml")), "npm")
    nphm_dec = config.build_expression_decoder(
        config.load_yaml(os.path.join(ROOT, "configs", "nphm_def.yaml")), "compress")
    assert search_smem_bytes(npm_dec.cfg) == 169632
    assert search_smem_bytes(nphm_dec.cfg.trunk_cfg) == 104096
    cfg = FittingConfig(fused_search=mode)
    dev = torch.device(device)
    assert inference._use_fused_search(npm_dec, cfg, dev) is npm
    assert inference._use_fused_search(nphm_dec, cfg, dev) is nphm
