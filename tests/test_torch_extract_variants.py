"""The port's streamed, sparse and backward-warp extraction on the CPU, against
each other and against the JAX package (Pallas in interpret mode).

- Dense at tile 1024 (``nphm_grid_sdf`` / ``npm_grid_sdf`` + ``mesh_from_logits``),
  ``extract_mesh_streamed`` (3 slabs) and ``extract_mesh_sparse``
  (``lip="auto"``) emit array-equal sorted vertex sets, f32 and f16 copies,
  NPHM and NPM (the NPM field's head bias shifted so its zero set crosses
  the box; the streamed path falls back to the float32 dense path for NPM,
  so there it matches the f32 dense mesh).
- Slab logits, the sparse coarse (min, max) and the fine block data match
  the JAX package's ``_slab_logits_run``, ``_coarse_run`` and ``_fine_run``
  within atol 1e-5 (the tolerance of ``tests/test_torch_ensemble.py``); the
  sparse ``stats`` counts equal the JAX package's.
- ``backward_grid_logits`` and ``get_logits_backward`` match the JAX
  package's ``pallas_backward_grid_logits`` and ``get_logits_backward``
  within atol 1e-4 (the configuration and tolerance of
  ``tests/test_pallas.py::test_backward_warp_grid_logits``); ``get_logits``
  and the deformation evaluator match JAX's within 1e-5.
- Edge cases: a field with no zero set gives empty meshes, a resolution
  with no brick (and not divisible by 16) falls back to the dense path,
  and a field steeper than ``lip`` warns.
"""

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
)
from nphm_tpu.ops.grid import create_grid_points_from_bounds
from nphm_tpu.reconstruction import extract as jextract
from nphm_tpu.reconstruction import sparse as jsparse
from nphm_tpu_torch.models import (
    DeepSDFConfig,
    DeformationConfig,
    NPHMConfig,
    make_deformation_decoder,
    make_nphm_decoder,
    make_npm_decoder,
)
from nphm_tpu_torch.ops.ensemble import grid_axes, grid_tile, nphm_grid_sdf
from nphm_tpu_torch.ops.marching import mesh_from_logits
from nphm_tpu_torch.ops.trunk import npm_grid_sdf
from nphm_tpu_torch.reconstruction import extract as ext
from nphm_tpu_torch.reconstruction import sparse as sp
from nphm_tpu_torch.utils.params import from_numpy_pytree

MINI, MAXI = (-0.55, -0.5, -0.95), (0.55, 0.75, 0.4)
RES = 48
ATOL = 1e-5  # K1's plain version against the Pallas kernel (test_torch_ensemble.py)
ATOL_WARP = 1e-4  # tests/test_pallas.py::test_backward_warp_grid_logits
TINY = dict(lat_dim_glob=8, lat_dim_loc=4, n_loc=6, n_symm_pairs=2, hidden_dim=16,
            n_layers=4, pos_mlp_dim=16)


def bridge(tree):
    return from_numpy_pytree(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _sorted(v):
    return v[np.lexsort(v.T)]


@pytest.fixture(scope="module")
def nphm():
    """The ``tiny_nphm`` of tests/test_sparse_extract.py, in both packages."""
    rng = np.random.default_rng(0)
    anchors = (rng.normal(size=(TINY["n_loc"], 3)) * 0.25).astype(np.float32)
    jd = jmake_nphm(JNPHMConfig(**TINY), anchors)
    jp = jd.init(jax.random.PRNGKey(0))
    lat = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (jd.cfg.lat_dim,)) * 0.1,
                     np.float32)
    return dict(jd=jd, jp=jp, td=make_nphm_decoder(NPHMConfig(**TINY), anchors),
                tp=bridge(jp), lat=lat)


@pytest.fixture(scope="module")
def npm():
    """A geometric-init NPM decoder whose head bias is shifted by the
    field's median over the box, so that its zero set crosses it."""
    dec = make_npm_decoder(DeepSDFConfig(lat_dim=16, hidden_dim=64, n_layers=4,
                                         geometric_init=True, radius_init=0.5))
    params = dec.init(torch.Generator().manual_seed(0), "cpu")
    lat = (np.random.default_rng(1).normal(size=16) * 0.01).astype(np.float32)
    field = npm_grid_sdf(params, dec.cfg, torch.tensor(lat), MINI, MAXI, RES)
    params["layers"][-1]["b"] -= field.median()
    return dict(td=dec, tp=params, lat=lat)


def dense_mesh(family, f, dtype):
    lat = torch.tensor(f["lat"])
    if family == "nphm":
        logits = nphm_grid_sdf(f["tp"], f["td"].cfg, lat, MINI, MAXI, RES, tile=1024)
    else:
        logits = npm_grid_sdf(f["tp"], f["td"].cfg, lat, MINI, MAXI, RES)
    logits = logits.numpy()
    if dtype is not None:
        logits = logits.astype(dtype).astype(np.float32)
    return mesh_from_logits(logits, MINI, MAXI, RES)


@pytest.mark.parametrize("dtype", [None, np.float16], ids=["f32", "f16"])
@pytest.mark.parametrize("family", ["nphm", "npm"])
def test_dense_streamed_sparse_emit_equal_vertices(family, dtype, nphm, npm):
    f = nphm if family == "nphm" else npm
    dense = dense_mesh(family, f, dtype)
    streamed = ext.extract_mesh_streamed(f["td"], f["tp"], f["lat"][None], MINI, MAXI, RES,
                                         n_slabs=3, transfer_dtype=dtype, tile=1024,
                                         device="cpu")
    stats = {}
    sparse = sp.extract_mesh_sparse(f["td"], f["tp"], f["lat"][None], MINI, MAXI, RES,
                                    lip="auto", transfer_dtype=dtype, stats=stats,
                                    device="cpu")
    # the streamed path falls back to the float32 dense path for NPM, as
    # the JAX package's does
    dense_streamed = dense_mesh(family, f, None) if family == "npm" else dense
    assert len(dense.vertices) > 1000
    assert stats["n_transferred"] <= stats["n_candidates"] <= stats["n_blocks"]
    assert len(dense_streamed.vertices) == len(streamed.vertices)
    assert len(dense.vertices) == len(sparse.vertices)
    assert len(dense_streamed.faces) == len(streamed.faces)
    assert len(dense.faces) == len(sparse.faces)
    assert np.array_equal(_sorted(dense_streamed.vertices), _sorted(streamed.vertices))
    assert np.array_equal(_sorted(dense.vertices), _sorted(sparse.vertices))


def test_slab_logits_match_jax(nphm):
    f = nphm
    tile, brick = grid_tile(RES, 1024)
    n_slabs = ext._pick_n_slabs(RES, brick[0], 3)
    assert n_slabs == 3
    axes = grid_axes(MINI, MAXI, RES, "cpu")
    for k in (0, 2):
        got = ext.slab_logits(f["tp"], f["td"].cfg, torch.tensor(f["lat"]), axes, RES,
                              n_slabs, brick, tile, k)
        ref = jextract._slab_logits_run(f["jd"].cfg, MINI, MAXI, RES, n_slabs, tile, True,
                                        None, (), f["jp"], jnp.asarray(f["lat"]),
                                        jnp.int32(k))
        assert got.shape == ref.shape == (RES // 3, RES, RES)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("lip", ["auto", 12.0])
def test_sparse_passes_and_stats_match_jax(nphm, lip):
    f = nphm
    lat = torch.tensor(f["lat"])
    axes = grid_axes(MINI, MAXI, RES, "cpu")
    cmm = sp.coarse_pass(f["td"], f["tp"], lat, axes, RES)
    ref = jsparse._coarse_run(f["jd"].cfg, MINI, MAXI, RES, True, (), f["jp"],
                              jnp.asarray(f["lat"]))
    np.testing.assert_allclose(cmm.numpy(), np.asarray(ref), atol=ATOL, rtol=0)

    ids = np.arange(0, 108, 5)
    data, fmm = sp.fine_pass(f["td"], f["tp"], lat, axes, RES, torch.as_tensor(ids))
    rdata, rmm = jsparse._fine_run(f["jd"].cfg, MINI, MAXI, RES, True, None, (), f["jp"],
                                   jnp.asarray(f["lat"]), jnp.asarray(ids, jnp.int32))
    np.testing.assert_allclose(data.numpy().reshape(-1, *sp.BLOCK), np.asarray(rdata),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(fmm.numpy(), np.asarray(rmm), atol=ATOL, rtol=0)

    stats, jstats = {}, {}
    mesh = sp.extract_mesh_sparse(f["td"], f["tp"], f["lat"], MINI, MAXI, RES, lip=lip,
                                  stats=stats, device="cpu")
    jmesh = jsparse.extract_mesh_sparse(f["jd"], f["jp"], f["lat"], MINI, MAXI, RES,
                                        lip=lip, stats=jstats, interpret=True)
    for key in ("n_blocks", "n_candidates", "n_transferred"):
        assert stats[key] == jstats[key], (key, stats, jstats)
    np.testing.assert_allclose(stats["lip_observed"], jstats["lip_observed"], rtol=1e-4)
    assert mesh.vertices.shape == jmesh.vertices.shape


@pytest.fixture(scope="module")
def warp():
    """The configuration of tests/test_pallas.py::test_backward_warp_grid_logits."""
    kw = dict(lat_dim_glob=16, lat_dim_loc=8, n_loc=7, n_symm_pairs=3, hidden_dim=40,
              n_layers=4, pos_mlp_dim=32)
    dkw = dict(mode="glob_only", lat_dim_glob_shape=16, lat_dim_expr=8, hidden_dim=48,
               n_layers=4)
    rng = np.random.default_rng(0)
    anchors = (rng.normal(size=(7, 3)) * 0.3).astype(np.float32)
    jd = jmake_nphm(JNPHMConfig(**kw), anchors)
    jp = jd.init(jax.random.PRNGKey(0))
    lat = jax.random.normal(jax.random.PRNGKey(1), (1, jd.cfg.lat_dim)) * 0.1
    je = jmake_deformation(JDeformationConfig(**dkw))
    jpe = je.init(jax.random.PRNGKey(7))
    lat_cond = jnp.concatenate([lat[0, :16], jnp.full((8,), 0.05)])
    return dict(jd=jd, jp=jp, je=je, jpe=jpe, lat=np.asarray(lat[0]),
                lat_cond=np.asarray(lat_cond),
                td=make_nphm_decoder(NPHMConfig(**kw), anchors), tp=bridge(jp),
                te=make_deformation_decoder(DeformationConfig(**dkw)), tpe=bridge(jpe))


def test_backward_warp_matches_jax(warp):
    w, res = warp, 32
    pts = create_grid_points_from_bounds(MINI, MAXI, res)
    ref = np.asarray(jextract.get_logits_backward(w["jd"], w["je"], w["jp"], w["jpe"],
                                                  w["lat"], w["lat_cond"], pts,
                                                  chunk_size=2048))
    ref_grid = np.asarray(jextract.pallas_backward_grid_logits(
        w["jd"], w["je"], w["jp"], w["jpe"], w["lat"], w["lat_cond"], MINI, MAXI, res,
        chunk_size=2048, interpret=True))
    got = ext.get_logits_backward(w["td"], w["te"], w["tp"], w["tpe"], w["lat"],
                                  w["lat_cond"], pts, chunk_size=2048, device="cpu")
    got_grid = ext.backward_grid_logits(w["td"], w["te"], w["tp"], w["tpe"], w["lat"],
                                        w["lat_cond"], MINI, MAXI, res, chunk_size=2048,
                                        device="cpu")
    assert got.shape == got_grid.shape == (res**3,)
    np.testing.assert_allclose(got, ref, atol=ATOL_WARP, rtol=0)
    np.testing.assert_allclose(got_grid, ref_grid, atol=ATOL_WARP, rtol=0)
    np.testing.assert_allclose(got_grid, ref, atol=ATOL_WARP, rtol=0)
    # no expression code: the identity field alone
    plain = ext.backward_grid_logits(w["td"], w["te"], w["tp"], w["tpe"], w["lat"], None,
                                     MINI, MAXI, res, device="cpu")
    np.testing.assert_allclose(plain, ext.get_logits(w["td"], w["tp"], w["lat"], pts,
                                                     device="cpu"), atol=ATOL, rtol=0)


def test_point_evaluators_match_jax(warp):
    w = warp
    pts = (np.random.default_rng(2).normal(size=(3000, 3)) * 0.4).astype(np.float32)
    ref = np.asarray(jextract.get_logits(w["jd"], w["jp"], w["lat"], pts, chunk_size=1024))
    got = ext.get_logits(w["td"], w["tp"], w["lat"], pts, chunk_size=1024, device="cpu")
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    jeval = jextract.make_deform_evaluator(w["je"], chunk_size=1024)
    ref = jeval({"params": w["jpe"], "lat": jnp.asarray(w["lat_cond"])[None],
                 "anchors": None}, pts)
    teval = ext.make_deform_evaluator(w["te"], chunk_size=1024, device="cpu")
    got = teval({"params": w["tpe"], "lat": torch.tensor(w["lat_cond"]), "anchors": None},
                pts)
    assert got.shape == (3000, 3)
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL, rtol=0)


def test_field_without_surface_gives_empty_meshes(nphm):
    f = nphm
    mini, maxi = (5.0, 5.0, 5.0), (6.0, 6.0, 6.0)
    logits = nphm_grid_sdf(f["tp"], f["td"].cfg, torch.tensor(f["lat"]), mini, maxi, RES,
                           tile=1024)
    assert bool((logits > 0).all())  # constant sign: no zero set in the box
    for mesh in (
        sp.extract_mesh_sparse(f["td"], f["tp"], f["lat"], mini, maxi, RES, lip=1e6,
                               device="cpu"),
        ext.extract_mesh_streamed(f["td"], f["tp"], f["lat"], mini, maxi, RES, n_slabs=3,
                                  device="cpu"),
    ):
        assert mesh.vertices.shape == (0, 3) and mesh.faces.shape == (0, 3)


def test_resolution_without_blocks_falls_back_to_dense(nphm):
    f = nphm
    res = 40  # not a multiple of 16, and no 1024- or 2048-point brick
    assert grid_tile(res, 2048)[1] is None
    dense = ext.extract_mesh(f["td"], f["tp"], f["lat"], MINI, MAXI, res, device="cpu")
    assert len(dense.vertices) > 0
    for mesh in (
        sp.extract_mesh_sparse(f["td"], f["tp"], f["lat"], MINI, MAXI, res, device="cpu"),
        ext.extract_mesh_streamed(f["td"], f["tp"], f["lat"], MINI, MAXI, res,
                                  device="cpu"),
    ):
        np.testing.assert_array_equal(mesh.vertices, dense.vertices)
        np.testing.assert_array_equal(mesh.faces, dense.faces)


def test_field_steeper_than_lip_warns(nphm):
    f = nphm
    stats = {}
    with pytest.warns(RuntimeWarning, match="Lipschitz"):
        sp.extract_mesh_sparse(f["td"], f["tp"], f["lat"], MINI, MAXI, RES, lip=0.05,
                               stats=stats, device="cpu")
    assert stats["lip_observed"] > 0.05
