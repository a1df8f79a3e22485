"""K1's plain version and dense-grid evaluation vs the JAX Pallas ensemble kernel.

``nphm_sdf`` on a CPU tensor runs ``nphm_sdf_plain``; it is held against
``nphm_sdf_pallas`` / ``nphm_grid_sdf_pallas`` in interpret mode (fp32,
atol 1e-5: only summation order differs), with member culling on and off
and point counts that are not tile multiples.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from nphm_tpu.models import NPHMConfig as JNPHMConfig, make_nphm_decoder as jmake
from nphm_tpu.ops import pallas_ensemble as jens
from nphm_tpu_torch.models import NPHMConfig, make_nphm_decoder
from nphm_tpu_torch.ops import ensemble as ens
from nphm_tpu_torch.utils.params import from_numpy_pytree

ATOL = 1e-5
KW = dict(lat_dim_glob=8, lat_dim_loc=4, n_loc=7, n_symm_pairs=3, hidden_dim=16,
          n_layers=4, pos_mlp_dim=16)
MINI, MAXI = (-0.55, -0.5, -0.95), (0.55, 0.75, 0.4)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    anchors = (rng.normal(size=(KW["n_loc"], 3)) * 0.3).astype(np.float32)
    jd = jmake(JNPHMConfig(**KW), anchors)
    jp = jd.init(jax.random.PRNGKey(0))
    tp = from_numpy_pytree(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    lat = (rng.normal(size=(jd.lat_dim,)) * 0.1).astype(np.float32)
    return jd, jp, make_nphm_decoder(NPHMConfig(**KW), anchors), tp, lat


@pytest.mark.parametrize("cull_eps", [0.0, ens.CULL_EPS, 1e-2])
def test_nphm_sdf_matches_pallas(pair, cull_eps):
    jd, jp, td, tp, lat = pair
    xyz = (np.random.default_rng(1).normal(size=(1500, 3)) * 0.3).astype(np.float32)
    ref = jens.nphm_sdf_pallas(jp, jd.cfg, jnp.asarray(xyz), jnp.asarray(lat),
                               tile=1024, cull_eps=cull_eps, interpret=True)
    out = ens.nphm_sdf(tp, td.cfg, torch.tensor(xyz), torch.tensor(lat), tile=1024,
                       cull_eps=cull_eps)
    assert out.shape == (1500,)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_nphm_sdf_matches_eval_decoder(pair):
    """Without culling the fused semantics are the eval-mode decoder's."""
    _jd, _jp, td, tp, lat = pair
    xyz = torch.tensor(np.random.default_rng(2).normal(size=(300, 3)) * 0.3,
                       dtype=torch.float32)
    ref, _ = td.apply(tp, xyz[None], torch.tensor(lat)[None], training=False)
    out = ens.nphm_sdf(tp, td.cfg, xyz, torch.tensor(lat), tile=256, cull_eps=0.0)
    np.testing.assert_allclose(out.numpy(), ref[0, :, 0].numpy(), atol=ATOL)


@pytest.mark.parametrize("res,cull_eps", [(16, 1e-3), (20, ens.CULL_EPS)])
def test_grid_sdf_matches_pallas(pair, res, cull_eps):
    jd, jp, td, tp, lat = pair
    ref = jens.nphm_grid_sdf_pallas(jp, jd.cfg, jnp.asarray(lat), MINI, MAXI, res,
                                    tile=1024, cull_eps=cull_eps, interpret=True)
    out = ens.nphm_grid_sdf(tp, td.cfg, torch.tensor(lat), MINI, MAXI, res,
                            tile=1024, cull_eps=cull_eps)
    assert out.shape == (res**3,)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("res,tile", [(256, 2048), (400, 2048), (64, 1024), (20, 1024)])
def test_brick_helpers_match_jax(res, tile):
    assert ens._brick_shape(res, tile) == jens._brick_shape(res, tile)
    tile_t, brick = ens.grid_tile(res, tile)
    if res <= 64:
        lin = np.arange(res**3)
        axes_j = [jnp.linspace(0.0, 1.0, res) for _ in range(3)]
        axes_t = [torch.linspace(0.0, 1.0, res) for _ in range(3)]
        pj = jens._brick_points(axes_j, jnp.asarray(lin), res, brick, tile_t)
        pt = ens._brick_points(axes_t, torch.tensor(lin), res, brick, tile_t)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-7)
        gj = jens._unbrick_gather(res, brick, tile_t)
        gt = ens._unbrick_gather(res, brick, tile_t, "cpu")
        np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))


def test_cpu_tensors_take_the_plain_version(pair):
    _jd, _jp, td, tp, lat = pair
    before = ens.nphm_sdf.launches
    ens.nphm_sdf(tp, td.cfg, torch.zeros((10, 3)), torch.tensor(lat))
    assert ens.nphm_sdf.launches == before


@pytest.mark.parametrize("cull_eps", [0.0, ens.CULL_EPS, 1e-2])
def test_work_list_blend_matches_plain_and_pallas(pair, cull_eps):
    """K1's schedule in plain PyTorch (the compacted list of live (tile,
    member) pairs, each tile's members blended in the list's order) equals
    nphm_sdf_plain and the Pallas kernel in interpret mode, with culling
    off, at the default eps and at 1e-2 (most pairs culled)."""
    jd, jp, td, tp, lat = pair
    xyz = (np.random.default_rng(3).normal(size=(3000, 3)) * 0.3).astype(np.float32)
    xyz = xyz[np.argsort(xyz[:, 0])]  # tiles of nearby points, so culling fires
    ref = jens.nphm_sdf_pallas(jp, jd.cfg, jnp.asarray(xyz), jnp.asarray(lat),
                               tile=1024, cull_eps=cull_eps, interpret=True)
    plain = ens.nphm_sdf_plain(tp, td.cfg, torch.tensor(xyz), torch.tensor(lat), tile=1024,
                               cull_eps=cull_eps)
    out = ens.nphm_sdf_work_list_plain(tp, td.cfg, torch.tensor(xyz), torch.tensor(lat),
                                       tile=1024, cull_eps=cull_eps)
    assert out.shape == (3000,)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_work_list_order():
    """The list holds exactly the live pairs, tile-major, members
    ascending; a tile with no live member has an empty range."""
    active = torch.tensor([[0, 1, 1, 0], [0, 0, 0, 0], [1, 0, 0, 1], [1, 1, 1, 1]],
                          dtype=torch.int32)
    offsets, members = ens.work_list(active)
    assert offsets.dtype == members.dtype == torch.int32
    assert offsets.tolist() == [0, 2, 2, 4, 8]
    assert members.tolist() == [1, 2, 0, 3, 0, 1, 2, 3]


def test_points_per_block_match_csrc():
    """ops.ensemble.POINTS is K1's block (csrc/tc_tile.cuh kRows points,
    reported by nphm_ensemble_points_per_block), and the cull tiles of
    ``nphm_sdf`` and ``nphm_grid_sdf`` are whole blocks."""
    import os
    import re

    csrc = os.path.join(os.path.dirname(ens.__file__), "..", "csrc")
    with open(os.path.join(csrc, "tc_tile.cuh")) as f:
        rows = int(re.search(r"constexpr int kRows = (\d+);", f.read()).group(1))
    with open(os.path.join(csrc, "ensemble_sdf.cu")) as f:
        src = f.read()
    assert "nphm_ensemble_points_per_block() { return field::kRows; }" in src
    assert "kernel<<<(unsigned)(n_points / field::kRows), field::kThreads," in src
    assert ens.POINTS == rows == 64
    assert ens.DEFAULT_TILE % rows == 0 and ens.grid_tile(256)[0] % rows == 0
