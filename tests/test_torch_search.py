"""K2's plain version vs the JAX fused Broyden-search kernel, and the plain
search / IFT correction vs the JAX XLA path.

``broyden_search`` on CPU tensors runs ``broyden_search_plain``; it is held
against ``broyden_search_pallas(interpret=True)`` cold (identity J^-1 at
the observations) and warm (resuming an earlier search), with a runtime
budget and point counts that are not tile multiples.  Tolerances: roots
and residual norms atol 1e-5 (fp32, summation order only); validity masks
identical up to one lane flipped at the 1e-6 threshold; executed
iterations equal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from nphm_tpu.fitting.broyden import ift_correction as jift, search as jsearch
from nphm_tpu.models import (
    DeformationConfig as JDeformationConfig,
    make_deformation_decoder as jmake,
)
from nphm_tpu.models.deformation import _conditioning as jconditioning
from nphm_tpu.ops.pallas_search import broyden_search_pallas, search_pallas
from nphm_tpu_torch.fitting.broyden import ift_correction, search
from nphm_tpu_torch.fitting.inference import FittingConfig, _use_fused_search
from nphm_tpu_torch.models import DeformationConfig, make_deformation_decoder
from nphm_tpu_torch.models.deformation import conditioning
from nphm_tpu_torch.ops.search import broyden_search, search_fusable, search_fused
from nphm_tpu_torch.utils.params import from_numpy_pytree

ATOL = 1e-5


def setup(mode="compress", n_pts=700, nb=2, seed=0, cond_scale=0.1, gain=1.0):
    """Decoders, bridged weights and inputs.  ``gain`` scales the offset head:
    at 10 about half the lanes diverge and the rest need 7 iterations."""
    kw = dict(mode=mode, lat_dim_glob_shape=16, lat_dim_loc_shape=8, n_loc=7,
              lat_dim_expr=8, lat_dim_id=8, hidden_dim=48, n_layers=4)
    jd = jmake(JDeformationConfig(**kw))
    td = make_deformation_decoder(DeformationConfig(**kw))
    jp = jd.init(jax.random.PRNGKey(seed))
    head = jp["trunk"]["layers"][-1]
    jp["trunk"]["layers"][-1] = {"w": head["w"] * gain, "b": head["b"] * gain}
    tp = from_numpy_pytree(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(seed)
    obs = (rng.normal(size=(nb, n_pts, 3)) * 0.3).astype(np.float32)
    cond = (rng.normal(size=(nb, jd.cfg.lat_dim_shape_full + 8)) * cond_scale)
    anchors = (rng.normal(size=(nb, 7, 3)) * 0.3).astype(np.float32)
    return jd, jp, td, tp, obs, cond.astype(np.float32), anchors


def eye(obs):
    return np.broadcast_to(np.eye(3, dtype=np.float32), obs.shape[:-1] + (3, 3)).copy()


def assert_same(ref, out):
    np.testing.assert_allclose(out["result"].numpy(), np.asarray(ref["result"]), atol=ATOL)
    np.testing.assert_allclose(out["diff"].numpy(), np.asarray(ref["diff"]), atol=ATOL)
    flips = np.sum(out["valid_ids"].numpy() != np.asarray(ref["valid_ids"]))
    assert flips <= 1, flips
    assert int(out["iters"]) == int(ref["iters"])


def trunk_cond(jd, jp, obs, cond, anchors):
    c = jconditioning(jp, jd.cfg, jnp.asarray(cond), jnp.asarray(anchors),
                      training=False, rng=None)
    return np.asarray(c)


@pytest.mark.parametrize("budget", [1, 3, 8])
@pytest.mark.parametrize("gain", [1.0, 10.0])
def test_cold_search_matches_pallas(budget, gain):
    jd, jp, td, tp, obs, cond, anchors = setup(cond_scale=1.0, gain=gain)
    c = trunk_cond(jd, jp, obs, cond, anchors)
    j0 = eye(obs)
    ref = broyden_search_pallas(jp["trunk"], jd.cfg.trunk_cfg, jnp.asarray(c),
                                jnp.asarray(obs), jnp.asarray(obs), jnp.asarray(j0),
                                budget, tile=512, interpret=True)
    out = broyden_search(tp["trunk"], td.cfg.trunk_cfg, torch.tensor(c),
                         torch.tensor(obs), torch.tensor(obs), torch.tensor(j0), budget)
    assert_same(ref, out)
    both = out["valid_ids"].numpy() & np.asarray(ref["valid_ids"])
    np.testing.assert_allclose(out["j_inv"].numpy()[both],
                               np.asarray(ref["j_inv"])[both], atol=3e-4)


def test_warm_search_matches_pallas():
    """Resume from an earlier search's roots and refined J^-1."""
    jd, jp, td, tp, obs, cond, anchors = setup(n_pts=333, cond_scale=1.0)
    c = trunk_cond(jd, jp, obs, cond, anchors)
    first = broyden_search(tp["trunk"], td.cfg.trunk_cfg, torch.tensor(c),
                           torch.tensor(obs), torch.tensor(obs),
                           torch.tensor(eye(obs)), 1)
    assert not first["valid_ids"].any()
    x0, j0 = first["result"].numpy(), first["j_inv"].numpy()
    ref = broyden_search_pallas(jp["trunk"], jd.cfg.trunk_cfg, jnp.asarray(c),
                                jnp.asarray(obs), jnp.asarray(x0), jnp.asarray(j0), 3,
                                tile=256, interpret=True)
    out = broyden_search(tp["trunk"], td.cfg.trunk_cfg, torch.tensor(c),
                         torch.tensor(obs), torch.tensor(x0), torch.tensor(j0), 3)
    assert_same(ref, out)


def test_search_fused_matches_search_pallas():
    """Includes the reset of diverged lanes' J^-1 to identity."""
    jd, jp, td, tp, obs, cond, anchors = setup(cond_scale=1.0, gain=10.0)
    j0 = eye(obs)
    xr, rr = search_pallas(jd, jp, jnp.asarray(obs), jnp.asarray(cond),
                           jnp.asarray(anchors), max_steps=8, xc_init=jnp.asarray(obs),
                           j_inv_init=jnp.asarray(j0), tile=512, interpret=True)
    xo, ro = search_fused(td, tp, torch.tensor(obs), torch.tensor(cond),
                          torch.tensor(anchors), max_steps=8, xc_init=torch.tensor(obs),
                          j_inv_init=torch.tensor(j0))
    np.testing.assert_allclose(xo.numpy(), np.asarray(xr), atol=ATOL)
    np.testing.assert_allclose(ro["diff"].numpy(), np.asarray(rr["diff"]), atol=ATOL)
    assert np.sum(ro["valid_ids"].numpy() != np.asarray(rr["valid_ids"])) <= 1
    both = ro["valid_ids"].numpy() & np.asarray(rr["valid_ids"])
    np.testing.assert_allclose(ro["j_inv"].numpy()[both], np.asarray(rr["j_inv"])[both],
                               atol=3e-4)
    assert int(ro["iters"]) == int(rr["iters"])
    diverged = ~ro["valid_ids"].numpy()
    assert diverged.any()
    np.testing.assert_array_equal(ro["j_inv"].numpy()[diverged],
                                  np.asarray(rr["j_inv"])[diverged])


@pytest.mark.parametrize("identity_j", [False, True])
def test_plain_search_matches_jax_search(identity_j):
    """The non-fused path: cold autograd-Jacobian or identity J^-1 init."""
    jd, jp, td, tp, obs, cond, anchors = setup(n_pts=200, gain=10.0)
    xr, rr = jsearch(jd, jp, jnp.asarray(obs), jnp.asarray(cond), jnp.asarray(anchors),
                     max_steps=6, identity_j_init=identity_j)
    xo, ro = search(td, tp, torch.tensor(obs), torch.tensor(cond), torch.tensor(anchors),
                    max_steps=6, identity_j_init=identity_j)
    np.testing.assert_allclose(xo.numpy(), np.asarray(xr), atol=ATOL)
    np.testing.assert_allclose(ro["diff"].numpy(), np.asarray(rr["diff"]), atol=ATOL)
    assert int(ro["iters"]) == int(rr["iters"])


@pytest.mark.parametrize("exact", [False, True])
def test_ift_correction_gradients_match_jax(exact):
    """Value = the root; gradient w.r.t. the latent = -J^-1 d warp."""
    jd, jp, td, tp, obs, cond, anchors = setup(n_pts=100)
    xr, rr = jsearch(jd, jp, jnp.asarray(obs), jnp.asarray(cond), jnp.asarray(anchors),
                     max_steps=6)
    j_inv = None if exact else rr["j_inv"]
    w = np.random.default_rng(9).normal(size=obs.shape).astype(np.float32)

    def jloss(c):
        xc = jift(jd, jp, xr, c, jnp.asarray(anchors), j_inv=j_inv)
        return jnp.sum(jnp.asarray(w) * xc)

    g_ref = jax.grad(jloss)(jnp.asarray(cond))
    c_t = torch.tensor(cond, requires_grad=True)
    xc = ift_correction(td, tp, torch.tensor(np.asarray(xr)), c_t, torch.tensor(anchors),
                        j_inv=None if exact else torch.tensor(np.asarray(rr["j_inv"])))
    np.testing.assert_allclose(xc.detach().numpy(), np.asarray(xr), atol=0)
    (torch.tensor(w) * xc).sum().backward()
    scale = np.abs(np.asarray(g_ref)).max()
    np.testing.assert_allclose(c_t.grad.numpy(), np.asarray(g_ref), atol=1e-4 * scale)


def test_fused_search_gates():
    _jd, _jp, td, *_ = setup()
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert search_fusable(td)
    assert _use_fused_search(td, FittingConfig(fused_search="on"), cpu)
    assert not _use_fused_search(td, FittingConfig(), cpu)  # auto: CUDA only
    assert _use_fused_search(td, FittingConfig(), cuda)
    assert not _use_fused_search(
        td, FittingConfig(fused_search="on", warm_start_corresp=False), cpu)
    assert not _use_fused_search(
        td, FittingConfig(fused_search="on", broyden_frac_exit=1e-3), cpu)
    assert not _use_fused_search(
        td, FittingConfig(fused_search="on", warm_jacobian_store=False), cpu)
    assert not _use_fused_search(td, FittingConfig(fused_search="off"), cuda)


def test_cpu_tensors_take_the_plain_version():
    jd, jp, td, tp, obs, cond, anchors = setup(n_pts=40)
    c = conditioning(tp, td.cfg, torch.tensor(cond), torch.tensor(anchors))
    before = broyden_search.launches
    broyden_search(tp["trunk"], td.cfg.trunk_cfg, c, torch.tensor(obs),
                   torch.tensor(obs), torch.tensor(eye(obs)), 2)
    assert broyden_search.launches == before


def _trunk_residual_3xtf32(layers, tcfg, x, obs, rows):
    """``ops.search._trunk_residual`` with K2's arithmetic: the hidden
    products as 3xTF32 with the in-register split (``csrc/tc_tile.cuh``
    ``split_mma``: the small half truncated by the tensor core), layer 0,
    the skip layer's point term and the head in fp32."""
    from nphm_tpu_torch.models.mlp import softplus_beta
    from nphm_tpu_torch.ops.tf32 import matmul_3xtf32

    _shapes, skip_in = tcfg.layer_shapes
    h = None
    for i, lay in enumerate(layers[:-1]):
        if i == 0:
            z = x @ lay["wp"].T + lay["b"][rows]
        else:
            z = matmul_3xtf32(h, lay["w"].T, small="trunc")
            z = z + x @ lay["wp"].T + lay["b"][rows] if i == skip_in else z + lay["b"]
        h = softplus_beta(z, tcfg.beta)
    delta = (h @ layers[-1]["w"].T + layers[-1]["b"])[:, :3]
    return (x + delta) - obs


@pytest.mark.parametrize("budget", [3, 15])
@pytest.mark.parametrize("gain", [1.0, 10.0])
def test_3xtf32_search_converges_on_the_same_lanes(monkeypatch, budget, gain):
    """K2's tensor-core products do not stall the residuals above the 1e-6
    convergence threshold (one TF32 or bf16 pass would): the plain search
    with its hidden products emulated in 3xTF32 converges on the same
    lanes as the fp32 plain search and the roots agree within 1e-5.  Each
    tile runs the same iterations within one: a lane whose best residual
    lands next to 1e-6 may cross it one iteration apart, and fp32 products
    summed in reverse order, or taken in float64, move the same tiles by
    one at gain 10 and budget 15 (2 of 44 tiles)."""
    from nphm_tpu_torch.ops import search as srch

    jd, jp, td, tp, obs, cond, anchors = setup(cond_scale=1.0, gain=gain)
    c = torch.tensor(trunk_cond(jd, jp, obs, cond, anchors))
    args = (tp["trunk"], td.cfg.trunk_cfg, c, torch.tensor(obs), torch.tensor(obs),
            torch.tensor(eye(obs)), budget)
    ref = srch.broyden_search_plain(*args)
    monkeypatch.setattr(srch, "_trunk_residual", _trunk_residual_3xtf32)
    out = srch.broyden_search_plain(*args)
    assert torch.equal(out["valid_ids"], ref["valid_ids"])
    assert int((out["tile_iters"] - ref["tile_iters"]).abs().max()) <= 1
    assert abs(int(out["iters"]) - int(ref["iters"])) <= 1
    np.testing.assert_allclose(out["result"].numpy(), ref["result"].numpy(), atol=1e-5)
    np.testing.assert_allclose(out["diff"].numpy(), ref["diff"].numpy(), atol=1e-5)


def test_tile_matches_csrc():
    """ops.search's tile, width limit and shared-memory mirror follow the
    kernel's constants (csrc/broyden_search.cu), so the plain version's
    per-tile exit and ``search_fits`` describe the kernel that runs."""
    import os
    import re

    from nphm_tpu_torch.ops import search as srch

    with open(os.path.join(os.path.dirname(srch.__file__), "..", "csrc",
                           "broyden_search.cu")) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert srch.TILE == const("kLanes") == 32
    assert (srch.K_SLICE, srch.RING_STAGES, srch.HALF) == (
        const("kKS"), const("kStages"), const("kHalf"))
    assert "constexpr int kMaxWidth = 2 * kHalf;" in src
    assert srch.MAX_WIDTH == 2 * srch.HALF
    assert srch.STATE_FIELDS == int(re.search(r"kFields = (\d+)", src).group(1))
    assert "nphm_search_lanes_per_block() { return kLanes; }" in src
    assert "const int64_t blocks = n_pad / kLanes;" in src
