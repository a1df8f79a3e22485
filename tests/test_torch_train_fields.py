"""The port's training field (K5/K6's plain versions) vs the JAX package.

Config of ``tests/test_pallas_train.py``: glob 16, loc 8, 7 anchors, 3
symmetric pairs, hidden 40, 4 layers, pos-MLP 32.  Inputs come from numpy
seeds; JAX runs its Pallas kernels in interpret mode.

- ``member_fields_plain`` and its autograd VJP vs ``_member_fields``: F
  and G at atol 1e-6 / 5e-6, every operand cotangent and d(coords) for
  random (u, V) at atol 2e-5 (measured: at most 5.7e-6, on weight
  gradients of magnitude ~30); cases: row padding, a single row, and
  culling at 1e-9 with sorting.
- ``apply_nphm_train`` vs ``apply_nphm_train_pallas``: sdf, grads,
  anchors, and the gradient of ``test_pallas_train.py``'s loss w.r.t.
  params, lat and xyz at that file's tolerances.
- ``fit_joint`` with ``fused_shape_fields="train"`` (the fit through the
  training field) vs ``"off"`` on the CPU, at the fit tolerances of
  ``test_torch_slice.py``.
- The wrappers' block sizes and width limit against the CUDA sources.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from nphm_tpu.models import NPHMConfig as JNPHMConfig, make_nphm_decoder as jmake_nphm
from nphm_tpu.ops import pallas_train as jpt
from nphm_tpu_torch.fitting.inference import FittingConfig, fit_joint
from nphm_tpu_torch.models import (
    DeformationConfig,
    NPHMConfig,
    make_deformation_decoder,
    make_nphm_decoder,
)
from nphm_tpu_torch.models.ensemble import mirror_scale, predict_anchors
from nphm_tpu_torch.ops import fit_fields as ff
from nphm_tpu_torch.ops import train_fields as tf
from nphm_tpu_torch.utils.params import from_numpy_pytree

CFG = dict(lat_dim_glob=16, lat_dim_loc=8, n_loc=7, n_symm_pairs=3, hidden_dim=40,
           n_layers=4, pos_mlp_dim=32)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    anchors = (rng.normal(size=(CFG["n_loc"], 3)) * 0.3).astype(np.float32)
    jd = jmake_nphm(JNPHMConfig(**CFG), anchors)
    td = make_nphm_decoder(NPHMConfig(**CFG), anchors)
    jp = jd.init(jax.random.PRNGKey(0))
    tp = from_numpy_pytree(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jd, jp, td, tp


def member_coords(td, tp, xyz, lat, tile, sort):
    """Member-local coords [A, 3, B*Np] as apply_nphm_train builds them."""
    cfg = td.cfg
    B, N, _ = xyz.shape
    x = torch.tensor(xyz)
    la = torch.tensor(lat)
    if sort:
        perm = torch.argsort(ff.morton_codes(x), dim=1, stable=True)
        x = torch.gather(x, 1, perm[..., None].expand(B, N, 3))
    Np = -(-N // tile) * tile
    x = torch.cat([x, x[:, -1:].expand(B, Np - N, 3)], dim=1)
    anchors = predict_anchors(tp, cfg, la)
    centers = torch.cat([anchors, torch.zeros_like(anchors[:, :1])], dim=1)
    coords = (x[:, :, None] - centers[:, None]) * mirror_scale(cfg, "cpu")
    return coords.permute(2, 3, 0, 1).reshape(cfg.n_members, 3, B * Np).detach().numpy()


# JAX operand role -> (port layer key, reshape of the JAX gradient to the port's)
def jax_grad_as_port(role, g):
    g = np.asarray(g)
    if role in ("bias0", "biasS", "b"):
        return g[..., 0]
    if role == "wlast":
        return np.swapaxes(g, 1, 2)
    return g


@pytest.mark.parametrize("B,N,tile,cull_eps", [
    (3, 300, 128, 0.0),     # rows padded 300 -> 384
    (1, 256, 128, 0.0),     # a single row
    (3, 300, 128, 1e-9),    # culling, Morton-sorted
])
def test_member_fields_and_vjp_match_jax(models, B, N, tile, cull_eps):
    jd, jp, td, tp = models
    cfg = td.cfg
    rng = np.random.default_rng(B * 1000 + N)
    xyz = (rng.normal(size=(B, N, 3)) * 0.4).astype(np.float32)
    lat = (rng.normal(size=(B, cfg.lat_dim)) * 0.1).astype(np.float32)
    coords = member_coords(td, tp, xyz, lat, tile, sort=cull_eps > 0)
    A, _, M = coords.shape
    u = rng.normal(size=(A, M)).astype(np.float32)
    V = rng.normal(size=(A, 3, M)).astype(np.float32)

    # JAX: interpret-mode Pallas kernels behind the custom VJP
    jops, _ = jpt.prepare_train_operands(jp, jd.cfg, jnp.asarray(lat))
    spec = jpt._Spec(cfg=jd.cfg, tile=tile, tpr=M // B // tile, cull_eps=cull_eps,
                     interpret=True)
    (jF, jG), vjp = jax.vjp(lambda o, c: jpt._member_fields(spec, o, c), jops,
                            jnp.asarray(coords))
    jd_ops, jd_coords = vjp((jnp.asarray(u), jnp.asarray(V)))

    # port: plain version + autograd
    layers, _ = ff.prepare_train_operands(tp, cfg, torch.tensor(lat))
    flat = [t.detach().requires_grad_(True) for t in tf._flat(cfg, layers)]
    c = torch.tensor(coords, requires_grad=True)
    active = ff.active_mask(cfg, c, tile, cull_eps)
    if cull_eps > 0:
        assert 0 < int(active.sum()) < active.numel()  # culling fires
    F, G = tf.member_fields_plain(cfg, tf._unflat(cfg, flat), c, active, tile, B)
    np.testing.assert_allclose(F.detach().numpy(), np.asarray(jF), atol=1e-6, rtol=0)
    np.testing.assert_allclose(G.detach().numpy(), np.asarray(jG), atol=5e-6, rtol=0)

    phi = (F * torch.tensor(u)).sum() + (G * torch.tensor(V)).sum()
    grads = torch.autograd.grad(phi, flat + [c])
    want = [jax_grad_as_port(role, g) for (_, role), g in
            zip(jpt._op_layout(jd.cfg), jd_ops) if role not in ("whT", "whST")]
    want.append(np.asarray(jd_coords))
    assert len(want) == len(grads)
    for got, ref in zip(grads, want):
        got = got.numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)


@pytest.fixture(scope="module")
def fields_setup(models):
    jd, jp, td, tp = models
    rng = np.random.default_rng(2)
    xyz = (rng.normal(size=(3, 300, 3)) * 0.4).astype(np.float32)
    lat = (rng.normal(size=(3, td.cfg.lat_dim)) * 0.1).astype(np.float32)
    tgt = rng.normal(size=xyz.shape).astype(np.float32)
    return jd, jp, td, tp, xyz, lat, tgt


def test_apply_nphm_train_forward_matches_jax(fields_setup):
    jd, jp, td, tp, xyz, lat, _ = fields_setup
    ref = jpt.apply_nphm_train_pallas(jp, jd.cfg, jnp.asarray(xyz), jnp.asarray(lat),
                                      tile=128, cull_eps=0.0, interpret=True)
    out = tf.apply_nphm_train(tp, td.cfg, torch.tensor(xyz), torch.tensor(lat), tile=128)
    for o, r, atol in zip(out, ref, (1e-6, 5e-6, 1e-6)):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r), atol=atol, rtol=0)


def _loss(sdf, g, anchors, tgt, norm, mean, abs_):
    eik = mean(abs_(norm(g) - 1.0))
    nrm = mean(((g - tgt) ** 2).sum(-1))
    return mean(abs_(sdf)) + 0.3 * nrm + 0.1 * eik + 0.5 * mean(anchors**2)


def test_apply_nphm_train_loss_gradients_match_jax(fields_setup):
    """d(loss)/d(params, lat, xyz) through the spatial gradient (the
    double backprop), the loss of test_pallas_train.py."""
    jd, jp, td, tp, xyz, lat, tgt = fields_setup

    def jloss(p, la, x):
        sdf, g, anchors = jpt.apply_nphm_train_pallas(p, jd.cfg, x, la, tile=128,
                                                      cull_eps=0.0, interpret=True)
        return _loss(sdf, g, anchors, jnp.asarray(tgt),
                     lambda v: jnp.linalg.norm(v, axis=-1), jnp.mean, jnp.abs)

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(jp, jnp.asarray(lat),
                                                          jnp.asarray(xyz))
    leaves, treedef = jax.tree_util.tree_flatten(jp)
    tleaves = [torch.tensor(np.asarray(v), requires_grad=True) for v in leaves]
    tparams = jax.tree_util.tree_unflatten(treedef, tleaves)
    la = torch.tensor(lat, requires_grad=True)
    x = torch.tensor(xyz, requires_grad=True)
    sdf, g, anchors = tf.apply_nphm_train(tparams, td.cfg, x, la, tile=128)
    loss = _loss(sdf, g, anchors, torch.tensor(tgt), lambda v: torch.linalg.norm(v, dim=-1),
                 torch.mean, torch.abs)
    assert abs(float(loss.detach()) - float(jl)) <= 1e-6
    grads = torch.autograd.grad(loss, tleaves + [la, x], allow_unused=True)
    for got, ref in zip(grads[:-2], jax.tree_util.tree_leaves(jg[0])):
        got = np.zeros_like(ref) if got is None else got.numpy()  # mean_anchors: constant
        np.testing.assert_allclose(got, np.asarray(ref), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(grads[-2].numpy(), np.asarray(jg[1]), atol=2e-6, rtol=1e-4)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jg[2]), atol=2e-6, rtol=1e-4)


def test_fit_through_training_field_matches_plain_fit(models):
    _jd, _jp, td, tp = models
    expr = make_deformation_decoder(DeformationConfig(
        mode="compress", lat_dim_glob_shape=16, lat_dim_loc_shape=8, n_loc=7,
        lat_dim_expr=8, lat_dim_id=8, hidden_dim=32, n_layers=4))
    pe = expr.init(torch.Generator().manual_seed(1), "cpu")
    rng = np.random.default_rng(4)
    obs = [(rng.normal(size=(300, 3)) * 0.3).astype(np.float32) for _ in range(3)]
    draws = (rng.integers(0, 3, size=(4, 2)), rng.integers(0, 300, size=(4, 2, 64)))
    out = {}
    for mode in ("train", "off"):
        cfg = FittingConfig(n_steps=4, n_obs_per_batch=2, n_points_per_obs=64,
                            log_every=10**9, fused_search="off", fused_shape_fields=mode)
        out[mode] = fit_joint(td, tp, expr, pe, obs, cfg=cfg, verbose=False,
                              sample_draws=draws, device="cpu")
    (le, ls, _, h), (rle, rls, _, rh) = out["train"], out["off"]
    np.testing.assert_allclose(ls, rls, rtol=1e-3, atol=5e-4)
    np.testing.assert_allclose(le, rle, rtol=1e-3, atol=5e-4)
    np.testing.assert_allclose(h["loss"], rh["loss"], rtol=1e-3, atol=1e-5)


def test_lanes_per_block_match_csrc():
    """The points a block that the wrappers check tiles against are the
    sources' own: K3, K4, K5 and K6's two passes run tc::kRows-point blocks
    launched by field_tile.cuh's launch over (members, M / kRows) tiles
    (reported by nphm_fit_lanes_per_block, nphm_train_fwd_lanes_per_block
    and nphm_train_lanes_per_block), and K6 sizes its per-block partials
    from the same count."""
    import os
    import re

    csrc = os.path.join(os.path.dirname(ff.__file__), "..", "csrc")

    def read(name):
        with open(os.path.join(csrc, name)) as f:
            return f.read()

    rows = int(re.search(r"constexpr int kRows = (\d+);", read("tc_tile.cuh")).group(1))
    field = read("field_tile.cuh")
    assert re.search(r"constexpr int kRows = tc::kRows;", field)
    assert "dim3 grid((unsigned)n_members, (unsigned)(M / kRows));" in field
    assert "nphm_fit_lanes_per_block() { return field::kRows; }" in read("fit_fields.cu")
    train = read("train_fields.cu")
    assert "nphm_train_fwd_lanes_per_block() { return field::kRows; }" in train
    assert "nphm_train_lanes_per_block() { return field::kRows; }" in train
    for kernel in ("train_bwd_fwd_kernel", "train_bwd_rev_kernel"):
        assert f"field::launch({kernel}<16, P>, {kernel}<8, P>, ln, n_chunk, M," in train
    assert "const int64_t n_blk = M / field::kRows;" in train
    assert ff.FIT_LANES == tf.FWD_LANES == tf.BWD_LANES == rows == 64
    assert ff.DEFAULT_TILE % rows == 0


def test_tensor_core_width_limit(models):
    """K3-K5 refuse a hidden product wider than the mm64 tile (tc::kMaxN =
    256) with a ValueError before any launch; 256 is taken."""
    _jd, _jp, td, tp = models
    layers, _ = ff.prepare_train_operands(tp, td.cfg, torch.zeros((1, td.cfg.lat_dim)))
    ff.check_widths(layers)
    for width, ok in ((256, True), (257, False)):
        wide = [dict(lay) for lay in layers]
        wide[1]["w"] = torch.zeros((td.cfg.n_members, width, 8))
        if ok:
            ff.check_widths(wide)
        else:
            with pytest.raises(ValueError, match="at most 256 wide"):
                ff.check_widths(wide)
