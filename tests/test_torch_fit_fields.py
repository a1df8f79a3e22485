"""K3/K4's plain version vs the JAX fit-specialised field kernels.

``apply_nphm_fit`` on CPU tensors runs ``member_f_plain`` under torch
autograd; its SDF and its gradients with respect to the latent and the
points are held against ``jax.grad`` through
``apply_nphm_fit_pallas(interpret=True)`` at rtol 1e-4 (relative to each
quantity's largest magnitude; fp32, summation order only).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from nphm_tpu.models import NPHMConfig as JNPHMConfig, make_nphm_decoder as jmake
from nphm_tpu.ops import pallas_train as jtrain
from nphm_tpu_torch.models import NPHMConfig, make_nphm_decoder
from nphm_tpu_torch.ops import fit_fields as ff
from nphm_tpu_torch.utils.params import from_numpy_pytree

RTOL = 1e-4
KW = dict(lat_dim_glob=8, lat_dim_loc=4, n_loc=6, n_symm_pairs=2, hidden_dim=16,
          n_layers=4, pos_mlp_dim=16)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    anchors = (rng.normal(size=(KW["n_loc"], 3)) * 0.25).astype(np.float32)
    jd = jmake(JNPHMConfig(**KW), anchors)
    jp = jd.init(jax.random.PRNGKey(1))
    tp = from_numpy_pytree(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jd, jp, make_nphm_decoder(NPHMConfig(**KW), anchors), tp


def close(out, ref):
    ref = np.asarray(ref)
    scale = max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(out, ref, atol=RTOL * scale)


@pytest.mark.parametrize("cull_eps,n_pts", [(0.0, 300), (1e-10, 300), (1e-3, 256)])
def test_apply_nphm_fit_value_and_grads_match_jax(pair, cull_eps, n_pts):
    jd, jp, td, tp = pair
    rng = np.random.default_rng(2)
    xyz = (rng.normal(size=(2, n_pts, 3)) * 0.3).astype(np.float32)
    lat = (rng.normal(size=(2, jd.lat_dim)) * 0.1).astype(np.float32)
    w = rng.normal(size=(2, n_pts)).astype(np.float32)

    def jloss(l, x):
        sdf, _ = jtrain.apply_nphm_fit_pallas(jp, jd.cfg, x, l, tile=128,
                                              cull_eps=cull_eps, sort=True,
                                              interpret=True)
        return jnp.sum(jnp.asarray(w) * jnp.sin(3.0 * sdf[..., 0])), sdf

    (_, sdf_ref), (gl_ref, gx_ref) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(lat), jnp.asarray(xyz))

    lat_t = torch.tensor(lat, requires_grad=True)
    xyz_t = torch.tensor(xyz, requires_grad=True)
    sdf, anchors = ff.apply_nphm_fit(tp, td.cfg, xyz_t, lat_t, tile=128,
                                     cull_eps=cull_eps, sort=True)
    (torch.tensor(w) * torch.sin(3.0 * sdf[..., 0])).sum().backward()
    close(sdf.detach().numpy(), sdf_ref)
    close(lat_t.grad.numpy(), gl_ref)
    close(xyz_t.grad.numpy(), gx_ref)
    assert anchors.shape == (2, KW["n_loc"], 3)


def test_fit_field_without_culling_is_the_training_decoder(pair):
    _jd, _jp, td, tp = pair
    rng = np.random.default_rng(3)
    xyz = torch.tensor(rng.normal(size=(2, 200, 3)) * 0.3, dtype=torch.float32)
    lat = torch.tensor(rng.normal(size=(2, td.lat_dim)) * 0.1, dtype=torch.float32)
    ref, _ = td.apply(tp, xyz, lat, training=True)
    out, _ = ff.apply_nphm_fit(tp, td.cfg, xyz, lat, tile=64, cull_eps=0.0)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), atol=1e-5)


def test_morton_codes_and_active_mask_match_jax(pair):
    jd, _jp, td, _tp = pair
    rng = np.random.default_rng(4)
    xyz = (rng.normal(size=(3, 500, 3)) * 0.4).astype(np.float32)
    np.testing.assert_array_equal(
        ff.morton_codes(torch.tensor(xyz)).numpy(),
        np.asarray(jtrain._morton_codes(jnp.asarray(xyz))).astype(np.int64),
    )
    shift = rng.uniform(-0.6, 0.6, size=(td.cfg.n_members, 3, 1))
    coords = (rng.normal(size=(td.cfg.n_members, 3, 512)) * 0.05 + shift)
    coords = coords.astype(np.float32)
    ref = np.asarray(jtrain._active_mask(jd.cfg, jnp.asarray(coords), 128, 1e-3))
    out = ff.active_mask(td.cfg, torch.tensor(coords), 128, 1e-3).numpy()
    np.testing.assert_array_equal(out, ref[: out.shape[0]])
    assert out[:, -1].all() and not out.all()


def test_culled_tiles_write_zero(pair):
    _jd, _jp, td, tp = pair
    lat = torch.zeros((1, td.lat_dim))
    layers, _ = ff.prepare_train_operands(tp, td.cfg, lat)
    gen = torch.Generator().manual_seed(0)
    coords = torch.randn((td.cfg.n_members, 3, 256), generator=gen) * 0.2
    active = torch.ones((2, td.cfg.n_members), dtype=torch.int32)
    active[1, 0] = 0
    before = ff.member_f.launches
    F = ff.member_f(td.cfg, layers, coords, active, 128, 1)
    assert ff.member_f.launches == before  # CPU tensors: the plain version
    assert torch.all(F[0, 128:] == 0) and torch.all(F[0, :128] != 0)


# Products of K3, K4 and K5 over one 64-point tile at the NPHM widths, by
# the kind of the A operand: "act" softplus activations (the forward
# products of all three, and d(coords) through the 3-wide point weights),
# "cot" signed cotangents (the reverse products of K4 and K5; K5's start
# from wlast * softplus', K4's from wlast * dF * softplus').
TILE_PRODUCTS = [
    ("act", 200, 101), ("act", 101, 200), ("act", 200, 200), ("act", 200, 3),
    ("cot", 200, 200), ("cot", 200, 101), ("cot", 101, 200),
]


@pytest.mark.parametrize("kind,k,n", TILE_PRODUCTS)
def test_3xtf32_split_holds_fp32_accuracy_at_k3_k4_k5_shapes(kind, k, n):
    """K3's, K4's and K5's products in plain PyTorch at their 64-point tile,
    with the in-register split (the small half truncated by the tensor
    core): 3xTF32 within 1e-5 of the product's magnitude against float64;
    one TF32 pass misses that bound."""
    from nphm_tpu_torch.ops.tf32 import matmul_3xtf32, matmul_tf32

    rng = np.random.default_rng(k * 1000 + n + (7 if kind == "cot" else 0))
    if kind == "act":
        a = np.log1p(np.exp(2.0 * rng.normal(size=(64, k)))).astype(np.float32)
    else:
        a = (rng.normal(size=(64, k)) * rng.uniform(0, 1, size=(64, k)) / np.sqrt(k))
        a = a.astype(np.float32)
    b = (rng.uniform(-1, 1, size=(k, n)) / np.sqrt(k)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(ref).max()
    a_t, b_t = torch.tensor(a), torch.tensor(b)
    err3 = np.abs(matmul_3xtf32(a_t, b_t, small="trunc").numpy() - ref).max()
    err1 = np.abs(matmul_tf32(a_t, b_t).numpy() - ref).max()
    assert err3 <= 1e-5 * scale
    assert err1 > 1e-5 * scale


# K6's products by the kind of their A operand: "tan" the tangent forward's
# q_{i-1} = softplus'(z) p, "dual" the dual reverse sweep's zbar_i =
# ubar softplus' + vbar beta e^{-beta h} q, each over a 64-point tile
# against the layer's weights (k x n); "lane" the lane contraction of k
# [zbar | pbar] scratch rows against n [h | q] rows over 4096 lanes (half
# of them the h and zbar halves, half the q and pbar ones).
K6_PRODUCTS = [
    ("tan", 200, 101), ("tan", 101, 200), ("tan", 200, 200),
    ("dual", 200, 200), ("dual", 200, 101), ("dual", 101, 200),
    ("lane", 101, 200), ("lane", 200, 101), ("lane", 200, 200),
]


@pytest.mark.parametrize("kind,k,n", K6_PRODUCTS)
def test_3xtf32_split_holds_fp32_accuracy_at_k6_shapes(kind, k, n):
    """K6's products in plain PyTorch, with the in-register split of its
    tensor-core passes and contraction (the small half truncated by the
    tensor core): 3xTF32 within 1e-5 of the product's magnitude against
    float64; one TF32 pass misses that bound."""
    from nphm_tpu_torch.ops.tf32 import matmul_3xtf32, matmul_tf32

    rng = np.random.default_rng(k * 1000 + n + {"tan": 11, "dual": 13, "lane": 17}[kind])

    def softplus_h(shape):
        return np.log1p(np.exp(2.0 * rng.normal(size=shape)))

    def cot(shape, fan):
        return rng.normal(size=shape) * rng.uniform(0, 1, size=shape) / np.sqrt(fan)

    if kind == "lane":
        lanes = 4096
        a = np.concatenate([cot((k, lanes // 2), k), cot((k, lanes // 2), k)], axis=1)
        q = (1.0 - np.exp(-softplus_h((n, lanes // 2)))) * rng.normal(size=(n, lanes // 2))
        b = np.concatenate([softplus_h((n, lanes // 2)), q], axis=1).T
    else:
        h = softplus_h((64, k))
        e = np.exp(-h)
        if kind == "tan":
            a = (1.0 - e) * rng.normal(size=(64, k))
        else:
            q = (1.0 - e) * rng.normal(size=(64, k))
            a = cot((64, k), k) * (1.0 - e) + cot((64, k), k) * e * q
        b = rng.uniform(-1, 1, size=(k, n)) / np.sqrt(k)
    a, b = a.astype(np.float32), b.astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(ref).max()
    a_t, b_t = torch.tensor(a), torch.tensor(np.ascontiguousarray(b))
    err3 = np.abs(matmul_3xtf32(a_t, b_t, small="trunc").numpy() - ref).max()
    err1 = np.abs(matmul_tf32(a_t, b_t).numpy() - ref).max()
    assert err3 <= 1e-5 * scale
    assert err1 > 1e-5 * scale


def test_head_dot_fixed_order_at_k3_k5_tile():
    """K3's and K5's head product F[t] = sum_o h[t][o] wlast[o] in
    field_tile.cuh's order (fp32 FMAs, lane j summing o = j, j + 32, ...,
    then a butterfly over the 32 lanes) at the 64-point tile and width 200:
    within 1e-6 of the products' magnitude against float64, as close as
    the plain version's own fp32 sum."""
    rng = np.random.default_rng(5)
    h = np.log1p(np.exp(2.0 * rng.normal(size=(64, 200)))).astype(np.float32)
    w = (np.sqrt(np.pi / 200) + 1e-5 * rng.normal(size=200)).astype(np.float32)
    lanes = np.zeros((64, 32), np.float32)
    for o in range(200):  # fmaf: the product is exact in float64, one rounding
        lanes[:, o % 32] = (h[:, o].astype(np.float64) * w[o] + lanes[:, o % 32]).astype(
            np.float32)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, np.arange(32) ^ off]
    ref = h.astype(np.float64) @ w.astype(np.float64)
    scale = (np.abs(h).astype(np.float64) @ np.abs(w).astype(np.float64)).max()
    assert np.abs(lanes[:, 0] - ref).max() <= 1e-6 * scale
    assert np.abs((torch.tensor(h) @ torch.tensor(w)).numpy() - ref).max() <= 1e-6 * scale


def test_k4_weight_layouts(pair):
    """K3-K5's operands: both K-major orientations of each hidden layer with
    leading dims rounded to the MMA's K step and zero columns past the
    width, layer 0's point weights [A, H0, 3], and the width limit
    mirrored from csrc/tc_tile.cuh."""
    import os
    import re

    _jd, _jp, td, tp = pair
    cfg = td.cfg
    lat = torch.zeros((2, td.lat_dim))
    layers, _ = ff.prepare_train_operands(tp, cfg, lat)
    tr, keep, hmax, _hsum = ff._fit_trunk(cfg, layers, 2, 128)
    A = cfg.n_members
    for i in range(1, len(layers) - 1):
        n_out, n_in = tr.n_out[i], tr.n_in[i]
        assert tr.ldw[i] % ff.K_STEP == 0 and tr.ldwt[i] % ff.K_STEP == 0
        assert n_out <= tr.ldw[i] < n_out + ff.K_STEP
        assert n_in <= tr.ldwt[i] < n_in + ff.K_STEP
        assert tr.w_ms[i] == n_in * tr.ldw[i] and tr.wt_ms[i] == n_out * tr.ldwt[i]
    wd = layers[1]["w"]  # [A, out, in]
    wt, w = keep[2], keep[3]  # after layer 0's (wp, bias): layer 1's wt, then w
    assert wt.shape == (A, wd.shape[1], tr.ldwt[1]) and w.shape == (A, wd.shape[2], tr.ldw[1])
    torch.testing.assert_close(wt[:, :, : wd.shape[2]], wd, atol=0, rtol=0)
    torch.testing.assert_close(w[:, :, : wd.shape[1]], wd.transpose(1, 2), atol=0, rtol=0)
    assert float(wt[:, :, wd.shape[2]:].abs().sum()) == 0.0
    assert float(w[:, :, wd.shape[1]:].abs().sum()) == 0.0
    assert tr.w[0] == keep[0].data_ptr() and keep[0].shape == (A, hmax, 3)  # [A, H0, 3]
    src = open(os.path.join(os.path.dirname(ff.__file__), "..", "csrc", "tc_tile.cuh")).read()
    n_groups = int(re.search(r"constexpr int kGroups = (\d+);", src).group(1))
    n_tiles = int(re.search(r"constexpr int kNT = (\d+);", src).group(1))
    assert n_groups * n_tiles * 8 == ff.MAX_WIDTH  # kMaxN: n8-tile groups x tiles
