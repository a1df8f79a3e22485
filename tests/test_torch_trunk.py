"""K7's plain version (``ops/trunk.py``) vs the JAX package's fused DeepSDF
trunk kernel (``ops/pallas_mlp.py``, Pallas in interpret mode), on the CPU.

Same weights (the JAX ``Decoder.init`` bridged with ``from_numpy_pytree``)
and the same numpy inputs; the bound is ``tests/test_pallas_mlp.py``'s own,
atol 3e-6 (fp32, only summation order differs).  A failed comparison
reports the largest difference, its point, and both sides' distance to a
float64 evaluation of the same trunk, so that it says which side moved
(rounding alone keeps both within ~3e-7 of it).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from nphm_tpu.models import (
    DeepSDFConfig as JDeepSDFConfig,
    DeformationConfig as JDeformationConfig,
    make_deformation_decoder as jmake_deformation,
    make_npm_decoder as jmake_npm,
)
from nphm_tpu.ops.pallas_mlp import (
    deformation_pallas,
    deepsdf_trunk_pallas,
    npm_grid_sdf_pallas,
    npm_sdf_pallas,
)
from nphm_tpu_torch.models import DeepSDFConfig, DeformationConfig
from nphm_tpu_torch.models.mlp import positional_encoding, softplus_beta
from nphm_tpu_torch.ops import trunk
from nphm_tpu_torch.utils.params import from_numpy_pytree

ATOL = 3e-6
MINI, MAXI = (-0.55, -0.5, -0.95), (0.55, 0.75, 0.4)


def bridge(tree):
    return from_numpy_pytree(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def trunk_f64(params, cfg, xyz, cond):
    """The plain trunk in float64: the rounding-free reference of a report."""
    p64 = from_numpy_pytree(params, device="cpu", dtype=torch.float64)
    layers = trunk.prepare_trunk_operands(
        p64, cfg, None if cond is None else torch.tensor(cond, dtype=torch.float64))
    pe = positional_encoding(torch.tensor(xyz, dtype=torch.float64), cfg.num_freq_bands)
    _shapes, skip = cfg.layer_shapes
    h = None
    for i, lay in enumerate(layers):
        if i == 0:
            z = pe @ lay["wp"].T + lay["b"]
        elif i == skip:
            z = h @ lay["w"].T + pe @ lay["wp"].T + lay["b"]
        else:
            z = h @ lay["w"].T + lay["b"]
        if i < len(layers) - 1:
            h = softplus_beta(z, cfg.beta) if cfg.beta > 0 else torch.relu(z)
    return z.numpy()


def assert_matches(out, ref, params, cfg, xyz, cond):
    """assert_allclose(out, ref, atol=ATOL), reporting on failure the
    largest |out - ref|, its index and point, and |out - f64|, |ref - f64|."""
    out, ref = np.asarray(out), np.asarray(ref)
    d = np.abs(out - ref)
    if not np.all(d <= ATOL + 1e-7 * np.abs(ref)):
        r64 = trunk_f64(params, cfg, xyz, cond).reshape(out.shape)
        i = tuple(int(k) for k in np.unravel_index(int(d.argmax()), d.shape))
        row = i[0]
        msg = (f"max |port - JAX| {d[i]:.3e} at index {i}, point {xyz[row].tolist()}: "
               f"port {out[i]!r}, JAX {ref[i]!r}, float64 {r64[i]!r}; over the whole "
               f"output max |port - f64| {np.abs(out - r64).max():.3e}, max |JAX - f64| "
               f"{np.abs(ref - r64).max():.3e}; {int((d > ATOL).sum())} of {d.size} "
               f"entries over atol {ATOL:g}")
    else:
        msg = ""
    np.testing.assert_allclose(out, ref, atol=ATOL, err_msg=msg)


def npm_pair(**kw):
    jd = jmake_npm(JDeepSDFConfig(**kw))
    jp = jd.init(jax.random.PRNGKey(0))
    return jd, jp, DeepSDFConfig(**kw), bridge(jp)


@pytest.mark.parametrize("freq", [None, 2])
def test_npm_sdf_matches_pallas(freq):
    jd, jp, cfg, tp = npm_pair(lat_dim=32, hidden_dim=64, n_layers=4, num_freq_bands=freq)
    rng = np.random.default_rng(1)
    xyz = (rng.normal(size=(1700, 3)) * 0.4).astype(np.float32)
    lat = (rng.normal(size=(32,)) * 0.1).astype(np.float32)
    ref = npm_sdf_pallas(jp, jd.cfg, jnp.asarray(xyz), jnp.asarray(lat), interpret=True)
    out = trunk.npm_sdf(tp, cfg, torch.tensor(xyz), torch.tensor(lat))
    assert out.shape == (1700,)
    assert_matches(out.numpy(), ref, tp, cfg, xyz, lat)


def test_npm_grid_sdf_matches_pallas():
    jd, jp, cfg, tp = npm_pair(lat_dim=16, hidden_dim=48, n_layers=4)
    lat = (np.random.default_rng(2).normal(size=(16,)) * 0.1).astype(np.float32)
    ref = npm_grid_sdf_pallas(jp, jd.cfg, jnp.asarray(lat), MINI, MAXI, 24, interpret=True)
    out = trunk.npm_grid_sdf(tp, cfg, torch.tensor(lat), MINI, MAXI, 24)
    assert out.shape == (24**3,)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("mode", ["compress", "glob_only", "expr_only"])
def test_deformation_matches_pallas(mode):
    kw = dict(mode=mode, lat_dim_glob_shape=16, lat_dim_loc_shape=8, n_loc=7,
              lat_dim_expr=8, lat_dim_id=8, hidden_dim=48, n_layers=4)
    jd = jmake_deformation(JDeformationConfig(**kw))
    jp = jd.init(jax.random.PRNGKey(0))
    dcfg = DeformationConfig(**kw)
    rng = np.random.default_rng(0)
    xyz = (rng.normal(size=(900, 3)) * 0.3).astype(np.float32)
    lat = (rng.normal(size=(dcfg.lat_dim_shape_full + 8,)) * 0.1).astype(np.float32)
    anchors = (rng.normal(size=(7, 3)) * 0.3).astype(np.float32)
    ref = deformation_pallas(jp, jd.cfg, jnp.asarray(xyz), jnp.asarray(lat),
                             jnp.asarray(anchors), interpret=True)
    out = trunk.deformation(bridge(jp), dcfg, torch.tensor(xyz), torch.tensor(lat),
                            torch.tensor(anchors))
    assert out.shape == (900, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("out_dim,beta", [(2, 100.0), (3, 0.0)])
def test_unconditioned_trunk_matches_pallas(out_dim, beta):
    """lat_dim 0 (cond None), a 2- or 3-wide head, and the ReLU (beta <= 0)."""
    jd, jp, cfg, tp = npm_pair(lat_dim=0, hidden_dim=32, n_layers=4, out_dim=out_dim,
                               beta=beta)
    xyz = (np.random.default_rng(3).normal(size=(500, 3)) * 0.4).astype(np.float32)
    ref = deepsdf_trunk_pallas(jp, jd.cfg, jnp.asarray(xyz), None, interpret=True)
    out = trunk.deepsdf_trunk(tp, cfg, torch.tensor(xyz), None)
    assert out.shape == (500, out_dim)
    assert_matches(out.numpy(), ref, tp, cfg, xyz, None)


def test_trunk_plain_matches_decoder_and_operand_fold():
    """The CPU wrapper is the plain version, which equals the unfolded
    ``apply_deepsdf``; the fold puts 1/sqrt(2) into the skip weights and
    the conditioning into the layer-0 and skip biases."""
    from nphm_tpu_torch.models import apply_deepsdf

    _jd, _jp, cfg, tp = npm_pair(lat_dim=12, hidden_dim=40, n_layers=6)
    rng = np.random.default_rng(4)
    xyz = torch.tensor((rng.normal(size=(333, 3)) * 0.4).astype(np.float32))
    lat = torch.tensor((rng.normal(size=(12,)) * 0.2).astype(np.float32))
    ref = apply_deepsdf(tp, cfg, xyz[None], lat[None])[0]
    torch.testing.assert_close(trunk.deepsdf_trunk(tp, cfg, xyz, lat), ref, atol=ATOL, rtol=0)
    torch.testing.assert_close(trunk.deepsdf_trunk_plain(tp, cfg, xyz, lat), ref,
                               atol=ATOL, rtol=0)
    layers = trunk.prepare_trunk_operands(tp, cfg, lat)
    _shapes, skip = cfg.layer_shapes
    w = tp["layers"][skip]["w"]
    h = w.shape[1] - cfg.d_in
    torch.testing.assert_close(layers[skip]["w"] * trunk.SQRT2, w[:, :h])
    torch.testing.assert_close(layers[0]["b"],
                               tp["layers"][0]["b"] + tp["layers"][0]["w"][:, 3:] @ lat)
    assert set(layers[0]) == {"wp", "b"} and set(layers[-1]) == {"w", "b"}


def test_chunking_and_kernel_layouts():
    """Chunk sizes keep the four activation buffers (two layers, two TF32
    halves each) within SCRATCH_BYTES; the kernel layout keeps hidden
    weights K-major [out, in], zero-padded to 16-byte rows and split into
    TF32 halves that sum back to the weights."""
    assert trunk.chunk_points(1024, 128) == 131072
    assert trunk.chunk_points(512, 128) == 262144
    assert 4 * 4 * 1024 * trunk.chunk_points(1024, 128) <= trunk.SCRATCH_BYTES
    assert trunk.chunk_points(200, 128) % 128 == 0
    _jd, _jp, cfg, tp = npm_pair(lat_dim=8, hidden_dim=40, n_layers=4, out_dim=3)
    layers = trunk.prepare_trunk_operands(tp, cfg, torch.zeros(8))
    ops = trunk._kernel_layers(layers)
    assert ops[0]["K"] == 0 and ops[0]["wb"] is None and ops[0]["wp"].shape == (40, 3)
    _shapes, skip = cfg.layer_shapes
    for i in range(1, len(ops) - 1):
        n_out, K, ldw = ops[i]["n_out"], ops[i]["K"], ops[i]["ldw"]
        assert (n_out, K) == tuple(layers[i]["w"].shape)
        assert ldw % trunk.LD_ALIGN == 0 and K <= ldw < K + trunk.LD_ALIGN
        wb, ws = ops[i]["wb"], ops[i]["ws"]
        assert wb.shape == ws.shape == (n_out, ldw) and wb.is_contiguous()
        assert float(wb[:, K:].abs().sum()) == 0.0 and float(ws[:, K:].abs().sum()) == 0.0
        for half in (wb, ws):  # TF32 values: the 13 low mantissa bits are clear
            assert int((half.view(torch.int32) & 0x1FFF).abs().sum()) == 0
        w = layers[i]["w"]
        torch.testing.assert_close(wb[:, :K] + ws[:, :K], w, atol=0,
                                   rtol=2.0**-20)
    assert ops[skip]["K"] % trunk.LD_ALIGN != 0  # 29 hidden inputs, padded to 32
    assert ops[skip]["wp"].shape == (ops[skip]["n_out"], 3)
    assert ops[-1]["w"].shape == (3, 40) and ops[-1]["wb"] is None


def test_tf32_round_is_nearest_ties_away():
    """``tf32_round`` is cvt.rna.tf32.f32: nearest TF32 value, ties away
    from zero; the small half carries the rest to ~2^-22."""
    from nphm_tpu_torch.ops.tf32 import split_tf32, tf32_round

    u = 2.0**-10  # one TF32 unit at 1.0
    x = torch.tensor([1 + u / 2, -(1 + u / 2), 1 + u / 4, 1 + 3 * u / 4, 3.0, 0.0])
    assert tf32_round(x).tolist() == [1 + u, -(1 + u), 1.0, 1 + u, 3.0, 0.0]
    v = torch.tensor(np.random.default_rng(5).normal(size=10000).astype(np.float32))
    big, small = split_tf32(v)
    assert float(((big - v).abs() / v.abs()).max()) <= 2.0**-11
    assert float(((big + small - v).abs() / v.abs()).max()) <= 2.0**-21


@pytest.mark.parametrize("m,k,n", [(256, 1024, 128), (256, 509, 128), (256, 309, 128)])
def test_3xtf32_split_holds_fp32_accuracy_at_k7_shapes(m, k, n):
    """K7's products in plain PyTorch: 3xTF32 (big*big + big*small +
    small*big, fp32 sums) stays within 1e-5 of the product's magnitude
    against a float64 product at the NPM trunk's K (1024, and the skip
    layer's 509 and 309 hidden inputs); one TF32 pass misses that bound."""
    from nphm_tpu_torch.ops.tf32 import matmul_3xtf32, matmul_tf32

    rng = np.random.default_rng(k)
    a = np.log1p(np.exp(2.0 * rng.normal(size=(m, k)))).astype(np.float32)  # softplus
    b = (rng.uniform(-1, 1, size=(k, n)) / np.sqrt(k)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(ref).max()
    err3 = np.abs(matmul_3xtf32(torch.tensor(a), torch.tensor(b)).numpy() - ref).max()
    err1 = np.abs(matmul_tf32(torch.tensor(a), torch.tensor(b)).numpy() - ref).max()
    assert err3 <= 1e-5 * scale
    assert err1 > 1e-5 * scale
