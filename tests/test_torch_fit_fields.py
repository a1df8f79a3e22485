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
