"""The port's field calculus (``nphm_tpu_torch/models/fields.py``) vs the
JAX package's (``nphm_tpu/models/fields.py``), on the CPU.

- Analytic cases of ``tests/test_models.py``: the Jacobian of a linear map,
  the Hessian and Laplacian of a quadratic form, the divergence of a
  linear field (atol 1e-5 / 1e-4, fp32).
- A tiny GNN deformation field (``point_jacobian``, ``warp_jacobian``,
  ``divergence``) and a tiny NPHM SDF (``spatial_gradient``,
  ``point_hessian``, ``laplace``) against JAX on the same weights and
  points: atol 1e-5 on first derivatives, rtol 1e-4 / atol 1e-4 on
  second ones (softplus(100) curvature, fp32).
- Double backprop: the gradient of mean(laplace(sdf)^2) with respect to
  the NPHM parameters and latent, against ``jax.grad`` of the same
  scalar, within 1e-4 of the largest gradient magnitude.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from nphm_tpu.models.fields import (
    divergence as jdivergence,
    laplace as jlaplace,
    point_hessian as jpoint_hessian,
    point_jacobian as jpoint_jacobian,
    spatial_gradient as jspatial_gradient,
    warp_jacobian as jwarp_jacobian,
)
from nphm_tpu_torch.models import (
    divergence,
    laplace,
    point_hessian,
    point_jacobian,
    spatial_gradient,
    value_and_spatial_gradient,
    warp_jacobian,
)
from test_torch_models import deform_pair, shape_pair

ATOL_1 = 1e-5  # first derivatives
TOL_2 = dict(rtol=1e-4, atol=1e-4)  # second derivatives
TOL_GRAD = 1e-4  # double backprop, relative to the largest gradient


def points(shape, seed=0, scale=0.3):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def test_analytic_cases():
    rng = np.random.default_rng(3)
    A, Bm = (rng.normal(size=(3, 3)).astype(np.float32) for _ in range(2))
    A_t, B_t = torch.tensor(A), torch.tensor(Bm)
    xyz = torch.tensor(points((2, 5, 3), scale=1.0))

    J = point_jacobian(lambda x: x @ A_t.T, xyz)
    assert J.shape == (2, 5, 3, 3)
    np.testing.assert_allclose(J.detach().numpy(), np.broadcast_to(A, (2, 5, 3, 3)),
                               atol=ATOL_1)
    W = warp_jacobian(lambda x: x @ A_t.T, xyz)
    np.testing.assert_allclose(W.detach().numpy(), np.broadcast_to(A + np.eye(3), (2, 5, 3, 3)),
                               atol=ATOL_1)
    np.testing.assert_allclose(spatial_gradient(lambda x: (x * x).sum(-1, keepdim=True),
                                                xyz).detach().numpy(),
                               2 * xyz.numpy(), atol=ATOL_1)

    def quad(x):  # f = x^T A x: Hessian A + A^T, Laplacian tr(A + A^T)
        return torch.einsum("...i,ij,...j->...", x, A_t, x)

    H = point_hessian(quad, xyz)
    assert H.shape == (2, 5, 1, 3, 3)
    np.testing.assert_allclose(H.detach().numpy(), np.broadcast_to(A + A.T, (2, 5, 1, 3, 3)),
                               atol=1e-4)
    lap = laplace(quad, xyz)
    assert lap.shape == (2, 5, 1)
    np.testing.assert_allclose(lap.detach().numpy(), np.trace(A + A.T), atol=1e-4)
    div = divergence(lambda x: x @ B_t.T, xyz)
    assert div.shape == (2, 5, 1)
    np.testing.assert_allclose(div.detach().numpy(), np.trace(Bm), atol=ATOL_1)


@pytest.fixture(scope="module")
def gnn():
    jd, jp, td, tp = deform_pair("GNN")
    rng = np.random.default_rng(5)
    cfg = jd.cfg
    lat = (rng.normal(size=(2, cfg.lat_dim_shape_full + cfg.lat_dim_expr)) * 0.1)
    anchors = (rng.normal(size=(2, cfg.n_loc, 3)) * 0.3).astype(np.float32)
    return jd, jp, td, tp, lat.astype(np.float32), anchors


def test_deformation_jacobians_match_jax(gnn):
    jd, jp, td, tp, lat, anchors = gnn
    xyz = points((2, 64, 3), seed=1)

    def jfn(x):
        return jd.apply(jp, x, jnp.asarray(lat), jnp.asarray(anchors))[0]

    def tfn(x):
        return td.apply(tp, x, torch.tensor(lat), torch.tensor(anchors))[0]

    x_t, x_j = torch.tensor(xyz), jnp.asarray(xyz)
    for ours, ref in ((point_jacobian(tfn, x_t), jpoint_jacobian(jfn, x_j)),
                      (warp_jacobian(tfn, x_t), jwarp_jacobian(jfn, x_j)),
                      (divergence(tfn, x_t), jdivergence(jfn, x_j))):
        assert tuple(ours.shape) == ref.shape
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=ATOL_1)


@pytest.fixture(scope="module")
def nphm():
    jd, jp, td, tp = shape_pair(seed=4)
    lat = (np.random.default_rng(6).normal(size=(1, jd.lat_dim)) * 0.1).astype(np.float32)
    return jd, jp, td, tp, lat


def test_sdf_second_derivatives_match_jax(nphm):
    jd, jp, td, tp, lat = nphm
    xyz = points((1, 48, 3), seed=2)

    def jfn(x):
        return jd.apply(jp, x, jnp.asarray(lat), training=True)[0]

    def tfn(x):
        return td.apply(tp, x, torch.tensor(lat), training=True)[0]

    x_t, x_j = torch.tensor(xyz), jnp.asarray(xyz)
    values, grads = value_and_spatial_gradient(tfn, x_t)
    np.testing.assert_allclose(values.detach().numpy(), np.asarray(jax.jit(jfn)(x_j)),
                               atol=ATOL_1)
    np.testing.assert_allclose(grads.detach().numpy(),
                               np.asarray(jax.jit(lambda x: jspatial_gradient(jfn, x))(x_j)),
                               atol=ATOL_1)
    H, Hr = point_hessian(tfn, x_t), jax.jit(lambda x: jpoint_hessian(jfn, x))(x_j)
    assert tuple(H.shape) == Hr.shape == (1, 48, 1, 3, 3)
    np.testing.assert_allclose(H.detach().numpy(), np.asarray(Hr), **TOL_2)
    lap, lr = laplace(tfn, x_t), jax.jit(lambda x: jlaplace(jfn, x))(x_j)
    assert tuple(lap.shape) == lr.shape == (1, 48, 1)
    np.testing.assert_allclose(lap.detach().numpy(), np.asarray(lr), **TOL_2)
    np.testing.assert_allclose(lap.detach().numpy()[..., 0],
                               np.trace(H.detach().numpy()[:, :, 0], axis1=-2, axis2=-1),
                               **TOL_2)


def test_laplace_double_backprop_matches_jax(nphm):
    jd, jp, td, tp, lat = nphm
    xyz = points((1, 32, 3), seed=3)

    def jloss(p, z):
        lap = jlaplace(lambda x: jd.apply(p, x, z, training=True)[0], jnp.asarray(xyz))
        return jnp.mean(lap**2)

    ref_p, ref_z = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(lat))
    leaves = jax.tree_util.tree_leaves(tp)
    params = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tp),
                                          [t.clone().requires_grad_(True) for t in leaves])
    z = torch.tensor(lat, requires_grad=True)
    lap = laplace(lambda x: td.apply(params, x, z, training=True)[0], torch.tensor(xyz))
    loss = torch.mean(lap**2)
    flat = jax.tree_util.tree_leaves(params)
    grads = torch.autograd.grad(loss, flat + [z], allow_unused=True)
    np.testing.assert_allclose(loss.item(), float(jax.jit(jloss)(jp, jnp.asarray(lat))),
                               rtol=1e-4)
    refs = [np.asarray(r) for r in jax.tree_util.tree_leaves(ref_p)] + [np.asarray(ref_z)]
    assert len(grads) == len(refs)
    scale = max(np.abs(r).max() for r in refs)
    assert scale > 0
    for g, r in zip(grads, refs):
        g = np.zeros_like(r) if g is None else g.numpy()
        np.testing.assert_allclose(g, r, atol=TOL_GRAD * scale, rtol=0)
