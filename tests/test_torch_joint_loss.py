"""The port's ``training.losses.joint_loss`` vs the JAX package's, on the CPU.

A tiny NPHM identity decoder and an ``expr_only`` deformation field (the
reference's ``loss_joint`` passes the expression field no anchors), JAX
weights bridged with ``from_numpy_pytree``, one seeded batch of two scans,
the first neutral (and a batch with no neutral scan).  The port is handed
the prior's samples the JAX loss draws from its key.  At epochs 0, 1000 and
3500 (correspondence weight 1, 0.25, 0): every term at rtol 1e-4 / atol
1e-6, and the gradient of the terms' sum with respect to both parameter
trees and both latents within 1e-4 of each leaf's largest magnitude (fp32;
the eikonal terms differentiate twice, in another summation order).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from nphm_tpu.models import (
    DeformationConfig as JDeformationConfig,
    make_deformation_decoder as jmake_deformation,
)
from nphm_tpu.training.losses import joint_loss as jjoint_loss
from nphm_tpu_torch.models import DeformationConfig, make_deformation_decoder
from nphm_tpu_torch.training.losses import joint_loss
from test_torch_models import bridge, shape_pair

TOL_TERMS = dict(rtol=1e-4, atol=1e-6)
TOL_GRAD = 1e-4  # relative to each leaf's largest gradient magnitude
DEF_KW = dict(mode="expr_only", lat_dim_glob_shape=8, lat_dim_loc_shape=4, n_loc=6,
              lat_dim_expr=8, hidden_dim=32, n_layers=4)
B = 2


@pytest.fixture(scope="module")
def setup():
    js, jps, ts, tps = shape_pair(seed=7)
    je = jmake_deformation(JDeformationConfig(**DEF_KW))
    jpe = je.init(jax.random.PRNGKey(3))
    te = make_deformation_decoder(DeformationConfig(**DEF_KW))
    rng = np.random.default_rng(8)

    def pts(n, scale=0.3):
        return (rng.normal(size=(B, n, 3)) * scale).astype(np.float32)

    def unit(n):
        v = rng.normal(size=(B, n, 3))
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)

    batch = {"points_surface": pts(40), "normals_surface": unit(40),
             "points_surface_outer": pts(24), "normals_surface_outer": unit(24),
             "points_off_surface": pts(16), "normals_off_surface": unit(16),
             "sdfs_off_surface": pts(16)[..., :1] * 0.1, "sup_grad_far": pts(20, 0.6),
             "gt_anchors": pts(6, 0.25), "corresp_posed": pts(30)}
    batch["corresp_neutral"] = batch["corresp_posed"] + pts(30, 0.02)
    lat_s = (rng.normal(size=(B, js.lat_dim)) * 0.1).astype(np.float32)
    lat_e = (rng.normal(size=(B, 8)) * 0.1).astype(np.float32)
    return dict(js=js, jps=jps, ts=ts, tps=tps, je=je, jpe=jpe, te=te, tpe=bridge(jpe),
                batch=batch, lat_s=lat_s, lat_e=lat_e, jax={})


def jax_samples(key, n_samps):
    return jax.random.uniform(jax.random.split(key, 6)[4], (B, n_samps, 3), jnp.float32)


@pytest.mark.parametrize("epoch,neutral", [(0, (1, 0)), (0, (0, 0)), (1000, (1, 0)),
                                           (3500, (1, 0))])
def test_joint_loss_matches_jax(setup, epoch, neutral):
    m = setup
    batch = dict(m["batch"], is_neutral=np.asarray(neutral, np.int32).reshape(B, 1))
    key = jax.random.PRNGKey(11)

    if epoch not in m["jax"]:  # one compile per epoch, the batch an argument

        def jloss(ps, pe, ls, le, jbatch):
            t = jjoint_loss(m["js"], ps, m["je"], pe, jbatch, ls, le, epoch, key)
            return sum(t.values()), t

        m["jax"][epoch] = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                                     has_aux=True))
    (_, jterms), jgrads = m["jax"][epoch](
        m["jps"], m["jpe"], jnp.asarray(m["lat_s"]), jnp.asarray(m["lat_e"]),
        {k: jnp.asarray(v) for k, v in batch.items()})

    samples = np.asarray(jax_samples(key, 30))

    def draws(kind, shape, device):
        assert kind == "samples" and tuple(shape) == samples.shape
        return torch.tensor(samples, device=device)

    trees = [jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True), m[k])
             for k in ("tps", "tpe")]
    lats = [torch.tensor(m[k], requires_grad=True) for k in ("lat_s", "lat_e")]
    terms = joint_loss(m["ts"], trees[0], m["te"], trees[1],
                       {k: torch.tensor(v) for k, v in batch.items()}, *lats, epoch,
                       draws=draws)
    assert sorted(terms) == sorted(jterms)
    for k in terms:
        np.testing.assert_allclose(terms[k].item(), float(jterms[k]), **TOL_TERMS, err_msg=k)
    if epoch > 3000:
        assert terms["corresp"].item() == 0.0
    if not any(neutral):
        assert terms["loss_neutral_zero"].item() == 0.0
    leaves = [t for tree in trees for t in jax.tree_util.tree_leaves(tree)] + lats
    refs = [np.asarray(g) for g in jax.tree_util.tree_leaves(jgrads)]
    grads = torch.autograd.grad(sum(terms.values()), leaves, allow_unused=True)
    assert len(grads) == len(refs)
    for g, r in zip(grads, refs):
        g = np.zeros_like(r) if g is None else g.numpy()
        np.testing.assert_allclose(g, r, rtol=0, atol=TOL_GRAD * max(np.abs(r).max(), 1e-12))
    assert np.abs(refs[-1]).max() > 0 and np.abs(refs[-2]).max() > 0
