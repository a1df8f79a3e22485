"""``remat`` in the port's identity loss (``training.losses.identity_sdf_loss``,
``models.fields.rematerialized``) and its trainer, on the CPU.

Small NPHM (``test_torch_train.py``'s) and NPM decoders; inputs from numpy
seeds.

- ``IdentityTrainer`` on the plain fields path (``fused_train_kernel``
  false): a train step and a validation step with ``remat`` on, off and
  unset give ``torch.equal`` params, latent tables and optimizer states,
  for both families; with ``remat`` on, the decoder forward runs again in
  the backward pass.  Unset is off in the port (the JAX package's default
  is on): torch recomputes a checkpointed forward once per backward call,
  so under the eikonal double backward remat costs time and memory.
- ``identity_sdf_loss(remat=True)`` against the JAX package's
  ``identity_sdf_loss(remat=True)``: terms and the gradients w.r.t. params
  and latents at ``test_torch_train.py``'s fp32 tolerances.
- With a ``fields_fn`` (K5/K6's plain versions) ``remat`` changes nothing.
- Under ``matmul_precision("bfloat16")``, a gradient taken after the
  context has closed is the same with ``remat`` on and off: the recompute
  runs at its forward's precision.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from nphm_tpu.data.synthetic import SyntheticIdentityDataset as JSyntheticIdentityDataset
from nphm_tpu.models import NPHMConfig as JNPHMConfig, make_nphm_decoder as jmake_nphm
from nphm_tpu.training.losses import identity_sdf_loss as jidentity_sdf_loss
from nphm_tpu_torch.data.synthetic import SyntheticIdentityDataset
from nphm_tpu_torch.models import DeepSDFConfig, NPHMConfig, make_nphm_decoder, make_npm_decoder
from nphm_tpu_torch.ops import precision
from nphm_tpu_torch.ops.train_fields import apply_nphm_train
from nphm_tpu_torch.training.losses import identity_sdf_loss
from nphm_tpu_torch.training.trainer import IdentityTrainer
from nphm_tpu_torch.utils.logging_utils import MetricsLogger
from nphm_tpu_torch.utils.params import from_numpy_pytree
from test_torch_train import CFG, DATA, LAMBDAS, NPM_CFG, train_cfg


@pytest.fixture(scope="module")
def nphm():
    rng = np.random.default_rng(0)
    anchors = (rng.normal(size=(CFG["n_loc"], 3)) * 0.3).astype(np.float32)
    jd = jmake_nphm(JNPHMConfig(**CFG), anchors)
    return jd, jd.init(jax.random.PRNGKey(0)), make_nphm_decoder(NPHMConfig(**CFG), anchors)


def counting(decoder):
    """The decoder with its point-field calls counted (``decoder.calls``)."""
    calls = []

    def apply(params, xyz, lat, **kw):
        calls.append(xyz.shape[1])
        return decoder.apply(params, xyz, lat, **kw)

    out = dataclasses.replace(decoder, apply=apply)
    object.__setattr__(out, "calls", calls)
    return out


@pytest.mark.parametrize("family", ["nphm", "npm"])
def test_remat_leaves_the_update_unchanged(nphm, family, tmp_path):
    if family == "nphm":
        _jd, jp, td = nphm
        params = from_numpy_pytree(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    else:
        td = make_npm_decoder(DeepSDFConfig(**NPM_CFG))
        params = td.init(torch.Generator().manual_seed(0), "cpu")
    out = {}
    for remat in (True, False, None):
        dec = counting(td)
        tr = IdentityTrainer(
            dec, params, train_cfg() if remat is None else train_cfg(remat=remat),
            SyntheticIdentityDataset(n_subjects=2, batch_size=2, seed=0, **DATA),
            SyntheticIdentityDataset(n_subjects=2, batch_size=2, seed=5, **DATA),
            f"r{remat}", exp_dir=str(tmp_path), logger=MetricsLogger(quiet=True),
            recon_resolution=16, device="cpu")
        batch = next(iter(tr.train_dataset.batch_iter(seed=0)))
        terms = tr._train_step(tr._batch(batch), tr.lr_at(0), tr.lr_lat_at(0))
        tr._val_step(tr._batch(next(iter(tr.val_dataset.batch_iter(seed=0)))), tr.lr_lat_at(0))
        out[remat] = (terms, tr.state_dict(), [n for n in dec.calls if n > 1])
    terms_off, state_off, calls_off = out[False]
    for remat in (True, None):
        terms, state, _ = out[remat]
        assert all(torch.equal(terms[k], terms_off[k]) for k in terms)
        for a, b in zip(jax.tree_util.tree_leaves(state), jax.tree_util.tree_leaves(state_off)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # one field forward a step without remat (the default); with it, more
    assert len(calls_off) == 2 and out[None][2] == calls_off
    assert len(out[True][2]) > len(calls_off)


def test_remat_matches_jax_and_is_ignored_with_fields_fn(nphm):
    jd, jp, td = nphm
    ds = JSyntheticIdentityDataset(n_subjects=3, batch_size=3, seed=1, **DATA)
    batch = next(iter(ds.batch_iter(seed=0)))
    lat = (np.random.default_rng(5).normal(size=(3, td.lat_dim)) * 0.1).astype(np.float32)

    def jloss(p, la):
        terms = jidentity_sdf_loss(jd, p, {k: jnp.asarray(v) for k, v in batch.items()}, la,
                                   remat=True)
        return sum(LAMBDAS[k] * terms[k] for k in terms), terms

    (_, jterms), (jgp, jgl) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                        has_aux=True))(jp, jnp.asarray(lat))

    def run(remat, fields=False, prec="default", grad_outside=False):
        leaves, treedef = jax.tree_util.tree_flatten(jp)
        tleaves = [torch.tensor(np.asarray(v), requires_grad=True) for v in leaves]
        tp = jax.tree_util.tree_unflatten(treedef, tleaves)
        la = torch.tensor(lat, requires_grad=True)
        fields_fn = None
        if fields:
            def fields_fn(p, pts, lt):
                return apply_nphm_train(p, td.cfg, pts, lt)
        with precision.matmul_precision(prec):
            terms = identity_sdf_loss(td, tp, {k: torch.tensor(v) for k, v in batch.items()},
                                      la, remat=remat, fields_fn=fields_fn)
            loss = sum(LAMBDAS[k] * terms[k] for k in terms)
            if not grad_outside:
                grads = torch.autograd.grad(loss, tleaves + [la], allow_unused=True)
        if grad_outside:
            grads = torch.autograd.grad(loss, tleaves + [la], allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(tleaves + [la], grads)]
        return {k: v.detach() for k, v in terms.items()}, grads

    terms, grads = run(True)
    assert sorted(terms) == sorted(jterms)
    for k in terms:
        np.testing.assert_allclose(float(terms[k]), float(jterms[k]), atol=1e-6, rtol=1e-5,
                                   err_msg=k)
    for got, ref in zip(grads[:-1], jax.tree_util.tree_leaves(jgp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgl), atol=2e-6, rtol=1e-4)

    for kw in (dict(fields=True), dict(prec="bfloat16", grad_outside=True)):
        (t_on, g_on), (t_off, g_off) = run(True, **kw), run(False, **kw)
        assert all(torch.equal(t_on[k], t_off[k]) for k in t_on), kw
        assert all(torch.equal(a, b) for a, b in zip(g_on, g_off)), kw
