"""The port's stage-1 training stack vs the JAX package, on the CPU.

Small NPHM config (glob 16, loc 8, 7 anchors, 3 symmetric pairs, hidden
40, 4 layers, pos-MLP 32); inputs from numpy seeds, passed to both sides.

- ``identity_sdf_loss``: every term and the gradient of the weighted sum
  w.r.t. params and lat, through the decoder + autograd spatial gradient
  and through the training field (``apply_nphm_train``), vs the JAX
  loss on its XLA path.
- Latent machinery: ``row_adam_update``, ``renorm_rows``,
  ``clip_global_norm`` at 1e-7; ``lr_at`` / ``lr_lat_at`` exact for
  epochs 0-12000 at decay intervals 600 and 5000.
- ``SyntheticIdentityDataset.batch_iter``: bit-identical batches for seeds
  0 and 3; ``SyntheticDeformationDataset``: bit-identical batches, warp
  parameters and ``warp`` output for seeds 0, 3, 9, with and without
  anchors.
- ``IdentityTrainer``: 2 epochs of 2 steps from the JAX trainer's own
  initial state (bridged by ``trainer_state_from_jax``), JAX with
  ``fused_train_kernel: false``; per-epoch loss terms and the final params
  and latent tables agree to within 1e-5 (measured: at most 2.4e-7).  Both
  families: the NPHM ensemble above and a small NPM DeepSDF (lat 16,
  hidden 32, 4 layers, ``local=False``: no anchor or symmetry terms).
- Checkpoint resume: 2 epochs, a fresh trainer resumes and runs a third;
  the state equals 3 uninterrupted epochs exactly.
"""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from nphm_tpu.data.synthetic import SyntheticDeformationDataset as JSyntheticDeformationDataset
from nphm_tpu.data.synthetic import SyntheticIdentityDataset as JSyntheticIdentityDataset
from nphm_tpu.models import DeepSDFConfig as JDeepSDFConfig, make_npm_decoder as jmake_npm
from nphm_tpu.models import NPHMConfig as JNPHMConfig, make_nphm_decoder as jmake_nphm
from nphm_tpu.training import latents as jlat
from nphm_tpu.training.losses import identity_sdf_loss as jidentity_sdf_loss
from nphm_tpu.training.trainer import IdentityTrainer as JIdentityTrainer
from nphm_tpu.utils.logging_utils import MetricsLogger as JMetricsLogger
from nphm_tpu_torch.data.synthetic import SyntheticDeformationDataset, SyntheticIdentityDataset
from nphm_tpu_torch.models import DeepSDFConfig, NPHMConfig, make_nphm_decoder, make_npm_decoder
from nphm_tpu_torch.ops.train_fields import apply_nphm_train
from nphm_tpu_torch.training import latents as tlat
from nphm_tpu_torch.training.losses import identity_sdf_loss
from nphm_tpu_torch.training.trainer import IdentityTrainer
from nphm_tpu_torch.utils.logging_utils import MetricsLogger
from nphm_tpu_torch.utils.params import from_numpy_pytree, trainer_state_from_jax

CFG = dict(lat_dim_glob=16, lat_dim_loc=8, n_loc=7, n_symm_pairs=3, hidden_dim=40,
           n_layers=4, pos_mlp_dim=32)
LAMBDAS = {"lat_reg": 0.01, "surf_sdf": 2.0, "normals": 0.3, "space_sdf": 0.01,
           "grad": 0.1, "anchors": 7.5, "symm_dist": 0.01, "middle_dist": 0.0}
DATA = dict(n_face=100, n_non_face=50, n_anchors=7)
NPM_CFG = dict(lat_dim=16, hidden_dim=32, n_layers=4, radius_init=0.4)


def train_cfg(**kw):
    t = {"batch_size": 2, "ckpt_interval": 500, "grad_clip": 0.1, "grad_clip_lat": 0.1,
         "lr": 5e-4, "lr_lat": 1e-3, "lr_decay_factor": 0.5, "lr_decay_factor_lat": 0.5,
         "lr_decay_interval": 5000, "lr_decay_interval_lat": 5000, "weight_decay": 0.01,
         "lambdas": dict(LAMBDAS), "fused_train_kernel": False}
    t.update(kw)
    return {"training": t}


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    anchors = (rng.normal(size=(CFG["n_loc"], 3)) * 0.3).astype(np.float32)
    jd = jmake_nphm(JNPHMConfig(**CFG), anchors)
    td = make_nphm_decoder(NPHMConfig(**CFG), anchors)
    jp = jd.init(jax.random.PRNGKey(0))
    return jd, jp, td


@pytest.fixture(scope="module")
def npm_models():
    jd = jmake_npm(JDeepSDFConfig(**NPM_CFG))
    return jd, jd.init(jax.random.PRNGKey(0)), make_npm_decoder(DeepSDFConfig(**NPM_CFG))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("fused", [False, True])
def test_identity_loss_terms_and_grads_match_jax(models, fused):
    jd, jp, td = models
    ds = JSyntheticIdentityDataset(n_subjects=3, batch_size=3, seed=1, **DATA)
    batch = next(iter(ds.batch_iter(seed=0)))
    lat = (np.random.default_rng(5).normal(size=(3, td.lat_dim)) * 0.1).astype(np.float32)

    def jloss(p, la):
        terms = jidentity_sdf_loss(jd, p, {k: jnp.asarray(v) for k, v in batch.items()}, la)
        return sum(LAMBDAS[k] * terms[k] for k in terms), terms

    (jl, jterms), (jgp, jgl) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(lat))

    leaves, treedef = jax.tree_util.tree_flatten(jp)
    tleaves = [torch.tensor(np.asarray(v), requires_grad=True) for v in leaves]
    tp = jax.tree_util.tree_unflatten(treedef, tleaves)
    la = torch.tensor(lat, requires_grad=True)
    fields = (lambda p, pts, l: apply_nphm_train(p, td.cfg, pts, l)) if fused else None
    terms = identity_sdf_loss(td, tp, {k: torch.tensor(v) for k, v in batch.items()}, la,
                              fields_fn=fields)
    assert sorted(terms) == sorted(jterms)
    for k in terms:
        np.testing.assert_allclose(float(terms[k].detach()), float(jterms[k]), atol=1e-6,
                                   rtol=1e-5, err_msg=k)
    loss = sum(LAMBDAS[k] * terms[k] for k in terms)
    grads = torch.autograd.grad(loss, tleaves + [la], allow_unused=True)
    for got, ref in zip(grads[:-1], jax.tree_util.tree_leaves(jgp)):
        got = np.zeros_like(ref) if got is None else got.numpy()
        np.testing.assert_allclose(got, np.asarray(ref), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgl), atol=2e-6, rtol=1e-4)


def test_latent_machinery_matches_jax():
    rng = np.random.default_rng(7)
    table = (rng.normal(size=(10, 6)) * 0.8).astype(np.float32)
    idx = np.array([1, 4, 7], np.int64)
    np.testing.assert_allclose(
        tlat.renorm_rows(torch.tensor(table), torch.tensor(idx), 1.0).numpy(),
        np.asarray(jlat.renorm_rows(jnp.asarray(table), jnp.asarray(idx), 1.0)),
        atol=1e-7, rtol=0)

    jt, js = jnp.asarray(table), jlat.row_adam_init(jnp.asarray(table))
    tt, ts = torch.tensor(table), tlat.row_adam_init(torch.tensor(table))
    for step in range(4):
        g = np.zeros_like(table)
        rows = idx if step % 2 == 0 else idx[:2]
        g[rows] = rng.normal(size=(len(rows), 6))
        jt, js = jlat.row_adam_update(jt, jnp.asarray(g), js, jnp.asarray(rows),
                                      jnp.float32(1e-2))
        tt, ts = tlat.row_adam_update(tt, torch.tensor(g), ts, torch.tensor(rows), 1e-2)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-7, rtol=0)
        np.testing.assert_allclose(ts.exp_avg_sq.numpy(), np.asarray(js.exp_avg_sq),
                                   atol=1e-7, rtol=1e-6)
        assert int(ts.step) == int(js.step)

    grads = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    for max_norm in (0.1, 100.0):
        (jc, jn) = jlat.clip_global_norm([jnp.asarray(g) for g in grads], max_norm)
        tc, tn = tlat.clip_global_norm([torch.tensor(g) for g in grads], max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-7)
        for a, b in zip(tc, jc):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7, rtol=0)


@pytest.mark.parametrize("interval", [600, 5000])
def test_lr_schedules_match_jax(interval):
    class Stub:
        def __init__(self, cfg):
            self.cfg = cfg

    cfg = {"lr": 5e-4, "lr_lat": 1e-3, "lr_decay_factor": 0.5, "lr_decay_factor_lat": 0.5,
           "lr_decay_interval": interval, "lr_decay_interval_lat": interval}
    stub = Stub(cfg)
    for e in range(12001):
        assert IdentityTrainer.lr_at(stub, e) == JIdentityTrainer.lr_at(stub, e)
        assert IdentityTrainer.lr_lat_at(stub, e) == JIdentityTrainer.lr_lat_at(stub, e)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_batches_bit_identical(seed):
    kw = dict(n_subjects=5, batch_size=2, n_face=750, n_non_face=250, n_anchors=39,
              seed=seed)
    ours = list(SyntheticIdentityDataset(**kw).batch_iter(seed=seed))
    ref = list(JSyntheticIdentityDataset(**kw).batch_iter(seed=seed))
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("n_anchors", [None, 39])
@pytest.mark.parametrize("seed", [0, 3, 9])
def test_synthetic_deformation_batches_bit_identical(seed, n_anchors):
    ident = dict(n_subjects=5, batch_size=2, n_face=250, n_non_face=125, n_anchors=n_anchors,
                 seed=seed)
    kw = dict(n_expressions=3, n_points=500, batch_size=4, seed=seed + 1, warp_scale=0.08)
    ours = SyntheticDeformationDataset(SyntheticIdentityDataset(**ident), **kw)
    ref = JSyntheticDeformationDataset(JSyntheticIdentityDataset(**ident), **kw)
    for attr in ("subject_steps", "steps", "subject_index", "neutral_expr_index"):
        assert getattr(ours, attr) == getattr(ref, attr), attr
    for attr in ("t", "a"):
        assert getattr(ours, attr).dtype == getattr(ref, attr).dtype
        np.testing.assert_array_equal(getattr(ours, attr), getattr(ref, attr))
    pts = np.random.default_rng(seed).normal(size=(64, 3)).astype(np.float32)
    for scan in range(len(ref)):
        a, b = ours.warp(scan, pts), ref.warp(scan, pts)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    batches, jbatches = list(ours.batch_iter(seed=seed)), list(ref.batch_iter(seed=seed))
    assert len(batches) == len(jbatches) == 4
    for a, b in zip(batches, jbatches):
        assert sorted(a) == sorted(b)
        assert ("gt_anchors" in a) == bool(n_anchors)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def datasets():
    return (SyntheticIdentityDataset(n_subjects=4, batch_size=2, seed=0, **DATA),
            SyntheticIdentityDataset(n_subjects=2, batch_size=2, seed=5, **DATA))


def capture(logger):
    history = []
    logger.log = lambda m, step=None: history.append(dict(m))
    return history


@pytest.mark.parametrize("family", ["nphm", "npm"])
def test_identity_trainer_matches_jax(models, npm_models, family, tmp_path):
    jd, jp, td = models if family == "nphm" else npm_models
    jtr = JIdentityTrainer(jd, jax.tree_util.tree_map(jnp.array, jp), train_cfg(), JSyntheticIdentityDataset(
        n_subjects=4, batch_size=2, seed=0, **DATA), JSyntheticIdentityDataset(
        n_subjects=2, batch_size=2, seed=5, **DATA), "j", exp_dir=str(tmp_path),
        logger=JMetricsLogger(quiet=True), recon_resolution=16)
    start = trainer_state_from_jax(np_tree(jtr._state_tree()))
    tr = IdentityTrainer(td, from_numpy_pytree(start["params"], "cpu"), train_cfg(),
                         *datasets(), "t",
                         exp_dir=str(tmp_path), logger=MetricsLogger(quiet=True),
                         recon_resolution=16, device="cpu")
    tr.load_state_dict(start)
    jhist, hist = capture(jtr.logger), capture(tr.logger)
    jtr.train_model(2)
    tr.train_model(2)

    assert len(hist) == len(jhist) == 2
    for h, jh in zip(hist, jhist):
        for k in jh:
            if k.startswith(("step_time", "steps_per")):
                continue
            np.testing.assert_allclose(h[k], jh[k], atol=1e-5, rtol=0, err_msg=k)
    ref = trainer_state_from_jax(np_tree(jtr._state_tree()))
    got = tr.state_dict()
    for key in ("params", "latents", "latents_val"):
        for a, b in zip(jax.tree_util.tree_leaves(got[key]),
                        jax.tree_util.tree_leaves(ref[key])):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=key)
    assert int(got["opt_state"]["count"]) == int(ref["opt_state"]["count"]) == 4
    assert (tmp_path / "t" / "recs" / "epoch_0").is_dir()


def test_checkpoint_resume_equals_uninterrupted(models, tmp_path):
    _jd, jp, td = models
    params = from_numpy_pytree(np_tree(jp), device="cpu")
    cfg = train_cfg(ckpt_interval=1)

    def trainer(name):
        return IdentityTrainer(td, copy.deepcopy(params), cfg, *datasets(), name,
                               exp_dir=str(tmp_path), logger=MetricsLogger(quiet=True),
                               recon_resolution=16, device="cpu")

    full = trainer("full")
    full.train_model(3)
    trainer("cut").train_model(2)
    resumed = trainer("cut")
    assert resumed.load_checkpoint() == 2
    resumed = trainer("cut")
    resumed.train_model(3)
    a, b = full.state_dict(), resumed.state_dict()
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert (tmp_path / "cut" / "checkpoints" / "checkpoint_epoch_2.pkl").exists()
    assert list((tmp_path / "cut").glob("val_min=*.npy"))
