"""The port's stage-2 training stack vs the JAX package, on the CPU.

Tiny NPHM identity decoder (glob 8, loc 4, 6 anchors, hidden 16, 4 layers)
and compress-mode deformation field (expr 8, id 8, hidden 32, 4 layers);
data from the port's dummy tree (``data/dummy.py``), read by both packages.

- ``IdentityDataset`` and ``DeformationDataset`` batches, train and val,
  are byte-equal to the JAX package's for seeds 0 and 3.
- ``deformation_loss`` at train time, handed the noise and prior samples
  the JAX loss draws from its key: every term and the gradient of the
  weighted sum w.r.t. the field's params and the expression codes, rtol
  1e-4 / atol 1e-7 (fp32, only the summation order differs).
- ``DeformationTrainer``: from the JAX trainer's params and latent tables,
  three train steps and one validation step on the same batches and draws;
  the loss terms of every step agree within rtol 1e-5, the params and both
  latent tables after them within atol 1e-6 (lr 1e-4: a step moves a
  weight by at most ~1e-4).  ``lr_at`` / ``lr_lat_at`` equal JAX's.
- A checkpoint round trip resumes at the next epoch with the same state,
  and a subprocess with ``jax`` blocked trains an epoch from a stage-1
  checkpoint written by the JAX trainer.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from nphm_tpu import env_paths as jenv
from nphm_tpu.data.datasets import (
    DeformationDataset as JDeformationDataset,
    IdentityDataset as JIdentityDataset,
)
from nphm_tpu.data.manager import DataManager as JDataManager
from nphm_tpu.models import (
    DeformationConfig as JDeformationConfig,
    NPHMConfig as JNPHMConfig,
    make_deformation_decoder as jmake_deformation,
    make_nphm_decoder as jmake_nphm,
)
from nphm_tpu.training.losses import deformation_loss as jdeformation_loss
from nphm_tpu.training.trainer_corresp import DeformationTrainer as JDeformationTrainer
from nphm_tpu.utils.logging_utils import MetricsLogger as JMetricsLogger
from nphm_tpu_torch import env_paths as tenv
from nphm_tpu_torch.data.datasets import DeformationDataset, IdentityDataset
from nphm_tpu_torch.data.dummy import dummy_env, generate_dummy_data
from nphm_tpu_torch.data.manager import DataManager
from nphm_tpu_torch.models import (
    DeformationConfig,
    NPHMConfig,
    make_deformation_decoder,
    make_nphm_decoder,
)
from nphm_tpu_torch.training.losses import deformation_loss
from nphm_tpu_torch.training.trainer_corresp import DeformationTrainer
from nphm_tpu_torch.utils.logging_utils import MetricsLogger
from nphm_tpu_torch.utils.params import from_numpy_pytree, to_numpy_pytree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBJECTS = (351, 365, 199)  # 199 is in the eval split
SHAPE_KW = dict(lat_dim_glob=8, lat_dim_loc=4, n_loc=6, n_symm_pairs=2, hidden_dim=16,
                n_layers=4, pos_mlp_dim=16)
DEF_KW = dict(mode="compress", lat_dim_glob_shape=8, lat_dim_loc_shape=4, n_loc=6,
              lat_dim_expr=8, lat_dim_id=8, hidden_dim=32, n_layers=4)
TRAIN = {"batch_size": 2, "ckpt_interval": 1, "grad_clip": 0.025, "grad_clip_lat": 0.025,
         "lambdas": {"corresp": 100.0, "lat_reg": 5.0e-05, "loss_reg_zero": 5.0e-05},
         "lr": 1e-4, "lr_lat": 5e-4, "lr_decay_factor": 0.5, "lr_decay_factor_lat": 0.5,
         "lr_decay_interval": 600, "lr_decay_interval_lat": 600, "weight_decay": 5e-4,
         "npoints_decoder": 64}


def bridge(tree):
    return from_numpy_pytree(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A dummy tree; both packages' env_paths pointed at it."""
    root = str(tmp_path_factory.mktemp("dummy"))
    generate_dummy_data(root, subjects=SUBJECTS, n_expressions=2, n_supervision=2000)
    env = dummy_env(root)
    neutrals = {s: 0 for s in SUBJECTS}
    patch = pytest.MonkeyPatch()
    for mod in (jenv, tenv):
        patch.setattr(mod, "SUPERVISION_IDENTITY", env["NPHM_SUPERVISION_IDENTITY"])
        patch.setattr(mod, "SUPERVISION_DEFORMATION_OPEN", env["NPHM_SUPERVISION_DEFORMATION"])
        patch.setattr(mod, "NUM_SPLITS", 2)
        patch.setattr(mod, "NUM_SPLITS_EXPR", 2)
        patch.setattr(mod, "neutrals", neutrals)
        patch.setattr(mod, "neutrals_closed", neutrals)
    yield root, env
    patch.undo()


def assert_same_batches(ours, ref):
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("seed", [0, 3])
def test_datasets_batches_byte_equal_jax(tree, seed):
    root, _ = tree
    for mode in ("train", "val"):
        kw = dict(mode=mode, n_supervision_points_face=40, n_supervision_points_non_face=25,
                  batch_size=2, sigma_near=0.01)
        ours = IdentityDataset(manager=DataManager(dummy_path=root), **kw)
        ref = JIdentityDataset(manager=JDataManager(dummy_path=root), **kw)
        assert ours.subject_steps == ref.subject_steps
        assert_same_batches(list(ours.batch_iter(seed=seed)), list(ref.batch_iter(seed=seed)))
        ours = DeformationDataset(mode, 50, 3, manager=DataManager(dummy_path=root))
        ref = JDeformationDataset(mode, 50, 3, manager=JDataManager(dummy_path=root))
        assert (ours.steps, ours.subject_index) == (ref.steps, ref.subject_index)
        assert_same_batches(list(ours.batch_iter(seed=seed)), list(ref.batch_iter(seed=seed)))


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(3)
    anchors = (rng.normal(size=(SHAPE_KW["n_loc"], 3)) * 0.25).astype(np.float32)
    js = jmake_nphm(JNPHMConfig(**SHAPE_KW), anchors)
    je = jmake_deformation(JDeformationConfig(**DEF_KW))
    jps, jpe = js.init(jax.random.PRNGKey(0)), je.init(jax.random.PRNGKey(1))
    return dict(js=js, je=je, jps=jps, jpe=jpe,
                ts=make_nphm_decoder(NPHMConfig(**SHAPE_KW), anchors),
                te=make_deformation_decoder(DeformationConfig(**DEF_KW)))


def jax_draws(key, B, n_pts, lat_dim_id):
    """The noise and prior samples ``deformation_loss`` draws from ``key``,
    as the port's ``draws`` callable."""
    k_noise, k_samps, k_noise2 = jax.random.split(key, 3)
    out = {"noise": jax.random.normal(k_noise, (B, lat_dim_id)),
           "samples": jax.random.uniform(k_samps, (B, min(100, n_pts), 3)),
           "noise_reg": jax.random.normal(k_noise2, (B, lat_dim_id))}

    def draw(kind, shape, device):
        t = torch.tensor(np.asarray(out[kind]), device=device)
        assert tuple(t.shape) == tuple(shape), (kind, shape)
        return t

    return draw


def test_deformation_loss_terms_and_grads_match_jax(models):
    m = models
    rng = np.random.default_rng(0)
    B, N = 3, 50
    batch = {"points_neutral": (rng.normal(size=(B, N, 3)) * 0.3).astype(np.float32)}
    batch["points_posed"] = batch["points_neutral"] + 0.02
    lat_shape = (rng.normal(size=(B, m["js"].lat_dim)) * 0.1).astype(np.float32)
    lat_expr = (rng.normal(size=(B, 8)) * 0.1).astype(np.float32)
    anchors = (rng.normal(size=(B, 6, 3)) * 0.3).astype(np.float32)
    lambdas = TRAIN["lambdas"]
    key = jax.random.PRNGKey(5)

    def jloss(p, le):
        t = jdeformation_loss(m["je"], p, {k: jnp.asarray(v) for k, v in batch.items()},
                              jnp.asarray(lat_shape), le, jnp.asarray(anchors), rng=key)
        return sum(lambdas[k] * t[k] for k in t), t

    (_, jterms), (jg_p, jg_le) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        m["jpe"], jnp.asarray(lat_expr))

    params = bridge(m["jpe"])
    leaves = [p.requires_grad_(True) for p in jax.tree_util.tree_leaves(params)]
    le = torch.tensor(lat_expr, requires_grad=True)
    terms = deformation_loss(m["te"], params, {k: torch.tensor(v) for k, v in batch.items()},
                             torch.tensor(lat_shape), le, torch.tensor(anchors),
                             draws=jax_draws(key, B, N, 8))
    loss = sum(lambdas[k] * terms[k] for k in terms)
    grads = torch.autograd.grad(loss, leaves + [le])
    assert sorted(terms) == sorted(jterms)
    for k in terms:
        np.testing.assert_allclose(terms[k].item(), float(jterms[k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    ref = jax.tree_util.tree_leaves(jg_p) + [jg_le]
    assert len(grads) == len(ref)
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-7)
    # the noise enters: without it the corresp term changes
    quiet = deformation_loss(m["te"], params, {k: torch.tensor(v) for k, v in batch.items()},
                             torch.tensor(lat_shape), le, torch.tensor(anchors),
                             training=False, draws=jax_draws(key, B, N, 8))
    assert quiet["corresp"].item() != terms["corresp"].item()


def shape_state(m, n_train, n_val):
    rng = np.random.default_rng(1)
    return {"params": np_tree(m["jps"]),
            "latents": (rng.normal(size=(n_train, m["js"].lat_dim)) * 0.1).astype(np.float32),
            "latents_val": (rng.normal(size=(n_val, m["js"].lat_dim)) * 0.1).astype(np.float32)}


def trainers(m, root, tmp_path):
    cfg = {"training": dict(TRAIN)}
    jds = [JDeformationDataset(mode, 64, 2, manager=JDataManager(dummy_path=root))
           for mode in ("train", "val")]
    tds = [DeformationDataset(mode, 64, 2, manager=DataManager(dummy_path=root))
           for mode in ("train", "val")]
    state = shape_state(m, 2, 1)
    # a copy: the JAX train step donates its params' buffers
    jtr = JDeformationTrainer(m["je"], jax.tree_util.tree_map(jnp.array, m["jpe"]), m["js"],
                              cfg, *jds, "j",
                              exp_dir=str(tmp_path), logger=JMetricsLogger(quiet=True),
                              shape_state=state, recon_resolution=16)
    tr = DeformationTrainer(m["te"], bridge(m["jpe"]), m["ts"], cfg, *tds, "t",
                            exp_dir=str(tmp_path), logger=MetricsLogger(quiet=True),
                            shape_state=state, recon_resolution=16, device="cpu")
    tr.latents = torch.tensor(np.asarray(jtr.latents))
    tr.latents_val = torch.tensor(np.asarray(jtr.latents_val))
    return jtr, tr, jds, tds


def test_deformation_trainer_steps_match_jax(tree, models, tmp_path):
    root, _ = tree
    m = models
    jtr, tr, jds, tds = trainers(m, root, tmp_path)
    for e in (0, 1, 599, 600, 1200, 5000):
        assert tr.lr_at(e) == jtr.lr_at(e) and tr.lr_lat_at(e) == jtr.lr_lat_at(e)
    batches = [b for seed in (0, 1) for b in tds[0].batch_iter(seed=seed)][:3]
    jbatches = [b for seed in (0, 1) for b in jds[0].batch_iter(seed=seed)][:3]
    assert_same_batches(batches, jbatches)
    lr, lr_lat = tr.lr_at(0), tr.lr_lat_at(0)
    for k, (batch, jbatch) in enumerate(zip(batches, jbatches)):
        key = jax.random.PRNGKey(100 + k)
        jtr.params, jtr.opt_state, jtr.latents, jtr.lat_state, jterms = jtr._train_step(
            jtr.params, jtr.opt_state, jtr.latents, jtr.lat_state,
            {kk: jnp.asarray(v) for kk, v in jbatch.items()}, jnp.float32(lr),
            jnp.float32(lr_lat), key)
        tr.draws = jax_draws(key, 2, 64, 8)
        terms = tr._train_step(tr._batch(batch), lr, lr_lat)
        assert sorted(terms) == sorted(jterms)
        for name in terms:
            np.testing.assert_allclose(float(terms[name]), float(jterms[name]), rtol=1e-5,
                                       atol=0, err_msg=f"step {k} {name}")
    vbatch = next(iter(tds[1].batch_iter(seed=0)))
    key = jax.random.PRNGKey(7)
    jtr.latents_val, jtr.lat_state_val, jterms = jtr._val_step(
        jtr.latents_val, jtr.lat_state_val, jtr.params,
        {kk: jnp.asarray(v) for kk, v in vbatch.items()}, jnp.float32(lr_lat), key)
    tr.draws = jax_draws(key, 2, 64, 8)
    terms = tr._val_step(tr._batch(vbatch), lr_lat)
    for name in terms:
        np.testing.assert_allclose(float(terms[name]), float(jterms[name]), rtol=1e-5,
                                   err_msg=f"val {name}")
    for ours, ref in ((tr.params, jtr.params), (tr.latents, jtr.latents),
                      (tr.latents_val, jtr.latents_val)):
        for a, b in zip(jax.tree_util.tree_leaves(to_numpy_pytree(ours)),
                        jax.tree_util.tree_leaves(np_tree(ref))):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_checkpoint_round_trip(tree, models, tmp_path):
    root, _ = tree
    _jtr, tr, _, tds = trainers(models, root, tmp_path)
    tr.train_model(1)
    assert (tmp_path / "t" / "checkpoints" / "checkpoint_epoch_0.pkl").exists()
    assert sorted(os.listdir(tmp_path / "t" / "recs" / "val_epoch_0")) == [
        "gt_199_e0.ply", "mesh_199_e0.ply", "mesh_199_neutral.ply", "reg_199_e0.ply",
        "reg_199_neutral.ply"]
    _jtr, again, _, _ = trainers(models, root, tmp_path)
    assert again.load_checkpoint() == 1
    a, b = tr.state_dict(), again.state_dict()
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_trains_from_jax_written_stage1_checkpoint_without_jax(tree, models, tmp_path):
    root, env = tree
    m = models
    from nphm_tpu.data.synthetic import SyntheticIdentityDataset as JSynthetic
    from nphm_tpu.training.trainer import IdentityTrainer as JIdentityTrainer

    exp_dir = tmp_path / "experiments"
    data = dict(n_face=40, n_non_face=20, n_anchors=6, batch_size=2)
    lam = {"lat_reg": 0.01, "surf_sdf": 2.0, "normals": 0.3, "space_sdf": 0.01, "grad": 0.1,
           "anchors": 7.5, "symm_dist": 0.01, "middle_dist": 0.0}
    jid = JIdentityTrainer(m["js"], m["jps"], {"training": dict(
        TRAIN, lambdas=lam, fused_train_kernel=False)}, JSynthetic(n_subjects=2, seed=0, **data),
        JSynthetic(n_subjects=1, seed=1, **data), "jid", exp_dir=str(exp_dir),
        logger=JMetricsLogger(quiet=True), recon_resolution=16)
    jid.save_checkpoint(1)
    np.save(tmp_path / "jps.npy", np.concatenate(
        [np.ravel(x) for x in jax.tree_util.tree_leaves(np_tree(jid.params))]))
    anchors = np.asarray(m["jps"]["mean_anchors"])
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None  # importing jax fails
        sys.path.insert(0, {ROOT!r})
        import numpy as np, torch
        from nphm_tpu_torch.data.datasets import DeformationDataset
        from nphm_tpu_torch.data.manager import DataManager
        from nphm_tpu_torch.models import (DeformationConfig, NPHMConfig,
            make_deformation_decoder, make_nphm_decoder)
        from nphm_tpu_torch.training.trainer import tree_paths
        from nphm_tpu_torch.training.trainer_corresp import DeformationTrainer
        from nphm_tpu_torch.utils.logging_utils import MetricsLogger
        s = make_nphm_decoder(NPHMConfig(**{SHAPE_KW!r}), np.array({anchors.tolist()!r}))
        e = make_deformation_decoder(DeformationConfig(**{DEF_KW!r}))
        ds = [DeformationDataset(m, 64, 2, manager=DataManager(dummy_path={root!r}))
              for m in ("train", "val")]
        cfg = {{"training": dict({TRAIN!r}, shape_exp_name="jid", shape_ckpt=1)}}
        tr = DeformationTrainer(e, e.init(torch.Generator().manual_seed(0), "cpu"), s, cfg,
                                *ds, "def", exp_dir={str(exp_dir)!r},
                                logger=MetricsLogger(quiet=True), recon_resolution=16,
                                device="cpu")
        flat = np.concatenate([t.numpy().ravel() for _, t in tree_paths(tr.params_shape)])
        assert np.array_equal(flat, np.load({str(tmp_path / "jps.npy")!r}))
        tr.train_model(1)
        print("FOREIGN_LOADED", sorted(m for m in sys.modules if m.startswith("nphm_tpu.")
                                       or m == "nphm_tpu" or (m.startswith("jax")
                                                              and sys.modules[m])))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, **env}, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "FOREIGN_LOADED []" in out.stdout
    assert (exp_dir / "def" / "checkpoints" / "checkpoint_epoch_0.pkl").exists()
