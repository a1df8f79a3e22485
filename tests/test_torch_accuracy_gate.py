"""Reconstruction-quality gates of the port on the CPU (counterpart of
``tests/test_accuracy_gate.py``): the NPM DeepSDF family.

The same closed-form ellipsoid heads, model config, training config,
epochs, fit config and thresholds as the JAX file; the weights are the JAX
decoders' ``init`` at the same keys, bridged with ``from_numpy_pytree``.
Everything else runs through the port on the CPU (the kernels' plain
versions): ``IdentityTrainer`` 200 epochs, ``extract_mesh`` at res 64,
``fit_identity`` of a held-out ellipsoid, an ``expr_only``
``DeformationTrainer`` 80 epochs and ``deform_mesh``.  Chamfer-L1 goes
through the port's ``sample_mesh_surface`` and ``eval_pointcloud``.  The
port draws its own latent-table inits and fit samples (``torch.Generator``),
so the figures are not the JAX run's, only held to the same thresholds.
"""

import numpy as np
import pytest

from nphm_tpu.models import DeepSDFConfig as JDeepSDFConfig
from nphm_tpu.models import DeformationConfig as JDeformationConfig
from nphm_tpu.models import make_deformation_decoder as jmake_deformation_decoder
from nphm_tpu.models import make_npm_decoder as jmake_npm_decoder
from nphm_tpu_torch.data.synthetic import (
    SyntheticDeformationDataset,
    SyntheticIdentityDataset,
    _ellipsoid_surface,
)
from nphm_tpu_torch.fitting import FittingConfig, fit_identity
from nphm_tpu_torch.models import (
    DeepSDFConfig,
    DeformationConfig,
    make_deformation_decoder,
    make_npm_decoder,
)
from nphm_tpu_torch.reconstruction.extract import deform_mesh, extract_mesh
from nphm_tpu_torch.utils.logging_utils import MetricsLogger

from _torch_gate import (  # noqa: F401  (two_threads: the module's fixture)
    BOX,
    DEV,
    RECON_RES,
    _gt_surface,
    chamfer,
    jax_init,
    two_threads,
)


def _row(table, i, cols=None):
    row = table[i] if cols is None else table[i, :cols]
    return row[None].cpu().numpy()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    from nphm_tpu_torch.training.trainer import IdentityTrainer

    tmp = str(tmp_path_factory.mktemp("gate"))
    cfg_m = dict(lat_dim=16, hidden_dim=64, n_layers=4, geometric_init=True, radius_init=0.5)
    dec = make_npm_decoder(DeepSDFConfig(**cfg_m))
    params = jax_init(jmake_npm_decoder(JDeepSDFConfig(**cfg_m)), 0)
    train_ds = SyntheticIdentityDataset(n_subjects=6, batch_size=3, seed=0)
    val_ds = SyntheticIdentityDataset(n_subjects=2, batch_size=2, seed=5)
    cfg = {
        "training": {
            "batch_size": 4, "ckpt_interval": 10**9,
            "grad_clip": 0.1, "grad_clip_lat": 0.1,
            "lr": 0.0015, "lr_lat": 0.003,
            "lr_decay_factor": 0.5, "lr_decay_factor_lat": 0.5,
            "lr_decay_interval": 120, "lr_decay_interval_lat": 120,
            "npoints_decoder": 250, "npoints_decoder_non": 250,
            "sigma_near": 0.01, "weight_decay": 0.01,
            "lambdas": {
                "lat_reg": 0.01, "surf_sdf": 2.0, "normals": 0.3,
                "space_sdf": 0.01, "grad": 0.1,
            },
        }
    }
    tr = IdentityTrainer(
        dec, params, cfg, train_ds, val_ds, "gate", exp_dir=tmp,
        logger=MetricsLogger(quiet=True), recon_resolution=RECON_RES, device=DEV,
    )
    tr.train_model(200)
    return dec, tr, train_ds


@pytest.mark.integration
def test_trained_reconstruction_chamfer_gate(trained):
    """Auto-decoded train subject reconstructs below chamfer 0.025."""
    dec, tr, ds = trained
    mesh = extract_mesh(dec, tr.params, _row(tr.latents, 0), *BOX, 64, device=DEV)
    ch = chamfer(mesh, _gt_surface(ds.radii[0], ds.centers[0]))
    assert ch < 0.025, f"train-subject chamfer {ch}"


@pytest.mark.integration
def test_fitted_heldout_chamfer_gate(trained):
    """fit_identity on point clouds of a HELD-OUT ellipsoid reconstructs it
    below chamfer 0.02: observe -> fit -> extract -> evaluate."""
    dec, tr, _ds = trained
    rng = np.random.default_rng(7)
    radii = np.array([0.45, 0.5, 0.4], np.float32)
    center = np.array([0.02, -0.01, 0.03], np.float32)
    obs = [_ellipsoid_surface(radii, center, 1500, rng)[0] for _ in range(3)]
    fc = FittingConfig(
        n_steps=150, n_obs_per_batch=3, n_points_per_obs=500, log_every=10**9
    )
    lat_fit, _anchors, _hist = fit_identity(
        dec, tr.params, obs, cfg=fc, verbose=False, device=DEV
    )
    mesh = extract_mesh(
        dec, tr.params, np.asarray(lat_fit).reshape(1, -1), *BOX, 64, device=DEV
    )
    ch = chamfer(mesh, _gt_surface(radii, center))
    assert ch < 0.02, f"fitted held-out chamfer {ch}"


@pytest.mark.integration
def test_deformation_moves_mesh_toward_posed_gate(trained, tmp_path):
    """Stage 2: the trained deformation field moves the neutral mesh
    measurably toward the posed surface: deformed != neutral and
    chamfer(deformed, posed) < chamfer(neutral, posed), and below 0.03."""
    from nphm_tpu_torch.training.trainer_corresp import DeformationTrainer

    dec, tr, ident = trained
    train_ds = SyntheticDeformationDataset(
        ident, n_expressions=2, batch_size=4, warp_scale=0.08
    )
    # val warps cover the VAL identity subjects: the trainer indexes
    # shape_state["latents_val"] (2 rows) with the val dataset's subj_ind
    ident_val = SyntheticIdentityDataset(n_subjects=2, batch_size=2, seed=5)
    val_ds = SyntheticDeformationDataset(
        ident_val, n_expressions=1, batch_size=4, seed=9
    )
    dcfg = dict(mode="expr_only", lat_dim_expr=8, hidden_dim=64, n_layers=4)
    ddec = make_deformation_decoder(DeformationConfig(**dcfg))
    dparams = jax_init(jmake_deformation_decoder(JDeformationConfig(**dcfg)), 0)
    shape_state = {
        "params": {},
        "latents": tr.latents[:, :4].cpu().numpy(),
        "latents_val": tr.latents_val[:, :4].cpu().numpy(),
    }
    cfg = {
        "training": {
            "batch_size": 4, "ckpt_interval": 10**9,
            "grad_clip": 0.025, "grad_clip_lat": 0.025,
            "lambdas": {
                "corresp": 100.0, "lat_reg": 5e-5, "loss_reg_zero": 5e-5
            },
            "lr": 0.001, "lr_lat": 0.005,
            "lr_decay_factor": 0.5, "lr_decay_factor_lat": 0.5,
            "lr_decay_interval": 100, "lr_decay_interval_lat": 100,
            "weight_decay": 0.0005,
        }
    }
    dtr = DeformationTrainer(
        ddec, dparams, None, cfg, train_ds, val_ds, "gate_def",
        exp_dir=str(tmp_path), shape_state=shape_state,
        logger=MetricsLogger(quiet=True), recon_resolution=RECON_RES, device=DEV,
    )
    dtr.train_model(80)

    # scan 1 = (subject 0, expression 1): a genuinely non-neutral warp
    scan = 1
    subj = train_ds.subject_steps[scan]
    mesh_neutral = extract_mesh(dec, tr.params, _row(tr.latents, subj), *BOX, 64, device=DEV)
    mesh_def = deform_mesh(
        mesh_neutral, ddec, dtr.params, _row(dtr.latents, scan),
        lat_shape=_row(tr.latents, subj, 4), device=DEV,
    )
    # GT posed surface: the dataset's analytic warp of the GT ellipsoid
    gt_neutral = _gt_surface(ident.radii[subj], ident.centers[subj])
    gt_posed = train_ds.warp(scan, gt_neutral)

    moved = float(np.abs(mesh_def.vertices - mesh_neutral.vertices).max())
    assert moved > 0.01, "deformation field is (near) zero"

    ch_neutral = chamfer(mesh_neutral, gt_posed)
    ch_def = chamfer(mesh_def, gt_posed)
    assert ch_def < ch_neutral, (
        f"deformed mesh no closer to posed GT ({ch_def} vs {ch_neutral})"
    )
    assert ch_def < 0.03, f"deformed chamfer {ch_def}"
