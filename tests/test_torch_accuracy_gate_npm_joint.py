"""NPM-family joint-fit quality gate of the port on the CPU (counterpart of
``tests/test_accuracy_gate_npm_joint.py``).

Train the tiny two-stage NPM model on analytic ellipsoid heads: a global
DeepSDF identity, then an npm-mode DeepSDF offsets field built through
``config.build_expression_decoder(cfg, "npm")``, the constructor the CLIs
use.  Joint-fit a HELD-OUT subject from POSED observations (the anchor-free
branches of ``fit_joint``) and assert Chamfer-L1 below the JAX file's
thresholds.  Model config, dataset arguments, training config, epochs, fit
config and thresholds are the JAX file's; the weights are the JAX
decoders' ``init`` at the same keys, bridged with ``from_numpy_pytree``.
The rest runs through the port on the CPU, with its own latent-table
inits and fit draws, so the figures are not the JAX run's.
"""

import numpy as np
import pytest

from nphm_tpu.config import build_expression_decoder as jbuild_expression_decoder
from nphm_tpu.models import DeepSDFConfig as JDeepSDFConfig
from nphm_tpu.models import make_npm_decoder as jmake_npm_decoder
from nphm_tpu_torch.config import build_expression_decoder
from nphm_tpu_torch.data.synthetic import (
    SyntheticDeformationDataset,
    SyntheticIdentityDataset,
    _ellipsoid_surface,
)
from nphm_tpu_torch.fitting import FittingConfig, fit_joint
from nphm_tpu_torch.models import DeepSDFConfig, make_npm_decoder
from nphm_tpu_torch.reconstruction.extract import deform_mesh, extract_mesh
from nphm_tpu_torch.utils.logging_utils import MetricsLogger

from _torch_gate import (  # noqa: F401  (two_threads: the module's fixture)
    BOX,
    DEV,
    HELDOUT_CENTER,
    HELDOUT_RADII,
    RECON_RES,
    _gt_surface,
    chamfer,
    jax_init,
    two_threads,
)

EX_CFG = {
    "id_decoder": {"decoder_lat_dim": 16},
    "ex_decoder": {
        "decoder_lat_dim": 8,
        "decoder_hidden_dim": 64,
        "decoder_nlayers": 4,
    },
}


@pytest.fixture(scope="module")
def npm_pipeline(tmp_path_factory):
    """Tiny-dims NPM pipeline: DeepSDF identity stage 1, npm-mode DeepSDF
    offsets field stage 2 (via the CLI's config constructor), joint fit of a
    held-out subject from posed clouds."""
    from nphm_tpu_torch.training.trainer import IdentityTrainer
    from nphm_tpu_torch.training.trainer_corresp import DeformationTrainer

    tmp = str(tmp_path_factory.mktemp("npm_joint_gate"))
    cfg_m = dict(lat_dim=16, hidden_dim=64, n_layers=4, geometric_init=True, radius_init=0.5)
    dec = make_npm_decoder(DeepSDFConfig(**cfg_m))
    params = jax_init(jmake_npm_decoder(JDeepSDFConfig(**cfg_m)), 0)

    ident = SyntheticIdentityDataset(n_subjects=6, batch_size=6, seed=0)
    val = SyntheticIdentityDataset(n_subjects=2, batch_size=2, seed=5)
    epochs, def_epochs = 200, 80
    tcfg = {
        "training": {
            "batch_size": 6, "ckpt_interval": 10**9,
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
        dec, params, tcfg, ident, val, "npm_joint_gate", exp_dir=tmp,
        logger=MetricsLogger(quiet=True), recon_resolution=RECON_RES, device=DEV,
    )
    tr.train_model(epochs)

    # stage 2 through the constructor the train_corresp / fitting CLIs use
    # for -mode npm: DeepSDF(id + expr -> 3 offsets)
    ddec = build_expression_decoder(EX_CFG, mode="npm")
    assert ddec.kind == "deformation_npm" and ddec.lat_dim == 8
    dparams = jax_init(jbuild_expression_decoder(EX_CFG, mode="npm"), 1)

    def_train = SyntheticDeformationDataset(
        ident, n_expressions=2, n_points=500, batch_size=6, warp_scale=0.08
    )
    def_val = SyntheticDeformationDataset(
        val, n_expressions=1, n_points=500, batch_size=2, seed=9
    )
    shape_state = {
        "params": tr.params,
        "latents": tr.latents.cpu().numpy(),
        "latents_val": tr.latents_val.cpu().numpy(),
    }
    dtcfg = {
        "training": {
            "batch_size": 6, "ckpt_interval": 10**9,
            "grad_clip": 0.025, "grad_clip_lat": 0.025,
            "lambdas": {
                "corresp": 100.0, "lat_reg": 5e-5, "loss_reg_zero": 5e-5,
            },
            "lr": 0.001, "lr_lat": 0.005,
            "lr_decay_factor": 0.5, "lr_decay_factor_lat": 0.5,
            "lr_decay_interval": def_epochs // 3,
            "lr_decay_interval_lat": def_epochs // 3,
            "weight_decay": 0.0005,
        }
    }
    dtr = DeformationTrainer(
        ddec, dparams, dec, dtcfg, def_train, def_val, "npm_joint_gate_def",
        exp_dir=tmp, shape_state=shape_state, logger=MetricsLogger(quiet=True),
        recon_resolution=RECON_RES, device=DEV,
    )
    dtr.train_model(def_epochs)

    # joint fit of a HELD-OUT ellipsoid from POSED observations through
    # three trained warps: the NPM analogue of the reference protocol
    warp_scans = [0, 1, 2]
    posed_obs = []
    for i, ws in enumerate(warp_scans):
        cloud = _ellipsoid_surface(
            HELDOUT_RADII, HELDOUT_CENTER, 1500, np.random.default_rng(100 + i)
        )[0]
        posed_obs.append(def_train.warp(ws, cloud).astype(np.float32))
    fc = FittingConfig(
        n_steps=150, n_obs_per_batch=3, n_points_per_obs=500, log_every=10**9
    )
    lat_e, lat_s, anchors_fit, hist = fit_joint(
        dec, tr.params, ddec, dtr.params, posed_obs, cfg=fc, verbose=False,
        device=DEV,
    )
    assert anchors_fit is None  # NPM has no anchor MLP
    mesh_can = extract_mesh(
        dec, tr.params, np.asarray(lat_s).reshape(1, -1), *BOX, 64, device=DEV
    )
    return dict(
        dec=dec, tr=tr, ident=ident, ddec=ddec, dtr=dtr,
        def_train=def_train, warp_scans=warp_scans,
        lat_e=lat_e, lat_s=lat_s, hist=hist, mesh_can=mesh_can,
    )


@pytest.mark.integration
def test_npm_trained_reconstruction_gate(npm_pipeline):
    """Auto-decoded DeepSDF reconstruction of a train subject below chamfer
    0.03."""
    f = npm_pipeline
    mesh = extract_mesh(
        f["dec"], f["tr"].params, f["tr"].latents[0][None].cpu().numpy(),
        *BOX, 64, device=DEV,
    )
    ch = chamfer(mesh, _gt_surface(f["ident"].radii[0], f["ident"].centers[0]))
    assert ch < 0.03, f"NPM train-subject chamfer {ch}"


@pytest.mark.integration
def test_npm_joint_fit_canonical_gate(npm_pipeline):
    """fit_joint (Broyden + IFT through the npm-mode offsets field, global-
    latent regularizer branch) recovers the held-out canonical geometry below
    chamfer 0.08, with most correspondences valid."""
    f = npm_pipeline
    ch = chamfer(f["mesh_can"], _gt_surface(HELDOUT_RADII, HELDOUT_CENTER))
    assert ch < 0.08, f"NPM joint-fit canonical chamfer {ch}"
    n_valid = float(np.asarray(f["hist"]["n_valid"])[-1])
    assert n_valid > 0.5 * 3 * 500, f"valid correspondences {n_valid}"


@pytest.mark.integration
def test_npm_joint_fit_posed_gate(npm_pipeline):
    """Canonical fit + fitted expression code deformed through the npm-mode
    field lands near the POSED ground truth (chamfer < 0.09)."""
    f = npm_pipeline
    eval_obs = 1
    mesh_posed = deform_mesh(
        f["mesh_can"], f["ddec"], f["dtr"].params,
        np.asarray(f["lat_e"][eval_obs])[None],
        lat_shape=np.asarray(f["lat_s"]).reshape(1, -1), device=DEV,
    )
    gt_posed = f["def_train"].warp(
        f["warp_scans"][eval_obs], _gt_surface(HELDOUT_RADII, HELDOUT_CENTER)
    )
    ch = chamfer(mesh_posed, gt_posed)
    assert ch < 0.09, f"NPM joint-fit posed chamfer {ch}"
