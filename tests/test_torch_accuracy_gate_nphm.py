"""Flagship-NPHM quality gate of the port on the CPU (counterpart of
``tests/test_accuracy_gate_nphm.py``).

Train the tiny flagship two-stage model on analytic ellipsoid heads (NPHM
ensemble with mlp_pos, mirroring and blending live; compress-mode
deformation), joint-fit a HELD-OUT subject from POSED observations
(Broyden correspondence search + IFT gradients), and assert Chamfer-L1
below the JAX file's thresholds.  Model config, dataset arguments,
training config, epochs, fit config and thresholds are the JAX file's; the
weights are the JAX decoders' ``init`` at the same keys, bridged with
``from_numpy_pytree``.  The rest runs through the port on the CPU (the
kernels' plain versions), with the port's own latent-table inits, noise
and fit draws, so the figures are not the JAX run's.
"""

import numpy as np
import pytest

from nphm_tpu.models import DeformationConfig as JDeformationConfig
from nphm_tpu.models import NPHMConfig as JNPHMConfig
from nphm_tpu.models import make_deformation_decoder as jmake_deformation_decoder
from nphm_tpu.models import make_nphm_decoder as jmake_nphm_decoder
from nphm_tpu_torch.data.synthetic import (
    SyntheticDeformationDataset,
    SyntheticIdentityDataset,
    _ellipsoid_surface,
)
from nphm_tpu_torch.fitting import FittingConfig, fit_joint
from nphm_tpu_torch.models import (
    DeformationConfig,
    NPHMConfig,
    make_deformation_decoder,
    make_nphm_decoder,
)
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


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """Tiny-dims flagship pipeline: NPHM ensemble stage 1, compress-mode
    deformation stage 2, joint fit of a held-out subject from posed clouds."""
    from nphm_tpu_torch.training.trainer import IdentityTrainer
    from nphm_tpu_torch.training.trainer_corresp import DeformationTrainer

    tmp = str(tmp_path_factory.mktemp("nphm_gate"))
    cfg_m = dict(
        lat_dim_glob=8, lat_dim_loc=4, n_loc=7, n_symm_pairs=3,
        hidden_dim=32, n_layers=4, pos_mlp_dim=16,
    )
    dcfg = dict(
        mode="compress", lat_dim_expr=8, lat_dim_id=8,
        lat_dim_glob_shape=8, lat_dim_loc_shape=4, n_loc=7,
        hidden_dim=32, n_layers=4,
    )
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(7, 3))
    mean_anchors = (
        0.45 * dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    ).astype(np.float32)
    dec = make_nphm_decoder(NPHMConfig(**cfg_m), mean_anchors)
    params = jax_init(jmake_nphm_decoder(JNPHMConfig(**cfg_m), mean_anchors), 0)

    ident = SyntheticIdentityDataset(
        n_subjects=6, n_face=250, n_non_face=125, batch_size=6,
        n_anchors=7, seed=0,
    )
    val = SyntheticIdentityDataset(
        n_subjects=2, n_face=250, n_non_face=125, batch_size=2,
        n_anchors=7, seed=5,
    )
    epochs, def_epochs = 200, 80
    tcfg = {
        "training": {
            "batch_size": 6, "ckpt_interval": 10**9,
            "grad_clip": 0.1, "grad_clip_lat": 0.1,
            "lr": 0.0025, "lr_lat": 0.006,
            "lr_decay_factor": 0.5, "lr_decay_factor_lat": 0.5,
            "lr_decay_interval": epochs // 3,
            "lr_decay_interval_lat": epochs // 3,
            "npoints_decoder": 250, "npoints_decoder_non": 125,
            "sigma_near": 0.01, "weight_decay": 0.01,
            "lambdas": {
                "lat_reg": 0.01, "surf_sdf": 2.0, "normals": 0.3,
                "space_sdf": 0.01, "grad": 0.1, "anchors": 7.5,
                "symm_dist": 0.01, "middle_dist": 0.0,
            },
        }
    }
    tr = IdentityTrainer(
        dec, params, tcfg, ident, val, "nphm_gate", exp_dir=tmp,
        logger=MetricsLogger(quiet=True), recon_resolution=RECON_RES, device=DEV,
    )
    tr.train_model(epochs)

    def_train = SyntheticDeformationDataset(
        ident, n_expressions=2, n_points=500, batch_size=6, warp_scale=0.08
    )
    def_val = SyntheticDeformationDataset(
        val, n_expressions=1, n_points=500, batch_size=2, seed=9
    )
    ddec = make_deformation_decoder(DeformationConfig(**dcfg))
    dparams = jax_init(jmake_deformation_decoder(JDeformationConfig(**dcfg)), 1)
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
        ddec, dparams, dec, dtcfg, def_train, def_val, "nphm_gate_def",
        exp_dir=tmp, shape_state=shape_state, logger=MetricsLogger(quiet=True),
        recon_resolution=RECON_RES, device=DEV,
    )
    dtr.train_model(def_epochs)

    # joint fit of a HELD-OUT ellipsoid from POSED observations through
    # three trained warps (the reference's full fitting protocol)
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
    mesh_can = extract_mesh(
        dec, tr.params, np.asarray(lat_s).reshape(1, -1), *BOX, 64, device=DEV
    )
    return dict(
        dec=dec, tr=tr, ident=ident, ddec=ddec, dtr=dtr,
        def_train=def_train, warp_scans=warp_scans,
        lat_e=lat_e, lat_s=lat_s, anchors_fit=anchors_fit, hist=hist,
        mesh_can=mesh_can,
    )


@pytest.mark.integration
def test_nphm_trained_reconstruction_gate(flagship):
    """Auto-decoded ensemble reconstruction of a train subject below chamfer
    0.05, blending/mlp_pos/mirroring live."""
    f = flagship
    mesh = extract_mesh(
        f["dec"], f["tr"].params, f["tr"].latents[0][None].cpu().numpy(),
        *BOX, 64, device=DEV,
    )
    ch = chamfer(
        mesh, _gt_surface(f["ident"].radii[0], f["ident"].centers[0])
    )
    assert ch < 0.05, f"NPHM train-subject chamfer {ch}"


@pytest.mark.integration
def test_nphm_joint_fit_canonical_gate(flagship):
    """fit_joint (Broyden + IFT through the compress-mode warp) recovers the
    held-out subject's canonical geometry below chamfer 0.12, and the
    Broyden search keeps most correspondences valid."""
    f = flagship
    ch = chamfer(f["mesh_can"], _gt_surface(HELDOUT_RADII, HELDOUT_CENTER))
    assert ch < 0.12, f"joint-fit canonical chamfer {ch}"
    n_valid = float(np.asarray(f["hist"]["n_valid"])[-1])
    assert n_valid > 0.5 * 3 * 500, f"valid correspondences {n_valid}"


@pytest.mark.integration
def test_nphm_joint_fit_posed_gate(flagship):
    """Canonical fit + fitted per-expression code deformed through the
    trained compress-mode field lands near the POSED ground truth (chamfer
    < 0.12)."""
    f = flagship
    eval_obs = 1
    anchors = f["anchors_fit"]
    mesh_posed = deform_mesh(
        f["mesh_can"], f["ddec"], f["dtr"].params,
        np.asarray(f["lat_e"][eval_obs])[None],
        anchors=None if anchors is None else np.asarray(anchors[0]),
        lat_shape=np.asarray(f["lat_s"]).reshape(1, -1), device=DEV,
    )
    gt_posed = f["def_train"].warp(
        f["warp_scans"][eval_obs], _gt_surface(HELDOUT_RADII, HELDOUT_CENTER)
    )
    ch = chamfer(mesh_posed, gt_posed)
    assert ch < 0.12, f"joint-fit posed chamfer {ch}"
