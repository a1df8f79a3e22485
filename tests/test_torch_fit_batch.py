"""The port's batched and identity-only fits vs the JAX package, on the CPU.

- ``fit_joint_batch`` for 5 steps on 3 subjects with ragged observation
  counts, handed the JAX batched fit's own per-(step, subject) draws, vs
  the JAX ``fit_joint_batch`` with the kernels "on" (Pallas in interpret
  mode) and "off": latents at rtol 1e-3 / atol 5e-4, loss history at rtol
  1e-3 / atol 1e-5, executed Broyden iterations equal per subject.  The
  subjects' heads differ in size (radius 0.4, 1.2, 0.08), so under a warm
  budget of 8 their searches stop after different numbers of iterations;
  a subject draws 2 x 40 points a step, 80 search lanes, not a whole
  number of 32-lane tiles, so only the per-subject tile padding keeps one
  subject's count apart from the next one's.
- Padding the subject axis with dummy subjects changes no result.
- Each subject of the batched fit matches ``fit_joint`` on its own draws,
  from zero codes and from given starting codes.
- ``fit_identity`` vs the JAX ``fit_identity`` on the JAX fit's draws.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from nphm_tpu.fitting import (
    FittingConfig as JFittingConfig,
    fit_identity as jfit_identity,
    fit_joint_batch as jfit_joint_batch,
)
from nphm_tpu.models import (
    DeformationConfig as JDeformationConfig,
    NPHMConfig as JNPHMConfig,
    make_deformation_decoder as jmake_deformation,
    make_nphm_decoder as jmake_nphm,
)
from nphm_tpu_torch.fitting import FittingConfig, fit_identity, fit_joint, fit_joint_batch
from nphm_tpu_torch.models import (
    DeformationConfig,
    NPHMConfig,
    make_deformation_decoder,
    make_nphm_decoder,
)
from test_torch_slice import DEF_KW, SHAPE_KW, bridge, jax_draws, nonrigid_observations

FIT = dict(n_steps=5, n_obs_per_batch=2, n_points_per_obs=40, broyden_warm_steps=8,
           log_every=10**9)
N_OBS = (3, 2, 4)  # ragged observation counts of the three subjects
SIZES = (1.0, 3.0, 0.2)  # head sizes of the three subjects, times 0.4
TOL = dict(rtol=1e-3, atol=5e-4)
TOL_LOSS = dict(rtol=1e-3, atol=1e-5)


def batch_draws(seed, subjects_obs, steps, nb, npp):
    """The JAX batched fit's (sel [T, S, nb], idx [T, S, nb, npp]), as its
    scan draws them: fold in the step, then the subject."""
    key = jax.random.PRNGKey(seed)
    sels, idxs = [], []
    for j in range(steps):
        s_sel, s_idx = [], []
        for s, obs in enumerate(subjects_obs):
            k1, k2 = jax.random.split(jax.random.fold_in(jax.random.fold_in(key, j), s))
            lens = jnp.asarray([len(o) for o in obs])
            sel = jax.random.randint(k1, (nb,), 0, len(obs))
            s_idx.append(np.asarray(jax.random.randint(k2, (nb, npp), 0,
                                                       lens[sel][:, None])))
            s_sel.append(np.asarray(sel))
        sels.append(np.stack(s_sel))
        idxs.append(np.stack(s_idx))
    return np.stack(sels), np.stack(idxs)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(5)
    anchors = (rng.normal(size=(SHAPE_KW["n_loc"], 3)) * 0.25).astype(np.float32)
    js = jmake_nphm(JNPHMConfig(**SHAPE_KW), anchors)
    je = jmake_deformation(JDeformationConfig(**DEF_KW))
    jps, jpe = js.init(jax.random.PRNGKey(0)), je.init(jax.random.PRNGKey(1))
    subjects = [[o * size for o in nonrigid_observations(rng, n_obs=n, n_pts=260 - 20 * i)]
                for i, (n, size) in enumerate(zip(N_OBS, SIZES))]
    draws = batch_draws(0, subjects, FIT["n_steps"], FIT["n_obs_per_batch"],
                        FIT["n_points_per_obs"])
    return dict(js=js, jps=jps, je=je, jpe=jpe,
                ts=make_nphm_decoder(NPHMConfig(**SHAPE_KW), anchors), tps=bridge(jps),
                te=make_deformation_decoder(DeformationConfig(**DEF_KW)), tpe=bridge(jpe),
                subjects=subjects, draws=draws, ref={})


def reference(m, fused):
    if fused not in m["ref"]:
        m["ref"][fused] = jfit_joint_batch(
            m["js"], m["jps"], m["je"], m["jpe"], m["subjects"],
            cfg=JFittingConfig(fused_search=fused, fused_shape_fields=fused, **FIT),
            verbose=False)
    return m["ref"][fused]


def port_batch(m, fused, **kw):
    return fit_joint_batch(
        m["ts"], m["tps"], m["te"], m["tpe"], m["subjects"],
        cfg=FittingConfig(fused_search=fused, fused_shape_fields=fused, **FIT),
        verbose=False, device="cpu", sample_draws=m["draws"], **kw)


@pytest.mark.parametrize("fused", ["on", "off"])
def test_fit_joint_batch_matches_jax(models, fused):
    le, ls, an, hist = port_batch(models, fused)
    rle, rls, ran, rhist = reference(models, fused)
    assert len(le) == len(ls) == len(an) == len(N_OBS)
    for s, n in enumerate(N_OBS):
        assert le[s].shape == rle[s].shape == (n, models["te"].lat_dim)
        np.testing.assert_allclose(ls[s], rls[s], **TOL)
        np.testing.assert_allclose(le[s], rle[s], **TOL)
        np.testing.assert_allclose(an[s], ran[s], **TOL)
    assert hist["loss"].shape == (FIT["n_steps"], len(N_OBS))
    np.testing.assert_allclose(hist["loss"], rhist["loss"], **TOL_LOSS)
    np.testing.assert_array_equal(hist["broyden_iters"], rhist["broyden_iters"])
    assert len(set(hist["broyden_iters"][0])) > 1  # the subjects' counts differ
    assert np.isfinite(hist["steady_subject_steps_s"])


def test_subject_padding_changes_nothing(models):
    le, ls, an, hist = port_batch(models, "on")
    ple, pls, pan, phist = port_batch(models, "on", pad_subjects_to=5, pad_obs_to=9,
                                      pad_points_to=600)
    assert len(ple) == len(N_OBS)
    for s in range(len(N_OBS)):
        np.testing.assert_allclose(pls[s], ls[s], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ple[s], le[s], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(pan[s], an[s], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(phist["loss"], hist["loss"], rtol=1e-6, atol=1e-8)
    np.testing.assert_array_equal(phist["broyden_iters"], hist["broyden_iters"])


@pytest.mark.parametrize("fused", ["on", "off"])
def test_batch_matches_per_subject_fit_joint(models, fused):
    m = models
    le, ls, an, hist = port_batch(m, fused)
    sel, idx = m["draws"]
    for s, obs in enumerate(m["subjects"]):
        sle, sls, san, shist = fit_joint(
            m["ts"], m["tps"], m["te"], m["tpe"], obs,
            cfg=FittingConfig(fused_search=fused, fused_shape_fields=fused, **FIT),
            verbose=False, device="cpu", sample_draws=(sel[:, s], idx[:, s]))
        np.testing.assert_allclose(ls[s], sls, **TOL)
        np.testing.assert_allclose(le[s], sle, **TOL)
        np.testing.assert_allclose(hist["loss"][:, s], shist["loss"], **TOL_LOSS)
        np.testing.assert_array_equal(hist["broyden_iters"][:, s], shist["broyden_iters"])


def test_batch_starting_codes_match_fit_joint(models):
    """Starting codes per subject: the batched fit equals ``fit_joint``
    started from the same codes on the same draws."""
    m = models
    rng = np.random.default_rng(4)
    init_s = (rng.normal(size=(len(N_OBS), m["ts"].lat_dim)) * 0.05).astype(np.float32)
    init_e = [(rng.normal(size=(n, m["te"].lat_dim)) * 0.01).astype(np.float32) for n in N_OBS]
    le, ls, _, hist = port_batch(m, "on", lat_shape_init=init_s, lat_expr_init=init_e)
    sel, idx = m["draws"]
    for s, obs in enumerate(m["subjects"]):
        sle, sls, _, shist = fit_joint(
            m["ts"], m["tps"], m["te"], m["tpe"], obs,
            cfg=FittingConfig(fused_search="on", fused_shape_fields="on", **FIT),
            verbose=False, device="cpu", sample_draws=(sel[:, s], idx[:, s]),
            lat_shape_init=init_s[s], lat_expr_init=init_e[s])
        np.testing.assert_allclose(ls[s], sls, **TOL)
        np.testing.assert_allclose(le[s], sle, **TOL)
        np.testing.assert_allclose(hist["loss"][:, s], shist["loss"], **TOL_LOSS)
    assert np.abs(ls[0] - init_s[0]).max() > 0


@pytest.mark.parametrize("fused", ["on", "off"])
def test_fit_identity_matches_jax(models, fused):
    m = models
    obs = m["subjects"][2]
    steps, nb, npp = 6, 3, 50
    kw = dict(n_steps=steps, n_obs_per_batch=nb, n_points_per_obs=npp, log_every=10**9,
              fused_shape_fields=fused)
    # a code off zero: at zero the symmetric pairs of local codes coincide,
    # and symm_dist's gradient there is the sign of rounding noise
    init = np.random.default_rng(2).normal(size=(1, m["ts"].lat_dim)).astype(np.float32)
    init *= 0.01
    rls, ranchors, rhist = jfit_identity(m["js"], m["jps"], obs, cfg=JFittingConfig(**kw),
                                         lat_shape_init=init, verbose=False)
    ls, anchors, hist = fit_identity(m["ts"], m["tps"], obs, cfg=FittingConfig(**kw),
                                     lat_shape_init=init, verbose=False, device="cpu",
                                     sample_draws=jax_draws(0, obs, steps, nb, npp))
    np.testing.assert_allclose(ls, rls, **TOL)
    np.testing.assert_allclose(anchors, ranchors, **TOL)
    for k in ("loss", "surface", "reg_global", "reg_loc", "reg_unobserved", "symm_dist"):
        np.testing.assert_allclose(hist[k], rhist[k], **TOL_LOSS)
    assert np.isfinite(hist["steady_it_s"])
