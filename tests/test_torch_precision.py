"""``matmul_precision`` in the port (``nphm_tpu_torch/ops/precision.py``) vs
the JAX package, on the CPU.

JAX on the CPU computes every product in fp32 whatever
``jax.default_matmul_precision`` says (one jitted product gives the same
error against float64 under "default", "bfloat16", "tensorfloat32" and
"highest"), while the port rounds each product's operands as the precision
says on every device.  So the port at a precision is held against JAX run
under the same name, within that precision's tolerance, relative to each
output's largest magnitude (``TOL``): F32 1e-4 (the fp32 tolerance of
``test_torch_fit_fields.py``), TF32 5e-3, BF16 3e-2.

- Names: JAX's six are accepted and map to F32, TF32, BF16; any other
  name, a dot-algorithm preset included, raises ValueError; the context is
  restored on exit and on an exception.
- Every name runs both trainers (one step each) and the three fits (one
  step each) at tiny widths, and leaves torch's global matmul settings
  (``torch.backends`` TF32 and reduced-precision flags,
  ``torch.get_float32_matmul_precision()``) as they were.
- "default", "highest" and "float32" give results ``torch.equal`` to the
  same calls with the context replaced by a no-op: one ``IdentityTrainer``
  step and a 3-step ``fit_joint``.
- K3-K6's plain versions vs the JAX kernels in interpret mode at each
  precision: ``member_fields_plain`` and its VJP for random cotangents
  against ``_member_fields``, ``member_f_plain`` and its VJP (layer-0 and
  skip-layer bias cotangents, d(coords)) against ``_member_f``, and
  ``apply_nphm_fit``'s sdf and point gradient against
  ``apply_nphm_fit_pallas``, within ``TOL``; at TF32 and BF16
  ``member_f_plain`` differs from its F32 result by more than 1e-6 (the
  rounding is emulated) and by less than ``TOL``.  Measured (hidden 40):
  at most 1.5e-3 (TF32) and 8.3e-3 (BF16).  A latent gradient through
  ``apply_nphm_fit`` is left out: it reaches the latent through the
  anchors, whose gradient sums the points' spatial gradients around the
  head, which nearly cancel; at TF32 the rounding moved it by 24% of its
  largest entry against JAX's fp32 (the trainers' latent gradients below
  do not cancel so).
- One stage-1 step (NPHM, plain fields path), one stage-2 step (compress
  mode) and a 3-step ``fit_joint`` (K2's and K3/K4's plain versions, as
  the JAX fit runs its kernels) at TF32 and BF16 against JAX under the
  same name: loss terms, updated params and latents, and the steps' first
  Adam moments (which are the clipped gradients times 0.1) within
  ``TOL``; measured at most 6.5e-4 (TF32) and 2.5e-2 (BF16), both the
  stage-1 latents' moment.  The fit's loss history and anchors within ``TOL``,
  its executed Broyden iterations and valid counts equal.  Its codes are
  held in L2 norm within ``2 * TOL``: Adam scales each entry's step by
  that entry's own gradient history, so an entry whose moments nearly
  cancel turns a gradient error of a few 1e-3 into a step error of
  several percent; measured 1.9e-3 (TF32) and 3.4e-2 (BF16) in L2, 4.4e-3
  and 9.5e-2 in max norm.
"""

import contextlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from nphm_tpu.data.synthetic import (
    SyntheticDeformationDataset as JSyntheticDeformationDataset,
    SyntheticIdentityDataset as JSyntheticIdentityDataset,
)
from nphm_tpu.fitting import FittingConfig as JFittingConfig, fit_joint as jfit_joint
from nphm_tpu.models import NPHMConfig as JNPHMConfig, make_nphm_decoder as jmake_nphm
from nphm_tpu.ops import pallas_train as jpt
from nphm_tpu.training.trainer import IdentityTrainer as JIdentityTrainer
from nphm_tpu.training.trainer_corresp import DeformationTrainer as JDeformationTrainer
from nphm_tpu.utils.logging_utils import MetricsLogger as JMetricsLogger
from nphm_tpu_torch.data.synthetic import (
    SyntheticDeformationDataset,
    SyntheticIdentityDataset,
)
from nphm_tpu_torch.fitting import FittingConfig, fit_identity, fit_joint, fit_joint_batch
from nphm_tpu_torch.models import NPHMConfig, make_nphm_decoder
from nphm_tpu_torch.ops import fit_fields as ff
from nphm_tpu_torch.ops import precision
from nphm_tpu_torch.ops import train_fields as tf
from nphm_tpu_torch.ops.precision import Precision
from nphm_tpu_torch.training.trainer import IdentityTrainer
from nphm_tpu_torch.training.trainer_corresp import DeformationTrainer
from nphm_tpu_torch.utils.logging_utils import MetricsLogger
from nphm_tpu_torch.utils.params import from_numpy_pytree, trainer_state_from_jax
from test_torch_slice import SHAPE_KW, bridge, nonrigid_observations
from test_torch_slice import jax_draws as fit_draws
from test_torch_train import CFG, DATA, train_cfg
from test_torch_train_corresp import TRAIN, nphm_models, shape_state
from test_torch_train_corresp import jax_draws as corresp_draws
from test_torch_train_fields import jax_grad_as_port, member_coords

TOL = {Precision.F32: 1e-4, Precision.TF32: 5e-3, Precision.BF16: 3e-2}
NAMES = ("default", "highest", "float32", "high", "tensorfloat32", "bfloat16")
FIT = dict(n_steps=3, n_obs_per_batch=2, n_points_per_obs=64, log_every=10**9)


def rel(got, ref):
    """max |got - ref| over max |ref| (pytrees of arrays or tensors)."""
    def flat(t):
        return np.concatenate([
            np.ravel(x.detach().double().numpy() if torch.is_tensor(x)
                     else np.asarray(x, np.float64)) for x in jax.tree_util.tree_leaves(t)])

    a, b = flat(got), flat(ref)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def global_matmul_settings():
    """torch's process-wide matmul settings that a precision must not touch."""
    b = torch.backends
    return (torch.get_float32_matmul_precision(), b.cuda.matmul.allow_tf32,
            b.cudnn.allow_tf32, b.cuda.matmul.allow_bf16_reduced_precision_reduction,
            b.cuda.matmul.allow_fp16_reduced_precision_reduction)


@pytest.fixture(scope="module")
def nphm():
    """test_torch_train.py's small NPHM decoder on both sides."""
    rng = np.random.default_rng(0)
    anchors = (rng.normal(size=(CFG["n_loc"], 3)) * 0.3).astype(np.float32)
    jd = jmake_nphm(JNPHMConfig(**CFG), anchors)
    jp = jd.init(jax.random.PRNGKey(0))
    return jd, jp, make_nphm_decoder(NPHMConfig(**CFG), anchors), bridge(jp)


def identity_trainer(td, params, tmp_path, name="t", **training):
    return IdentityTrainer(
        td, params, train_cfg(**training),
        SyntheticIdentityDataset(n_subjects=2, batch_size=2, seed=0, **DATA),
        SyntheticIdentityDataset(n_subjects=2, batch_size=2, seed=5, **DATA), name,
        exp_dir=str(tmp_path), logger=MetricsLogger(quiet=True), recon_resolution=16,
        device="cpu")


def one_step(tr, val=False):
    batch = tr._batch(next(iter((tr.val_dataset if val else tr.train_dataset)
                                .batch_iter(seed=0))))
    if val:
        return tr._val_step(batch, tr.lr_lat_at(0))
    return tr._train_step(batch, tr.lr_at(0), tr.lr_lat_at(0))


def stage2_datasets(package_synthetic):
    identity, deformation = package_synthetic
    kw = dict(n_expressions=2, n_points=64, batch_size=2, seed=4, warp_scale=0.08)
    return (deformation(identity(n_subjects=2, batch_size=2, n_anchors=6, seed=1), **kw),
            deformation(identity(n_subjects=1, batch_size=1, n_anchors=6, seed=2), **kw))


@pytest.fixture(scope="module")
def fit_setup():
    """test_torch_slice.py's NPHM and compress-mode models and nonrigid
    observations, the JAX fit's draws for FIT."""
    m = nphm_models()
    rng = np.random.default_rng(3)
    rng.normal(size=(SHAPE_KW["n_loc"], 3))  # nphm_models' anchors
    obs = nonrigid_observations(rng)
    draws = fit_draws(0, obs, FIT["n_steps"], FIT["n_obs_per_batch"], FIT["n_points_per_obs"])
    return m, obs, draws


def step_errors(stage, tr, jtr, terms, jterms):
    """Relative errors of one train step against the JAX trainer's: loss
    terms, params, latents and both first Adam moments."""
    assert sorted(terms) == sorted(jterms)
    ref, got = trainer_state_from_jax(np_tree(jtr._state_tree())), tr.state_dict()
    errs = {f"{stage} {k}": abs(float(terms[k]) - float(jterms[k]))
            / max(abs(float(jterms[k])), 1e-30) for k in terms}
    errs.update({f"{stage} {k}": rel(got[k], ref[k]) for k in ("params", "latents")})
    errs[f"{stage} params mu"] = rel(got["opt_state"]["mu"], ref["opt_state"]["mu"])
    errs[f"{stage} latents mu"] = rel(got["lat_state"]["exp_avg"], ref["lat_state"]["exp_avg"])
    return errs


def test_names_and_context():
    want = {"default": Precision.F32, "highest": Precision.F32, "float32": Precision.F32,
            "high": Precision.TF32, "tensorfloat32": Precision.TF32,
            "bfloat16": Precision.BF16}
    assert precision.NAMES == want
    assert precision.current() == Precision.F32
    for name, p in want.items():
        with precision.matmul_precision(name):
            assert precision.current() == p
            with precision.matmul_precision("default"):
                assert precision.current() == Precision.F32
            assert precision.current() == p
        assert precision.current() == Precision.F32
    for bad in ("BF16_BF16_F32", "fastest", "DEFAULT", None, 1):
        with pytest.raises(ValueError, match="default, highest, float32, high, "
                                             "tensorfloat32, bfloat16"):
            precision.resolve(bad)
        with pytest.raises(ValueError):
            FittingConfig(matmul_precision=bad)
    with pytest.raises(RuntimeError, match="inside"):
        with precision.matmul_precision("bfloat16"):
            assert precision.current() == Precision.BF16
            raise RuntimeError("inside")
    assert precision.current() == Precision.F32
    # the bit rounding is torch's own bf16 cast (nearest even) and TF32's
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0)) * 30
    assert torch.equal(precision.bf16_round(x), x.to(torch.bfloat16).float())
    assert torch.equal(precision.round_operand(x, Precision.F32), x)


def test_every_name_runs_trainers_and_fits(nphm, fit_setup, tmp_path):
    _jd, _jp, td, tp = nphm
    m, obs, _draws = fit_setup
    ts, te = m["ts"], m["te"]
    tps, tpe = bridge(m["jps"]), bridge(m["jpe"])
    train, val = stage2_datasets((SyntheticIdentityDataset, SyntheticDeformationDataset))
    before = global_matmul_settings()
    losses = {}
    for name in NAMES:
        tr = identity_trainer(td, tp, tmp_path, f"id_{name}", matmul_precision=name)
        terms = [one_step(tr), one_step(tr, val=True)]
        dtr = DeformationTrainer(te, tpe, ts, {"training": dict(TRAIN, matmul_precision=name)},
                                 train, val, f"def_{name}", exp_dir=str(tmp_path),
                                 logger=MetricsLogger(quiet=True),
                                 shape_state=shape_state(m, 2, 1), device="cpu")
        terms += [one_step(dtr), one_step(dtr, val=True)]
        cfg = FittingConfig(matmul_precision=name, **dict(FIT, n_steps=1))
        hists = [fit_joint(ts, tps, te, tpe, obs, cfg=cfg, verbose=False, device="cpu")[3],
                 fit_joint_batch(ts, tps, te, tpe, [obs, obs[:2]], cfg=cfg, verbose=False,
                                 device="cpu")[3],
                 fit_identity(ts, tps, obs, cfg=cfg, verbose=False, device="cpu")[2]]
        assert all(np.isfinite(float(v)) for t in terms for v in t.values()), name
        assert all(np.isfinite(h["loss"]).all() for h in hists), name
        assert global_matmul_settings() == before, name
        assert precision.current() == Precision.F32
        losses[name] = float(terms[0]["loss"])
    # the names of one precision compute the same; the precisions differ
    assert losses["default"] == losses["highest"] == losses["float32"]
    assert losses["high"] == losses["tensorfloat32"]
    assert len({losses["default"], losses["high"], losses["bfloat16"]}) == 3
    with pytest.raises(ValueError, match="matmul_precision"):
        identity_trainer(td, tp, tmp_path, "bad", matmul_precision="BF16_BF16_F32")


def test_default_is_bit_equal_to_no_context(nphm, fit_setup, tmp_path, monkeypatch):
    _jd, _jp, td, tp = nphm
    m, obs, draws = fit_setup

    def run(name):
        tr = identity_trainer(td, tp, tmp_path, f"t_{name}", matmul_precision=name)
        one_step(tr)
        cfg = FittingConfig(fused_search="on", fused_shape_fields="on", matmul_precision=name,
                            **FIT)
        fit = fit_joint(m["ts"], bridge(m["jps"]), m["te"], bridge(m["jpe"]), obs, cfg=cfg,
                        verbose=False, sample_draws=draws, device="cpu")
        return [tr.params, tr.latents, tr.opt_state["mu"], tr.lat_state.exp_avg,
                [torch.tensor(a) for a in fit[:3]], torch.tensor(fit[3]["loss"])]

    got = {name: run(name) for name in ("default", "highest", "float32")}
    with monkeypatch.context() as mp:
        mp.setattr(precision, "matmul_precision", lambda name: contextlib.nullcontext())
        ref = run("default")
    for name, out in got.items():
        for a, b in zip(jax.tree_util.tree_leaves(out), jax.tree_util.tree_leaves(ref)):
            assert torch.equal(a, b), name


@pytest.fixture(scope="module")
def twin_reference(nphm):
    """Inputs and the JAX kernels' outputs (interpret mode): _member_fields
    and its VJP, _member_f and its VJP, apply_nphm_fit_pallas's sdf and
    point gradient.  JAX's CPU results are the same under every precision
    name, so they are computed once."""
    jd, jp, td, tp = nphm
    B, N, tile = 2, 250, 256
    rng = np.random.default_rng(B * 1000 + N)
    xyz = (rng.normal(size=(B, N, 3)) * 0.4).astype(np.float32)
    lat = (rng.normal(size=(B, td.cfg.lat_dim)) * 0.1).astype(np.float32)
    coords = member_coords(td, tp, xyz, lat, tile, sort=False)
    A, _, M = coords.shape
    u = rng.normal(size=(A, M)).astype(np.float32)
    V = rng.normal(size=(A, 3, M)).astype(np.float32)
    dF = rng.normal(size=(A, M)).astype(np.float32)

    jops, _ = jpt.prepare_train_operands(jp, jd.cfg, jnp.asarray(lat))
    spec = jpt._Spec(cfg=jd.cfg, tile=tile, tpr=M // B // tile, cull_eps=0.0, interpret=True)
    (jF, jG), vjp = jax.vjp(lambda o, c: jpt._member_fields(spec, o, c), jops,
                            jnp.asarray(coords))
    jd_ops, jd_coords = vjp((jnp.asarray(u), jnp.asarray(V)))
    jF3, vjp3 = jax.vjp(lambda o, c: jpt._member_f(spec, o, c), jops, jnp.asarray(coords))
    jd3_ops, jd3_coords = vjp3(jnp.asarray(dF))

    def jsdf(x):
        return jpt.apply_nphm_fit_pallas(jp, jd.cfg, x, jnp.asarray(lat), tile=tile,
                                         cull_eps=1e-10, sort=True, interpret=True)[0]

    j_sdf, j_sdf_vjp = jax.vjp(jsdf, jnp.asarray(xyz))
    (j_sdf_dx,) = j_sdf_vjp(jnp.ones_like(j_sdf))
    layout = jpt._op_layout(jd.cfg)
    want = [jax_grad_as_port(role, g) for (_, role), g in zip(layout, jd_ops)
            if role not in ("whT", "whST")] + [np.asarray(jd_coords)]
    want3 = [jax_grad_as_port(role, g) for (_, role), g in zip(layout, jd3_ops)
             if role in ("bias0", "biasS")] + [np.asarray(jd3_coords)]
    inputs = dict(B=B, tile=tile, xyz=xyz, lat=lat, coords=coords, u=u, V=V, dF=dF)
    return inputs, [jF, jG, *want, jF3, *want3, j_sdf, j_sdf_dx]


@pytest.mark.parametrize("p", list(Precision), ids=lambda p: p.name)
def test_kernel_twins_match_jax(nphm, twin_reference, p):
    _jd, _jp, td, tp = nphm
    cfg = td.cfg
    inp, ref = twin_reference
    B, tile = inp["B"], inp["tile"]
    with precision.matmul_precision(p):
        layers, _ = ff.prepare_train_operands(tp, cfg, torch.tensor(inp["lat"]))
        flat = [t.detach().requires_grad_(True) for t in tf._flat(cfg, layers)]
        c = torch.tensor(inp["coords"], requires_grad=True)
        active = ff.active_mask(cfg, c, tile, 0.0)
        fl = tf._unflat(cfg, flat)
        F, G = tf.member_fields_plain(cfg, fl, c, active, tile, B)
        phi = (F * torch.tensor(inp["u"])).sum() + (G * torch.tensor(inp["V"])).sum()
        grads = torch.autograd.grad(phi, flat + [c])
        _, skip = cfg.layer_shapes
        F3 = ff.member_f_plain(cfg, fl, c, active, tile, B)
        grads3 = torch.autograd.grad(F3, (fl[0]["b"], fl[skip]["b"], c),
                                     torch.tensor(inp["dF"]))
        x = torch.tensor(inp["xyz"], requires_grad=True)
        sdf, _ = ff.apply_nphm_fit(tp, cfg, x, torch.tensor(inp["lat"]), tile=tile,
                                   cull_eps=1e-10, sort=True)
        (sdf_dx,) = torch.autograd.grad(sdf.sum(), x)
    got = [F, G, *grads, F3, *grads3, sdf, sdf_dx]
    assert len(got) == len(ref)
    errs = [rel(a.detach(), b) for a, b in zip(got, ref)]
    assert max(errs) <= TOL[p], " ".join("%.2e" % e for e in errs)

    # the plain version rounds as the kernel: at TF32 and BF16 it moves off
    # its F32 result, by less than the tolerance
    F32 = ff.member_f_plain(cfg, layers, c, active, tile, B).detach()
    with precision.matmul_precision(p):
        Fp = ff.member_f_plain(cfg, layers, c, active, tile, B).detach()
    diff = float((Fp - F32).abs().max())
    if p == Precision.F32:
        assert diff == 0.0
    else:
        assert 1e-6 < diff and rel(Fp, F32) <= TOL[p]


@pytest.mark.parametrize("name", ["high", "bfloat16"])
def test_steps_and_fit_match_jax(nphm, fit_setup, name, tmp_path):
    p = precision.resolve(name)
    tol = TOL[p]
    jd, jp, td, _tp = nphm

    # stage 1: one train step from the JAX trainer's own initial state
    cfg = train_cfg(matmul_precision=name)
    jtr = JIdentityTrainer(
        jd, jax.tree_util.tree_map(jnp.array, jp), cfg,
        JSyntheticIdentityDataset(n_subjects=2, batch_size=2, seed=0, **DATA),
        JSyntheticIdentityDataset(n_subjects=2, batch_size=2, seed=5, **DATA), "j",
        exp_dir=str(tmp_path), logger=JMetricsLogger(quiet=True), recon_resolution=16)
    start = trainer_state_from_jax(np_tree(jtr._state_tree()))
    tr = identity_trainer(td, from_numpy_pytree(start["params"], "cpu"), tmp_path,
                          matmul_precision=name)
    tr.load_state_dict(start)
    batch = next(iter(tr.train_dataset.batch_iter(seed=0)))
    lr, lr_lat = tr.lr_at(0), tr.lr_lat_at(0)
    jtr.params, jtr.opt_state, jtr.latents, jtr.lat_state, jterms = jtr._run_train_step(
        {k: jnp.asarray(v) for k, v in batch.items()}, jnp.float32(lr), jnp.float32(lr_lat))
    terms = tr._train_step(tr._batch(batch), lr, lr_lat)
    errs = step_errors("stage 1", tr, jtr, terms, jterms)

    # stage 2: one compress-mode train step, the JAX key's draws
    m, obs, draws = fit_setup
    state = shape_state(m, 2, 1)
    dcfg = {"training": dict(TRAIN, matmul_precision=name)}
    jtr2 = JDeformationTrainer(
        m["je"], jax.tree_util.tree_map(jnp.array, m["jpe"]), m["js"], dcfg,
        *stage2_datasets((JSyntheticIdentityDataset, JSyntheticDeformationDataset)), "j2",
        exp_dir=str(tmp_path), logger=JMetricsLogger(quiet=True), shape_state=state,
        recon_resolution=16)
    tr2 = DeformationTrainer(
        m["te"], bridge(m["jpe"]), m["ts"], dcfg,
        *stage2_datasets((SyntheticIdentityDataset, SyntheticDeformationDataset)), "t2",
        exp_dir=str(tmp_path), logger=MetricsLogger(quiet=True), shape_state=state,
        recon_resolution=16, device="cpu")
    tr2.latents = torch.tensor(np.asarray(jtr2.latents))
    batch = next(iter(tr2.train_dataset.batch_iter(seed=0)))
    key = jax.random.PRNGKey(100)
    lr, lr_lat = tr2.lr_at(0), tr2.lr_lat_at(0)
    jtr2.params, jtr2.opt_state, jtr2.latents, jtr2.lat_state, jterms = jtr2._train_step(
        jtr2.params, jtr2.opt_state, jtr2.latents, jtr2.lat_state,
        {k: jnp.asarray(v) for k, v in batch.items()}, jnp.float32(lr), jnp.float32(lr_lat),
        key)
    tr2.draws = corresp_draws(key, 2, 64, 8)
    terms = tr2._train_step(tr2._batch(batch), lr, lr_lat)
    errs.update(step_errors("stage 2", tr2, jtr2, terms, jterms))

    # a 3-step fit, K2's and K3/K4's plain versions against the JAX kernels
    rle, rls, ranchors, rhist = jfit_joint(
        m["js"], m["jps"], m["je"], m["jpe"], obs,
        cfg=JFittingConfig(fused_search="on", fused_shape_fields="on", matmul_precision=name,
                           **FIT), verbose=False)
    le, ls, anchors, hist = fit_joint(
        m["ts"], bridge(m["jps"]), m["te"], bridge(m["jpe"]), obs,
        cfg=FittingConfig(fused_search="on", fused_shape_fields="on", matmul_precision=name,
                          **FIT), verbose=False, sample_draws=draws, device="cpu")
    errs["fit loss history"] = rel(hist["loss"], rhist["loss"])
    errs["fit anchors"] = rel(anchors, ranchors)
    np.testing.assert_array_equal(hist["n_valid"], rhist["n_valid"])
    np.testing.assert_array_equal(hist["broyden_iters"], rhist["broyden_iters"])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol, (worst, errs)
    for a, b in ((le, rle), (ls, rls)):
        l2 = np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b)
        assert l2 <= 2 * tol, l2
