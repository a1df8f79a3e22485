"""The port's fit-and-extract slice vs the JAX package, end to end on the CPU.

- ``fit_joint`` for 5 steps on a compress-mode deformation decoder with
  nonrigid observations, handed the JAX fit's own (sel, idx) draws, vs the
  JAX ``fit_joint(fused_search="on", fused_shape_fields="on")`` (Pallas in
  interpret mode): latents and loss history at rtol 1e-3 / atol 5e-4 (five
  Adam steps amplify ulp-level ordering noise), n_valid equal.
- ``extract_mesh`` at res 32 and ``deform_mesh_batch`` from the same latents
  as JAX: vertex arrays at atol 1e-5 (nearest-neighbour matched for the
  extracted mesh, row by row for the posed meshes), face counts equal.
- The port's main paths (fit, batched fit, identity-only fit, extract,
  streamed, sparse and backward-warp extraction, deform, identity
  training, a deformation-training epoch, the fitting and both training
  CLI modules; the NPM family's fit, extract and deform) leave
  ``jax`` and ``nphm_tpu`` unimported (subprocess), and no source file of
  the port, nor ``chip_smoke.py``, imports them.
"""

import glob
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from nphm_tpu.data.dummy import _nonrigid_warp
from nphm_tpu.fitting import FittingConfig as JFittingConfig, fit_joint as jfit_joint
from nphm_tpu.models import (
    DeformationConfig as JDeformationConfig,
    NPHMConfig as JNPHMConfig,
    make_deformation_decoder as jmake_deformation,
    make_nphm_decoder as jmake_nphm,
)
from nphm_tpu.reconstruction.extract import (
    deform_mesh_batch as jdeform_mesh_batch,
    extract_mesh as jextract_mesh,
)
from nphm_tpu_torch.data.dummy import dummy_env
from nphm_tpu_torch.fitting.inference import FittingConfig, fit_joint
from nphm_tpu_torch.models import (
    DeformationConfig,
    NPHMConfig,
    make_deformation_decoder,
    make_nphm_decoder,
)
from nphm_tpu_torch.reconstruction.extract import (
    deform_mesh,
    deform_mesh_batch,
    extract_mesh,
)
from nphm_tpu_torch.utils.params import from_numpy_pytree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE_KW = dict(lat_dim_glob=8, lat_dim_loc=4, n_loc=6, n_symm_pairs=2,
                hidden_dim=16, n_layers=4, pos_mlp_dim=16)
DEF_KW = dict(mode="compress", lat_dim_glob_shape=8, lat_dim_loc_shape=4, n_loc=6,
              lat_dim_expr=8, lat_dim_id=8, hidden_dim=32, n_layers=4)
FIT = dict(n_steps=5, n_obs_per_batch=2, n_points_per_obs=64, log_every=10**9)
MINI, MAXI = (-0.55, -0.5, -0.95), (0.55, 0.75, 0.4)


def bridge(tree):
    return from_numpy_pytree(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def nonrigid_observations(rng, n_obs=3, n_pts=300):
    out = []
    for _ in range(n_obs):
        d = rng.normal(size=(n_pts, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        out.append(_nonrigid_warp(rng)((0.4 * d).astype(np.float32)))
    return out


def jax_draws(seed, obs, steps, nb, npp):
    """The JAX fit's per-step (sel, idx), recomputed as its scan draws them."""
    key = jax.random.PRNGKey(seed)
    lens = jnp.asarray([len(o) for o in obs])
    sels, idxs = [], []
    for j in range(steps):
        k1, k2 = jax.random.split(jax.random.fold_in(key, j))
        sel = jax.random.randint(k1, (nb,), 0, len(obs))
        idxs.append(np.asarray(jax.random.randint(k2, (nb, npp), 0, lens[sel][:, None])))
        sels.append(np.asarray(sel))
    return np.stack(sels), np.stack(idxs)


@pytest.fixture(scope="module")
def fitted():
    rng = np.random.default_rng(3)
    anchors = (rng.normal(size=(SHAPE_KW["n_loc"], 3)) * 0.25).astype(np.float32)
    js = jmake_nphm(JNPHMConfig(**SHAPE_KW), anchors)
    je = jmake_deformation(JDeformationConfig(**DEF_KW))
    jps, jpe = js.init(jax.random.PRNGKey(0)), je.init(jax.random.PRNGKey(1))
    ts = make_nphm_decoder(NPHMConfig(**SHAPE_KW), anchors)
    te = make_deformation_decoder(DeformationConfig(**DEF_KW))
    obs = nonrigid_observations(rng)
    ref = jfit_joint(js, jps, je, jpe, obs,
                     cfg=JFittingConfig(fused_search="on", fused_shape_fields="on", **FIT),
                     verbose=False)
    draws = jax_draws(0, obs, FIT["n_steps"], FIT["n_obs_per_batch"],
                      FIT["n_points_per_obs"])
    return dict(js=js, jps=jps, je=je, jpe=jpe, ts=ts, tps=bridge(jps), te=te,
                tpe=bridge(jpe), obs=obs, ref=ref, draws=draws)


@pytest.mark.parametrize("fused", ["on", "off"])
def test_fit_joint_matches_jax(fitted, fused):
    f = fitted
    le, ls, anchors, hist = fit_joint(
        f["ts"], f["tps"], f["te"], f["tpe"], f["obs"],
        cfg=FittingConfig(fused_search=fused, fused_shape_fields=fused, **FIT),
        verbose=False, sample_draws=f["draws"], device="cpu",
    )
    rle, rls, ranchors, rhist = f["ref"]
    np.testing.assert_allclose(ls, rls, rtol=1e-3, atol=5e-4)
    np.testing.assert_allclose(le, rle, rtol=1e-3, atol=5e-4)
    np.testing.assert_allclose(anchors, ranchors, rtol=1e-3, atol=5e-4)
    np.testing.assert_allclose(hist["loss"], rhist["loss"], rtol=1e-3, atol=1e-5)
    np.testing.assert_array_equal(hist["n_valid"], rhist["n_valid"])
    np.testing.assert_array_equal(hist["broyden_iters"], rhist["broyden_iters"])
    assert np.isfinite(hist["steady_it_s"])


def assert_same_vertices(a, b, atol=1e-5):
    """Same vertex count, and every vertex of each set within atol of one of
    the other (sorting alone would pair up near-ties in the wrong order)."""
    from scipy.spatial import cKDTree

    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    d_ab, _ = cKDTree(b).query(a)
    d_ba, _ = cKDTree(a).query(b)
    assert max(d_ab.max(), d_ba.max()) <= atol, (d_ab.max(), d_ba.max())


def test_extract_and_deform_match_jax(fitted):
    f = fitted
    rle, rls, ranchors, _ = f["ref"]
    ref = jextract_mesh(f["js"], f["jps"], rls, MINI, MAXI, 32, use_pallas=True)
    mesh = extract_mesh(f["ts"], f["tps"], rls, MINI, MAXI, 32, device="cpu")
    assert len(mesh.vertices) > 0
    assert mesh.faces.shape == ref.faces.shape
    assert_same_vertices(mesh.vertices, ref.vertices)

    posed_ref = jdeform_mesh_batch(ref, f["je"], f["jpe"], rle, anchors=ranchors,
                                   lat_shape=rls)
    posed = deform_mesh_batch(ref, f["te"], f["tpe"], rle, anchors=ranchors,
                              lat_shape=rls, device="cpu")
    assert len(posed) == len(posed_ref) == len(f["obs"])
    for a, b in zip(posed, posed_ref):
        np.testing.assert_allclose(a.vertices, b.vertices, atol=1e-5)
        np.testing.assert_array_equal(a.faces, b.faces)
    one = deform_mesh(ref, f["te"], f["tpe"], rle[1], anchors=ranchors, lat_shape=rls,
                      device="cpu")
    np.testing.assert_array_equal(one.vertices, posed[1].vertices)


def test_main_path_never_imports_jax(tmp_path):
    """Every module of the port imported (the fitting, training, evaluation,
    data-processing, dataset and protocol CLIs among them), and the fit, batched fit,
    identity-only fit, extract, streamed, sparse and backward-warp
    extraction, deform, identity- and deformation-training paths (NPHM), the
    fit, extract and deform paths (NPM), an evaluation (render sampling and
    metrics on a dummy scan) and the single-view observation CLI run on the
    CPU, with neither ``jax`` nor any module of ``nphm_tpu`` loaded."""
    code = textwrap.dedent(f"""
        import importlib
        import pkgutil
        import sys
        import numpy as np
        import torch
        sys.path.insert(0, {ROOT!r})
        import nphm_tpu_torch
        for mod in pkgutil.walk_packages(nphm_tpu_torch.__path__, "nphm_tpu_torch."):
            importlib.import_module(mod.name)
        for name in ("fitting_pointclouds", "train", "train_corresp", "eval", "gather",
                     "protocol_e2e", "synthetic_e2e", "train_soak", "make_dummy_data",
                     "example_usage",
                     "data_processing.sample_surface",
                     "data_processing.sample_deformation_field",
                     "data_processing.generate_single_view_observations"):
            assert "nphm_tpu_torch." + name in sys.modules
        from nphm_tpu_torch.data.synthetic import SyntheticIdentityDataset
        from nphm_tpu_torch.training.trainer import IdentityTrainer
        from nphm_tpu_torch.utils.logging_utils import MetricsLogger
        from nphm_tpu_torch.fitting.inference import FittingConfig, fit_joint
        from nphm_tpu_torch.models import (DeformationConfig, NPHMConfig,
            make_deformation_decoder, make_nphm_decoder)
        from nphm_tpu_torch.reconstruction.extract import deform_mesh_batch, extract_mesh
        rng = np.random.default_rng(0)
        s = make_nphm_decoder(NPHMConfig(**{SHAPE_KW!r}),
                              rng.normal(size=(6, 3)).astype(np.float32) * 0.25)
        e = make_deformation_decoder(DeformationConfig(**{DEF_KW!r}))
        gen = torch.Generator().manual_seed(0)
        ps, pe = s.init(gen, "cpu"), e.init(gen, "cpu")
        obs = [rng.normal(size=(200, 3)).astype(np.float32) * 0.4 for _ in range(2)]
        le, ls, anchors, hist = fit_joint(s, ps, e, pe, obs, verbose=False, device="cpu",
            cfg=FittingConfig(n_steps=2, n_obs_per_batch=2, n_points_per_obs=32,
                              fused_search="on", fused_shape_fields="on"))
        from nphm_tpu_torch.fitting import fit_identity, fit_joint_batch
        les, lss, _, bhist = fit_joint_batch(s, ps, e, pe, [obs, obs[:1]], verbose=False,
            device="cpu", cfg=FittingConfig(n_steps=2, n_obs_per_batch=2,
                                            n_points_per_obs=32, fused_search="on",
                                            fused_shape_fields="on"))
        assert bhist["loss"].shape == (2, 2) and np.isfinite(bhist["loss"]).all()
        ils, _, ihist = fit_identity(s, ps, obs, verbose=False, device="cpu",
            cfg=FittingConfig(n_steps=2, n_obs_per_batch=2, n_points_per_obs=32,
                              fused_shape_fields="on"))
        assert np.isfinite(ihist["loss"]).all()
        mesh = extract_mesh(s, ps, ls, resolution=16, device="cpu")
        posed = deform_mesh_batch(mesh, e, pe, le, anchors=anchors, lat_shape=ls,
                                  device="cpu")
        posed[0].export({str(tmp_path / "posed.ply")!r})
        assert np.isfinite(hist["loss"]).all()
        from nphm_tpu_torch.reconstruction import extract_mesh_sparse, extract_mesh_streamed
        from nphm_tpu_torch.reconstruction.extract import backward_grid_logits
        streamed = extract_mesh_streamed(s, ps, ls, resolution=32, n_slabs=2, device="cpu")
        sparse = extract_mesh_sparse(s, ps, ls, resolution=32, lip="auto", device="cpu")
        assert len(streamed.vertices) == len(sparse.vertices) > 0
        warped = backward_grid_logits(s, e, ps, pe, ls, np.concatenate([ls[0], le[0]]),
                                      {MINI!r}, {MAXI!r}, 16,
                                      anchors=anchors, device="cpu")
        assert warped.shape == (16**3,) and np.isfinite(warped).all()
        from nphm_tpu_torch.training.trainer_corresp import DeformationTrainer

        class Scans:  # two scans of one subject
            subject_steps, steps, subject_index = [1, 1], [0, 1], [0, 0]

            def __len__(self):
                return 2

            def batch_iter(self, seed=0):
                yield {{"points_neutral": rng.normal(size=(2, 30, 3)).astype(np.float32) * 0.4,
                        "points_posed": rng.normal(size=(2, 30, 3)).astype(np.float32) * 0.4,
                        "idx": np.array([[0], [1]], np.int32),
                        "subj_ind": np.array([[0], [0]], np.int32)}}

        dcfg = dict(training=dict(ckpt_interval=1, grad_clip=0.025, grad_clip_lat=0.025,
                                  lr=1e-4, lr_lat=5e-4, weight_decay=5e-4,
                                  lambdas=dict(corresp=100.0, lat_reg=5e-5,
                                               loss_reg_zero=5e-5)))
        shape_state = dict(params=ps, latents=torch.tensor(ls), latents_val=torch.tensor(ls))
        dtr = DeformationTrainer(e, pe, s, dcfg, Scans(), Scans(), "dexp",
                                 exp_dir={str(tmp_path)!r}, logger=MetricsLogger(quiet=True),
                                 shape_state=shape_state, recon_resolution=16, device="cpu")
        dtr.train_model(1)
        ds = SyntheticIdentityDataset(n_subjects=2, batch_size=2, n_face=40, n_non_face=20,
                                      n_anchors=6)
        lam = dict(lat_reg=0.01, surf_sdf=2.0, normals=0.3, space_sdf=0.01, grad=0.1,
                   anchors=7.5, symm_dist=0.01, middle_dist=0.0)
        cfg = dict(training=dict(ckpt_interval=1, grad_clip=0.1, grad_clip_lat=0.1, lr=5e-4,
                                 lr_lat=1e-3, weight_decay=0.01, lambdas=lam,
                                 fused_train_kernel=True))
        tr = IdentityTrainer(s, ps, cfg, ds, ds, "exp", exp_dir={str(tmp_path)!r},
                             logger=MetricsLogger(quiet=True), recon_resolution=16,
                             device="cpu")
        tr.train_model(1)
        from nphm_tpu_torch.models import DeepSDFConfig, make_npm_decoder
        from nphm_tpu_torch.config import build_expression_decoder
        s = make_npm_decoder(DeepSDFConfig(lat_dim=8, hidden_dim=16, n_layers=4))
        e = build_expression_decoder({{"id_decoder": {{"decoder_lat_dim": 8}},
                                      "ex_decoder": {{"decoder_lat_dim": 4,
                                                     "decoder_hidden_dim": 16,
                                                     "decoder_nlayers": 4}}}}, "npm")
        ps, pe = s.init(gen, "cpu"), e.init(gen, "cpu")
        le, ls, anchors, hist = fit_joint(s, ps, e, pe, obs, verbose=False, device="cpu",
            cfg=FittingConfig(n_steps=2, n_obs_per_batch=2, n_points_per_obs=32,
                              fused_search="on"))
        assert anchors is None and np.isfinite(hist["loss"]).all()
        mesh = extract_mesh(s, ps, ls, (-1.1,) * 3, (1.1,) * 3, resolution=16,
                            device="cpu")
        posed = deform_mesh_batch(mesh, e, pe, le, lat_shape=ls, device="cpu")
        assert len(posed) == len(le)
        from nphm_tpu_torch.data.dummy import generate_dummy_data
        from nphm_tpu_torch.data_processing import generate_single_view_observations
        from nphm_tpu_torch.evaluation import eval_pointcloud, gen_render_samples
        from nphm_tpu_torch.utils.mesh_io import load_mesh
        generate_dummy_data({str(tmp_path / "dummy")!r}, subjects=(341,), n_expressions=1,
                            n_supervision=2000)
        generate_single_view_observations.main(["--subjects", "341", "--n_points", "300"])
        assert np.load({str(tmp_path / "dummy" / "single_view" / "341" / "0" / "obs.npy")!r}
                       ).shape == (300, 3)
        scan = load_mesh({str(tmp_path / "dummy" / "dataset" / "341" / "000" / "scan.ply")!r})
        pts, nrm = gen_render_samples(scan, 2)
        scores = eval_pointcloud(pts[::7], pts[3::11], nrm[::7], nrm[3::11], subject=341,
                                 expression=0)
        assert 0 < scores["chamfer_l1"] < 1 and scores["normals consistency"] > 0.9
        loaded = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith("jax.")
                        or m == "nphm_tpu" or m.startswith("nphm_tpu."))
        print("FOREIGN_LOADED", loaded)
    """)
    env = {**os.environ, **dummy_env(str(tmp_path / "dummy"))}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(tmp_path), env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "FOREIGN_LOADED []" in out.stdout, out.stdout
    assert (tmp_path / "posed.ply").exists()
    assert (tmp_path / "exp" / "checkpoints" / "checkpoint_epoch_0.pkl").exists()
    assert (tmp_path / "dexp" / "checkpoints" / "checkpoint_epoch_0.pkl").exists()


def test_port_source_never_imports_nphm_tpu():
    """No import of the JAX package in the port's source or the smoke script,
    and none of PIL in the port (the card's machine has no Pillow)."""
    pattern = re.compile(r"^\s*(import\s+nphm_tpu(\.|\s|$|,)|from\s+nphm_tpu(\.|\s))",
                         re.MULTILINE)
    files = sorted(glob.glob(os.path.join(ROOT, "nphm_tpu_torch", "**", "*.py"),
                             recursive=True))
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 20
    for name in ("evaluation/render.py", "evaluation/nn.py", "evaluation/metrics.py", "eval.py",
                 "gather.py", "protocol_e2e.py", "synthetic_e2e.py", "train_soak.py",
                 "data/synthetic.py", "data_processing/sample_surface.py",
                 "data_processing/sample_deformation_field.py",
                 "data_processing/generate_single_view_observations.py"):
        assert os.path.join(ROOT, "nphm_tpu_torch", name) in files, name
    pil = re.compile(r"^\s*(import\s+PIL\b|from\s+PIL\b)", re.MULTILINE)
    offenders = []
    for path in files:
        with open(path) as f:
            text = f.read()
        offenders += [f"{os.path.relpath(path, ROOT)}: {m.group(0).strip()}"
                      for m in pattern.finditer(text)]
        if re.search(r"^\s*(import|from)\s+jax\b", text, re.MULTILINE):
            offenders.append(f"{os.path.relpath(path, ROOT)}: imports jax")
        if pil.search(text):
            offenders.append(f"{os.path.relpath(path, ROOT)}: imports PIL")
    assert not offenders, offenders
    assert pil.search("    from PIL import Image") and pil.search("import PIL.Image")
    assert not pil.search("# the PNG is written without PIL")
    assert pattern.search("from nphm_tpu.ops import marching")
    assert pattern.search("import nphm_tpu")
    assert not pattern.search("from nphm_tpu_torch.ops import marching")
