"""The port's data parallelism (``nphm_tpu_torch.parallel``) on the CPU, in
gloo ranks spawned by ``tests/_torch_parallel_workers.py``.

- W = 4 against the JAX package's 4-device mesh: ``IdentityTrainer`` (tiny
  NPHM ensemble) and compress-mode ``DeformationTrainer``, from the JAX
  trainer's state on the same batches (and, stage 2, the JAX key's draws of
  the whole batch), 3 train steps and a validation step; every step's loss
  terms, the params and the latent tables within 1e-5.
- W = 2 and 4 against the port's own one-process step from the same start
  (W = 2: the port trainer's seeded init and the stage-2 generator's
  draws): the change each made to the params and latent tables agrees
  within 1e-5 relative (L2 of the difference of the changes over L2 of the
  one-process change), and every rank's state is bit-equal to rank 0's.
- A batch whose rows the ranks do not divide runs whole on every rank:
  bit-equal to the one-process step.
- ``fit_joint_batch(mesh=)`` at W = 2 with S = 3 (one dummy subject pads
  the subject axis) against ``mesh=None``: each subject's codes within
  1e-5, the history of the same shape and within 1e-5.
- ``nphm_grid_sdf`` (res 32, tiles 1024 and 2048), ``extract_mesh``,
  ``extract_mesh_streamed`` and ``extract_mesh_sparse`` (res 64; lip 0.5,
  so that the coarse pass skips blocks), the chunked point evaluator and
  ``deform_mesh_batch``, with a W = 2 mesh against one process: logits
  within 1e-6, vertex and face arrays equal, on every rank.
- ``python -m nphm_tpu_torch.train`` as two spawned ranks with ``-backend
  gloo -device cpu``: it trains, prints the data-parallel line, and only
  rank 0 writes the snapshot, checkpoints and metrics.
"""

import json
import os

import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import _torch_parallel_workers as workers
from nphm_tpu.data.synthetic import (
    SyntheticDeformationDataset as JSyntheticDeformation,
    SyntheticIdentityDataset as JSyntheticIdentity,
)
from nphm_tpu.models import (
    DeformationConfig as JDeformationConfig,
    NPHMConfig as JNPHMConfig,
    make_deformation_decoder as jmake_deformation,
    make_nphm_decoder as jmake_nphm,
)
from nphm_tpu.training.trainer import IdentityTrainer as JIdentityTrainer
from nphm_tpu.training.trainer_corresp import DeformationTrainer as JDeformationTrainer
from nphm_tpu.utils.logging_utils import MetricsLogger as JMetricsLogger
from nphm_tpu_torch.data.dummy import dummy_env, generate_dummy_data
from nphm_tpu_torch.parallel.mesh import _starts
from nphm_tpu_torch.utils.params import trainer_state_from_jax

TOL = 1e-5
SHAPE_KW = dict(lat_dim_glob=8, lat_dim_loc=4, n_loc=6, n_symm_pairs=2, hidden_dim=16,
                n_layers=4, pos_mlp_dim=16)
DEF_KW = dict(mode="compress", lat_dim_glob_shape=8, lat_dim_loc_shape=4, n_loc=6,
              lat_dim_expr=8, lat_dim_id=8, hidden_dim=32, n_layers=4)
ID_LAMBDAS = {"lat_reg": 0.01, "surf_sdf": 2.0, "normals": 0.3, "space_sdf": 0.01,
              "grad": 0.1, "anchors": 7.5, "symm_dist": 0.01, "middle_dist": 0.0}
DEF_LAMBDAS = {"corresp": 100.0, "lat_reg": 5e-5, "loss_reg_zero": 5e-5}
LR, LR_LAT = 1e-3, 3e-3


def train_cfg(lambdas, batch):
    return {"training": {"batch_size": batch, "ckpt_interval": 10**9, "grad_clip": 0.1,
                         "grad_clip_lat": 0.1, "lr": LR, "lr_lat": LR_LAT,
                         "lr_decay_factor": 0.5, "lr_decay_factor_lat": 0.5,
                         "lr_decay_interval": 120, "lr_decay_interval_lat": 120,
                         "weight_decay": 0.01, "fused_train_kernel": False,
                         "lambdas": lambdas}}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """Tiny NPHM identity decoder and compress-mode field (JAX init), as
    numpy specs for the ranks."""
    rng = np.random.default_rng(0)
    anchors = (rng.normal(size=(SHAPE_KW["n_loc"], 3)) * 0.25).astype(np.float32)
    js = jmake_nphm(JNPHMConfig(**SHAPE_KW), anchors)
    je = jmake_deformation(JDeformationConfig(**DEF_KW))
    return dict(js=js, je=je, jps=js.init(jax.random.PRNGKey(0)),
                jpe=je.init(jax.random.PRNGKey(1)),
                shape={"kw": SHAPE_KW, "anchors": anchors}, expr={"kw": DEF_KW})


def identity_data(n_subjects, batch, seed=0):
    return JSyntheticIdentity(n_subjects=n_subjects, batch_size=batch, n_face=32,
                              n_non_face=32, n_anchors=SHAPE_KW["n_loc"], seed=seed)


def deformation_data(batch):
    return JSyntheticDeformation(identity_data(4, 2), n_expressions=2, n_points=64,
                                 batch_size=batch)


def first_batches(ds, n):
    """The first batch of epochs 0..n-1 (numpy)."""
    return [next(iter(ds.batch_iter(seed=e))) for e in range(n)]


def shape_state(m, n):
    rng = np.random.default_rng(1)
    d = m["js"].lat_dim
    return {"params": np_tree(m["jps"]),
            "latents": (rng.normal(size=(n, d)) * 0.1).astype(np.float32),
            "latents_val": (rng.normal(size=(n, d)) * 0.1).astype(np.float32)}


def jax_draws(key, B, n_pts, lat_dim_id):
    """The noise and prior samples the JAX ``deformation_loss`` draws from
    ``key`` (tests/test_torch_train_corresp.py), as numpy."""
    k_noise, k_samps, k_noise2 = jax.random.split(key, 3)
    return {"noise": np.asarray(jax.random.normal(k_noise, (B, lat_dim_id))),
            "samples": np.asarray(jax.random.uniform(k_samps, (B, min(100, n_pts), 3))),
            "noise_reg": np.asarray(jax.random.normal(k_noise2, (B, lat_dim_id)))}


def jax_mesh4():
    return Mesh(np.asarray(jax.devices("cpu")[:4]), ("data",))


def jax_identity_run(m, tmp_path):
    """The JAX identity trainer on a 4-device mesh: 3 DP steps and a DP
    validation step from its init.  Returns (port spec, JAX results)."""
    train_ds, val_ds = identity_data(16, 8), identity_data(8, 8, seed=5)
    cfg = train_cfg(ID_LAMBDAS, 8)
    jtr = JIdentityTrainer(m["js"], jax.tree_util.tree_map(jnp.array, m["jps"]), cfg,
                           train_ds, val_ds, "jid", exp_dir=str(tmp_path),
                           logger=JMetricsLogger(quiet=True), mesh=jax_mesh4())
    start = trainer_state_from_jax(np_tree(jtr._state_tree()))
    batches, vb = first_batches(train_ds, 3), first_batches(val_ds, 1)[0]
    terms = []
    for b in batches:
        b = {k: jnp.asarray(v) for k, v in b.items()}
        step = jtr._pick(jtr._train_step, jtr._train_step_dp, b)
        assert step is jtr._train_step_dp
        jtr.params, jtr.opt_state, jtr.latents, jtr.lat_state, t = step(
            jtr.params, jtr.opt_state, jtr.latents, jtr.lat_state, b, jnp.float32(LR),
            jnp.float32(LR_LAT))
        terms.append(np_tree(t))
    b = {k: jnp.asarray(v) for k, v in vb.items()}
    vstep = jtr._pick(jtr._val_step, jtr._val_step_dp, b)
    jtr.latents_val, jtr.lat_state_val, t = vstep(jtr.latents_val, jtr.lat_state_val,
                                                  jtr.params, b, jnp.float32(LR_LAT))
    terms.append(np_tree(t))
    spec = {"shape": m["shape"], "params": start["params"], "cfg": cfg,
            "n_train": len(train_ds), "n_val": len(val_ds), "state": start,
            "batches": batches, "val_batch": vb, "lr": LR, "lr_lat": LR_LAT}
    return spec, {"terms": terms, "state": trainer_state_from_jax(np_tree(jtr._state_tree()))}


def jax_deformation_run(m, tmp_path):
    """The JAX compress-mode stage-2 trainer on a 4-device mesh: 3 DP steps
    and a DP validation step, each with its own key."""
    ds = deformation_data(8)
    cfg = train_cfg(DEF_LAMBDAS, 8)
    state = shape_state(m, 4)
    jtr = JDeformationTrainer(m["je"], jax.tree_util.tree_map(jnp.array, m["jpe"]), m["js"],
                              cfg, ds, ds, "jdef", exp_dir=str(tmp_path), shape_state=state,
                              logger=JMetricsLogger(quiet=True), mesh=jax_mesh4())
    tables = {"latents": np.asarray(jtr.latents), "latents_val": np.asarray(jtr.latents_val)}
    params = np_tree(jtr.params)
    batches, vb = first_batches(ds, 3), first_batches(ds, 1)[0]
    terms, draws = [], []
    for k, b in enumerate(batches):
        key = jax.random.PRNGKey(100 + k)
        draws.append(jax_draws(key, 8, 64, DEF_KW["lat_dim_id"]))
        b = {kk: jnp.asarray(v) for kk, v in b.items()}
        step = jtr._pick(jtr._train_step, jtr._train_step_dp, b)
        assert step is jtr._train_step_dp
        jtr.params, jtr.opt_state, jtr.latents, jtr.lat_state, t = step(
            jtr.params, jtr.opt_state, jtr.latents, jtr.lat_state, b, jnp.float32(LR),
            jnp.float32(LR_LAT), key)
        terms.append(np_tree(t))
    key = jax.random.PRNGKey(7)
    b = {kk: jnp.asarray(v) for kk, v in vb.items()}
    vstep = jtr._pick(jtr._val_step, jtr._val_step_dp, b)
    jtr.latents_val, jtr.lat_state_val, t = vstep(jtr.latents_val, jtr.lat_state_val,
                                                  jtr.params, b, jnp.float32(LR_LAT), key)
    terms.append(np_tree(t))
    spec = {"shape": m["shape"], "expr": m["expr"], "params": params, "tables": tables,
            "cfg": cfg, "n_train": len(ds), "n_val": len(ds), "shape_state": state,
            "batches": batches, "val_batch": vb, "draws": draws,
            "val_draws": jax_draws(key, 8, 64, DEF_KW["lat_dim_id"]), "lr": LR,
            "lr_lat": LR_LAT}
    return spec, {"terms": terms, "state": {"params": np_tree(jtr.params),
                                            "latents": np.asarray(jtr.latents),
                                            "latents_val": np.asarray(jtr.latents_val)}}


@pytest.fixture(scope="module")
def w4(models, tmp_path_factory):
    """JAX at 4 devices, then the port's W = 4 ranks from the JAX states."""
    tmp = tmp_path_factory.mktemp("w4")
    id_spec, id_ref = jax_identity_run(models, tmp)
    def_spec, def_ref = jax_deformation_run(models, tmp)
    specs = {"identity": ("identity", id_spec), "deformation": ("deformation", def_spec)}
    calls = {"train": (workers.train_suite, (specs, str(tmp / "exp")))}
    return {"ranks": workers.run(workers.chain, 4, tmp / "run", calls),
            "ref": {"identity": id_ref, "deformation": def_ref}}


def port_specs(m):
    """Port-only specs for W = 2: the trainers' own seeded init, batches of
    4 rows (2 a rank), the stage-2 generator's draws; and one step of a
    3-row batch, which 2 ranks do not divide."""
    id_train, id_val = identity_data(8, 4), identity_data(4, 4, seed=5)
    ds = deformation_data(4)
    base = {"shape": m["shape"], "lr": LR, "lr_lat": LR_LAT}
    return {
        "identity": ("identity", dict(base, params=np_tree(m["jps"]), cfg=train_cfg(ID_LAMBDAS, 4),
                                      n_train=8, n_val=4, batches=first_batches(id_train, 3),
                                      val_batch=first_batches(id_val, 1)[0])),
        "deformation": ("deformation", dict(
            base, expr=m["expr"], params=np_tree(m["jpe"]), cfg=train_cfg(DEF_LAMBDAS, 4),
            n_train=len(ds), n_val=len(ds), shape_state=shape_state(m, 4),
            batches=first_batches(ds, 3), val_batch=first_batches(ds, 1)[0])),
        "ragged": ("identity", dict(base, params=np_tree(m["jps"]), cfg=train_cfg(ID_LAMBDAS, 3),
                                    n_train=8, n_val=4,
                                    batches=first_batches(identity_data(8, 3), 1))),
    }


def observations(rng, n_obs, n_pts):
    return [(rng.normal(size=(n_pts, 3)) * 0.2).astype(np.float32) for _ in range(n_obs)]


@pytest.fixture(scope="module")
def w2(models, tmp_path_factory):
    """One W = 2 group: training, the batched fit, extraction and posing."""
    tmp = tmp_path_factory.mktemp("w2")
    m = models
    rng = np.random.default_rng(3)
    params = {"params_shape": np_tree(m["jps"]), "params_expr": np_tree(m["jpe"]),
              "shape": m["shape"], "expr": m["expr"]}
    fit = dict(params, subjects=[observations(rng, n, 300) for n in (3, 2, 4)],
               cfg={"n_steps": 4, "n_obs_per_batch": 2, "n_points_per_obs": 64,
                    "log_every": 10**9})
    lat = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (m["js"].lat_dim,)) * 0.1,
                     np.float32)
    extract = dict(params, lat=lat, mini=(-0.55, -0.5, -0.95), maxi=(0.55, 0.75, 0.4),
                   res=32, res_fine=64, chunk=128,
                   points=(rng.normal(size=(1000, 3)) * 0.3).astype(np.float32),
                   lat_exprs=(rng.normal(size=(3, 8)) * 0.1).astype(np.float32),
                   anchors=(rng.normal(size=(6, 3)) * 0.25).astype(np.float32))
    calls = {"train": (workers.train_suite, (port_specs(m), str(tmp / "exp"))),
             "fit": (workers.fit_suite, (fit,)),
             "extract": (workers.extract_suite, (extract,))}
    return {"ranks": workers.run(workers.chain, 2, tmp / "run", calls)}


def close(a, b, what):
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=TOL, rtol=0,
                                   err_msg=what)


def terms_close(ours, ref):
    assert len(ours) == len(ref)
    for k, (a, b) in enumerate(zip(ours, ref)):
        assert sorted(a) == sorted(b), k
        for name in a:
            np.testing.assert_allclose(a[name], float(b[name]), rtol=TOL, atol=1e-7,
                                       err_msg=f"step {k} {name}")


def test_identity_dp_matches_jax(w4):
    ref = w4["ref"]["identity"]
    for rank in w4["ranks"]:
        got = rank["train"]["identity"]["dp"]
        assert got["sharded"] == [True] * 3
        terms_close(got["terms"], ref["terms"])
        for key in ("params", "latents", "latents_val"):
            close(got["state"][key], ref["state"][key], key)


def test_deformation_dp_matches_jax(w4):
    ref = w4["ref"]["deformation"]
    for rank in w4["ranks"]:
        got = rank["train"]["deformation"]["dp"]
        assert got["sharded"] == [True] * 3
        terms_close(got["terms"], ref["terms"])
        for key in ("params", "latents", "latents_val"):
            close(got["state"][key], ref["state"][key], key)


def flat(tree):
    return np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(tree)]
                          ).astype(np.float64)


@pytest.mark.parametrize("world", [2, 4])
def test_dp_matches_one_process(world, request):
    """The change a DP run made to the params and latent tables against the
    one-process run's, and the loss terms, from the same start."""
    ranks = [r["train"] for r in request.getfixturevalue(f"w{world}")["ranks"]]
    for name in ("identity", "deformation"):
        dp, single = ranks[0][name]["dp"], ranks[0][name]["single"]
        terms_close(dp["terms"], single["terms"])
        for key in ("params", "latents", "latents_val"):
            a, b = flat(dp["state"][key]), flat(single["state"][key])
            rel = np.linalg.norm(a - b) / np.linalg.norm(b)
            assert rel <= TOL, (name, key, rel)


@pytest.mark.parametrize("world", [2, 4])
def test_replicas_bit_equal(world, request):
    ranks = [r["train"] for r in request.getfixturevalue(f"w{world}")["ranks"]]
    for name in ("identity", "deformation"):
        ref = ranks[0][name]["dp"]["state"]
        for rank in ranks[1:]:
            for a, b in zip(jax.tree_util.tree_leaves(rank[name]["dp"]["state"]),
                            jax.tree_util.tree_leaves(ref)):
                np.testing.assert_array_equal(a, b)


def test_ragged_batch_runs_whole(w2):
    w2 = w2["ranks"]
    for rank in w2:
        got, single = rank["train"]["ragged"]["dp"], w2[0]["train"]["ragged"]["single"]
        assert got["sharded"] == [False]
        for a, b in zip(jax.tree_util.tree_leaves(got["state"]),
                        jax.tree_util.tree_leaves(single["state"])):
            np.testing.assert_array_equal(a, b)
        assert got["terms"] == single["terms"]


def test_fit_joint_batch_sharded(w2):
    w2 = w2["ranks"]
    single = w2[0]["fit"]["single"]
    assert len(single["lat_shape"]) == 3
    for rank in w2:
        dp = rank["fit"]["dp"]
        for key in ("lat_shape", "lat_expr", "anchors"):
            assert [np.shape(x) for x in dp[key]] == [np.shape(x) for x in single[key]]
            for a, b in zip(dp[key], single[key]):
                np.testing.assert_allclose(a, b, atol=TOL, rtol=0, err_msg=key)
        assert sorted(dp["hist"]) == sorted(single["hist"])
        for k, v in single["hist"].items():
            assert dp["hist"][k].shape == v.shape == (4, 3), k
            np.testing.assert_allclose(dp["hist"][k], v, atol=TOL, rtol=TOL, err_msg=k)


def test_grid_sdf_sharded(w2):
    w2 = w2["ranks"]
    single = w2[0]["extract"]["single"]
    for rank in w2:
        for tile in (1024, 2048):
            key = f"grid_tile{tile}"
            np.testing.assert_allclose(rank["extract"]["dp"][key], single[key], atol=1e-6,
                                       rtol=0)


@pytest.mark.parametrize("path", ["dense", "streamed", "sparse"])
def test_extraction_sharded(w2, path):
    w2 = w2["ranks"]
    single = w2[0]["extract"]["single"]
    assert len(single[path][0]) > 0
    for rank in w2:
        dp = rank["extract"]["dp"]
        np.testing.assert_array_equal(dp[path][0], single[path][0])
        np.testing.assert_array_equal(dp[path][1], single[path][1])
    if path == "sparse":
        stats = single["sparse_stats"]
        assert 0 < stats["n_candidates"] < stats["n_blocks"]
        assert all(r["extract"]["dp"]["sparse_stats"] == stats for r in w2)


def test_point_evaluator_sharded(w2):
    w2 = w2["ranks"]
    single = w2[0]["extract"]["single"]["points"]
    assert single.shape == (1000, 1)
    for rank in w2:
        np.testing.assert_array_equal(rank["extract"]["dp"]["points"], single)


def test_deform_mesh_sharded(w2):
    w2 = w2["ranks"]
    single = w2[0]["extract"]["single"]["posed"]
    assert len(single) == 3
    for rank in w2:
        for a, b in zip(rank["extract"]["dp"]["posed"], single):
            np.testing.assert_array_equal(a, b)


def test_shard_blocks_cover_rows():
    for n, size, granule in ((10, 4, 1), (32768, 2, 2048), (1000, 3, 128), (5, 4, 8)):
        s = _starts(n, size, granule)
        assert s[0] == 0 and s[-1] == n and all(a <= b for a, b in zip(s, s[1:]))
        assert all(x % granule == 0 or x == n for x in s)


ID_DECODER = {"decoder_lat_dim_glob": 8, "decoder_lat_dim_loc": 4, "decoder_hidden_dim": 16,
              "decoder_nlayers": 2, "decoder_nloc": 39, "decoder_nsymm_pairs": 16,
              "pos_mlp_dim": 16}


def test_cli_train_two_ranks(tmp_path):
    root = str(tmp_path / "tree")
    generate_dummy_data(root, subjects=(351, 365, 199), n_expressions=1, n_supervision=2000)
    env = dummy_env(root)
    cfg = {"decoder": ID_DECODER, "training": {
        "batch_size": 2, "ckpt_interval": 1, "grad_clip": 0.1, "grad_clip_lat": 0.1,
        "lr": 0.0005, "lr_lat": 0.001, "lr_decay_factor": 0.5, "lr_decay_factor_lat": 0.5,
        "lr_decay_interval": 5000, "lr_decay_interval_lat": 5000, "npoints_decoder": 100,
        "npoints_decoder_non": 50, "sigma_near": 0.01, "weight_decay": 0.01, "nepochs": 2,
        "recon_resolution": 16, "lambdas": ID_LAMBDAS}}
    path = str(tmp_path / "id.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    argv = ["-exp_name", "dp", "-cfg_file", path, "-local", "-device", "cpu",
            "-backend", "gloo"]
    ranks = workers.run(workers.cli_train, 2, tmp_path / "run", env, argv)
    assert "Data-parallel training over 2 devices (gloo)" in ranks[0]["stdout"]
    assert ranks[1]["stdout"] == "" and ranks[1]["writes"] == []
    exp = os.path.join(env["NPHM_EXPERIMENT_DIR"], "dp")
    assert sorted(os.listdir(os.path.join(exp, "checkpoints"))) == [
        "checkpoint_epoch_0.pkl", "checkpoint_epoch_1.pkl"]
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in records)
