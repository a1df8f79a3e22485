"""Rank bodies of ``tests/test_torch_parallel.py``: the port's data-parallel
paths in gloo ranks on the CPU, spawned with ``torch.multiprocessing.spawn``
and joined through a ``file://`` store (no TCP port to collide with other
test workers), one torch thread a rank.

``run(body, world, run_dir, *args)`` spawns ``world`` ranks that each call
``body(mesh, *args)`` and pickle its result (numpy arrays in plain
containers) to ``run_dir``; it returns the results by rank.  This module
imports neither ``jax`` nor ``nphm_tpu``: the test hands the ranks numpy
weights, batches and draws, and compares what comes back.
"""

import os
import pickle

import numpy as np
import torch


def entry(rank, world, run_dir, body, args):
    import torch.distributed as dist

    from nphm_tpu_torch.parallel.mesh import get_device_mesh

    torch.set_num_threads(1)
    mesh = get_device_mesh(rank=rank, world_size=world,
                           init_method=f"file://{os.path.join(run_dir, 'store')}",
                           backend="gloo", device="cpu")
    try:
        out = body(mesh, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(run_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run(body, world, run_dir, *args):
    run_dir = str(run_dir)
    os.makedirs(run_dir, exist_ok=True)
    torch.multiprocessing.spawn(entry, args=(world, run_dir, body, args), nprocs=world,
                                join=True)
    out = []
    for r in range(world):
        with open(os.path.join(run_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def chain(mesh, calls):
    """Several bodies in one group: {name: body(mesh, *args)}."""
    return {name: body(mesh, *args) for name, (body, args) in calls.items()}


# ---------------------------------------------------------------------------
# Models and trainers from numpy specs
# ---------------------------------------------------------------------------


class _Sized:
    """A dataset stand-in for the trainers' constructors (they read len)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


def nphm_decoder(spec):
    from nphm_tpu_torch.models import NPHMConfig, make_nphm_decoder

    return make_nphm_decoder(NPHMConfig(**spec["kw"]), spec["anchors"])


def deformation_decoder(spec):
    from nphm_tpu_torch.models import DeformationConfig, make_deformation_decoder

    return make_deformation_decoder(DeformationConfig(**spec["kw"]))


def array_draws(draws):
    """A trainer's ``draws`` handing out fixed arrays (the whole batch's)."""

    def draw(kind, shape, device):
        t = torch.tensor(draws[kind], device=device)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kind}: drawn {tuple(shape)}, have {tuple(t.shape)}")
        return t

    return draw


def make_trainer(kind, spec, mesh, exp_dir):
    from nphm_tpu_torch.training.trainer import IdentityTrainer
    from nphm_tpu_torch.training.trainer_corresp import DeformationTrainer
    from nphm_tpu_torch.utils.logging_utils import MetricsLogger
    from nphm_tpu_torch.utils.params import from_numpy_pytree

    logger = MetricsLogger(quiet=True)
    sets = (_Sized(spec["n_train"]), _Sized(spec["n_val"]))
    if kind == "identity":
        tr = IdentityTrainer(nphm_decoder(spec["shape"]),
                             from_numpy_pytree(spec["params"], "cpu"), spec["cfg"], *sets,
                             "id", exp_dir=exp_dir, logger=logger, device="cpu", mesh=mesh)
    else:
        tr = DeformationTrainer(deformation_decoder(spec["expr"]),
                                from_numpy_pytree(spec["params"], "cpu"),
                                nphm_decoder(spec["shape"]), spec["cfg"], *sets, "def",
                                exp_dir=exp_dir, logger=logger,
                                shape_state=spec["shape_state"], device="cpu", mesh=mesh)
    if spec.get("state") is not None:
        tr.load_state_dict(spec["state"])
    for key, table in spec.get("tables", {}).items():
        setattr(tr, key, torch.tensor(table))
    return tr


def drive(tr, spec, mesh):
    """The spec's train steps and one validation step; returns the state
    and each step's loss terms averaged over the ranks (the one-device
    terms), and whether each batch ran sharded."""
    from nphm_tpu_torch.parallel.mesh import all_reduce_mean

    def global_terms(terms):
        keys = sorted(terms)
        vec = torch.stack([terms[k].reshape(()) for k in keys])
        if mesh is not None:
            all_reduce_mean(vec, mesh)
        return dict(zip(keys, vec.numpy().tolist()))

    steps, sharded = [], []
    for k, b in enumerate(spec["batches"]):
        if spec.get("draws"):
            tr.draws = array_draws(spec["draws"][k])
        batch = tr._batch(b)
        sharded.append(tr._shard(batch)[1] is not None)
        steps.append(global_terms(tr._train_step(batch, spec["lr"], spec["lr_lat"])))
    if spec.get("val_batch") is not None:
        if spec.get("draws"):
            tr.draws = array_draws(spec["val_draws"])
        steps.append(global_terms(tr._val_step(tr._batch(spec["val_batch"]), spec["lr_lat"])))
    state = {k: v for k, v in tr.state_dict().items()
             if k in ("params", "latents", "latents_val", "opt_state", "lat_state")}
    return {"state": state, "terms": steps, "sharded": sharded}


def train_suite(mesh, specs, exp_dir):
    """Each spec's steps data-parallel on every rank, and on rank 0 also in
    one process from the same start."""
    out = {}
    for name, (kind, spec) in specs.items():
        tr = make_trainer(kind, spec, mesh, os.path.join(exp_dir, f"r{mesh.rank}"))
        out[name] = {"dp": drive(tr, spec, mesh)}
        if mesh.rank == 0:
            tr = make_trainer(kind, spec, None, os.path.join(exp_dir, "single"))
            out[name]["single"] = drive(tr, spec, None)
    return out


# ---------------------------------------------------------------------------
# Fitting and extraction
# ---------------------------------------------------------------------------


def fit_suite(mesh, spec):
    """``fit_joint_batch`` with the mesh, and on rank 0 also without."""
    from nphm_tpu_torch.fitting.inference import FittingConfig, fit_joint_batch
    from nphm_tpu_torch.utils.params import from_numpy_pytree

    shape, expr = nphm_decoder(spec["shape"]), deformation_decoder(spec["expr"])
    ps = from_numpy_pytree(spec["params_shape"], "cpu")
    pe = from_numpy_pytree(spec["params_expr"], "cpu")
    cfg = FittingConfig(**spec["cfg"])
    out = {}
    for name, m in (("dp", mesh), ("single", None)):
        if name == "single" and mesh.rank != 0:
            break
        le, ls, anchors, hist = fit_joint_batch(shape, ps, expr, pe, spec["subjects"], cfg=cfg,
                                                verbose=False, device="cpu", mesh=m)
        out[name] = {"lat_expr": le, "lat_shape": ls, "anchors": anchors,
                     "hist": {k: v for k, v in hist.items() if isinstance(v, np.ndarray)}}
    return out


def extract_suite(mesh, spec):
    """Every sharded extraction and posing entry point, and on rank 0 the
    same calls without the mesh."""
    from nphm_tpu_torch.ops.ensemble import nphm_grid_sdf
    from nphm_tpu_torch.reconstruction import extract as ext
    from nphm_tpu_torch.reconstruction.sparse import extract_mesh_sparse
    from nphm_tpu_torch.utils.params import from_numpy_pytree

    shape, expr = nphm_decoder(spec["shape"]), deformation_decoder(spec["expr"])
    ps = from_numpy_pytree(spec["params_shape"], "cpu")
    pe = from_numpy_pytree(spec["params_expr"], "cpu")
    lat = spec["lat"]
    box = (spec["mini"], spec["maxi"])
    res, res_fine = spec["res"], spec["res_fine"]

    def calls(m):
        r = {}
        lat_t = torch.tensor(lat)
        for tile in (1024, 2048):
            r[f"grid_tile{tile}"] = nphm_grid_sdf(ps, shape.cfg, lat_t, *box, res, tile=tile,
                                                  device_mesh=m).numpy()
        dense = ext.extract_mesh(shape, ps, lat, *box, res, device="cpu", device_mesh=m)
        r["dense"] = (dense.vertices, dense.faces)
        mesh = ext.extract_mesh_streamed(shape, ps, lat, *box, res_fine, n_slabs=4, tile=1024,
                                         device="cpu", device_mesh=m)
        r["streamed"] = (mesh.vertices, mesh.faces)
        stats = {}
        mesh = extract_mesh_sparse(shape, ps, lat, *box, res_fine, lip=0.5, stats=stats,
                                   device="cpu", device_mesh=m)
        r["sparse"] = (mesh.vertices, mesh.faces)
        r["sparse_stats"] = stats
        evaluate = ext.make_point_evaluator(
            lambda ctx, pts: ext.eval_sdf(shape, ctx["params"], pts, ctx["lat"]),
            chunk_size=spec["chunk"], device="cpu", mesh=m)
        r["points"] = evaluate({"params": ps, "lat": lat_t}, spec["points"])
        posed = ext.deform_mesh_batch(dense, expr, pe, spec["lat_exprs"],
                                      anchors=spec["anchors"], lat_shape=lat, device="cpu",
                                      device_mesh=m)
        r["posed"] = [p.vertices for p in posed]
        return r

    out = {"dp": calls(mesh)}
    if mesh.rank == 0:
        out["single"] = calls(None)
    return out


# ---------------------------------------------------------------------------
# The training CLI in spawned ranks
# ---------------------------------------------------------------------------


def cli_train(mesh, env, argv):
    """``python -m nphm_tpu_torch.train`` as rank ``mesh.rank`` of a spawned
    group (the group exists, as under torchrun it would be made from
    ``RANK`` / ``WORLD_SIZE``).  Ranks past 0 record every checkpoint,
    marker, snapshot and metrics write they attempt."""
    import contextlib
    import io

    os.environ.update(env, RANK=str(mesh.rank), WORLD_SIZE=str(mesh.size))
    from nphm_tpu_torch import config, train
    from nphm_tpu_torch.training import checkpoints
    from nphm_tpu_torch.utils import logging_utils

    writes = []

    def recorded(mod, name):
        fn = getattr(mod, name)

        def call(*a, **kw):
            writes.append(name)
            return fn(*a, **kw)

        setattr(mod, name, call)

    if mesh.rank > 0:
        for mod, name in ((checkpoints, "save_checkpoint"), (checkpoints, "update_val_min"),
                          (config, "snapshot_or_reload_config"),
                          (train, "snapshot_or_reload_config")):
            recorded(mod, name)
        log = logging_utils.MetricsLogger.log

        def logged(self, *a, **kw):
            if self._jsonl is not None:
                writes.append("metrics")
            return log(self, *a, **kw)

        logging_utils.MetricsLogger.log = logged
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(argv)
    return {"stdout": buf.getvalue(), "writes": writes}
