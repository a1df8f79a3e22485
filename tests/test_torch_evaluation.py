"""The port's evaluation stack vs the JAX package, on the CPU.

- Host rasterizer (the port's copy of ``csrc/rasterizer.cpp``): ``rasterize``,
  ``render_visible_points``, ``native_face_normals`` and
  ``gen_render_samples`` are ``array_equal`` to the JAX package's on a res-64
  sphere and on the dummy tree's template, at 1 and 4 rasterizer threads.
- ``render_screenshot``: the port's PNG, decoded with ``zlib``, holds the
  pixels of the JAX package's PNG.
- Nearest neighbours: the brute force run on the CPU device is index-exact
  against scipy's cKDTree and against the JAX package's ``_device_directed``
  (CPU jax), on random clouds, near-duplicate clouds and odd sizes, and
  equal to itself from concurrent threads; ``backend="device"`` raises
  without CUDA.
- Metrics: ``eval_pointcloud``, ``eval_mesh_onet`` and
  ``eval_viz_uni_chamfer`` agree to 1e-9 relative.
- The eval and gather CLIs of both packages, on one dummy tree with the
  same prediction meshes, write ``metrics.json``, ``metrics_face.json`` and
  both CSVs equal to 1e-9 relative.
"""

import csv
import json
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

from nphm_tpu.evaluation import metrics as jmetrics
from nphm_tpu.evaluation import render as jrender
from nphm_tpu.evaluation.nn import _device_directed
from nphm_tpu.utils.mesh_io import Mesh as JMesh
from nphm_tpu_torch.data.dummy import dummy_env, generate_dummy_data
from nphm_tpu_torch.evaluation import metrics, nn, render
from nphm_tpu_torch.ops.marching import marching_tets
from nphm_tpu_torch.utils.mesh_io import Mesh, load_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _subproc import cpu_subprocess_env  # noqa: E402


def sphere_mesh(r=0.4, res=64):
    ax = np.linspace(-1, 1, res, dtype=np.float32)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    sdf = np.linalg.norm(np.stack([X, Y, Z], -1), axis=-1) - r
    v, f = marching_tets(-sdf, 0.0)
    return Mesh((v * (2.0 / (res - 1)) - 1.0).astype(np.float32), f.astype(np.int64))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A dummy tree: subject 341 (test split, 2 valid expressions)."""
    root = str(tmp_path_factory.mktemp("evaltree"))
    generate_dummy_data(root, subjects=(341,), n_expressions=2, n_supervision=2000)
    return root


@pytest.fixture(scope="module")
def meshes(tree):
    return {"sphere": sphere_mesh(),
            "template": load_mesh(os.path.join(tree, "assets", "template.ply"))}


def jmesh(m):
    return JMesh(m.vertices, m.faces)


@pytest.mark.parametrize("threads", ["1", "4"])
@pytest.mark.parametrize("name", ["sphere", "template"])
def test_rasterizer_matches_jax(meshes, name, threads, monkeypatch):
    monkeypatch.setenv("NPHM_RASTER_THREADS", threads)
    m = meshes[name]
    E = render.look_at(np.array([0.3, 0.2, 1.2]), np.zeros(3), np.array([0, 1, 0]))
    K = np.array([[500.0, 0, 128], [0, 500.0, 128], [0, 0, 1]])
    ours = render.rasterize(m, K, E, rend_size=(256, 200), znear=0.1, zfar=3.0)
    ref = jrender.rasterize(jmesh(m), K, E, rend_size=(256, 200), znear=0.1, zfar=3.0)
    assert ours["mask"].sum() > 1000
    for k in ("depth", "points", "normals", "mask"):
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    vis = render.render_visible_points(m, K, E, rend_size=(256, 200))
    jvis = jrender.render_visible_points(jmesh(m), K, E, rend_size=(256, 200))
    for a, b in zip(vis, jvis):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(render.native_face_normals(m),
                                  jrender.native_face_normals(jmesh(m)))
    pts, nrm = (x.copy() for x in render.gen_render_samples(m, 4))
    jpts, jnrm = jrender.gen_render_samples(jmesh(m), 4)
    assert len(pts) > 10000
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(nrm, jnrm)


def test_native_face_normals_degenerate_is_zero():
    v = np.array([[0, 0, 0], [1, 0, 0], [1, 0, 0]], np.float32)
    degen = Mesh(v, np.array([[0, 1, 2]], np.int64))
    np.testing.assert_array_equal(render.native_face_normals(degen), np.zeros((1, 3)))
    np.testing.assert_array_equal(degen.face_normals, np.zeros((1, 3)))


def read_png(path):
    """Pixels of an 8-bit RGB PNG whose rows all use filter 0."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = ihdr[:4]
    assert (depth, color) == (8, 2)
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


def test_render_screenshot_matches_jax_png(meshes, tmp_path):
    from PIL import Image

    m = meshes["sphere"]
    render.render_screenshot(m, str(tmp_path / "ours.png"), rend_size=(160, 120))
    jrender.render_screenshot(jmesh(m), str(tmp_path / "ref.png"), rend_size=(160, 120))
    ours = read_png(tmp_path / "ours.png")
    ref = np.asarray(Image.open(tmp_path / "ref.png").convert("RGB"))
    assert ours.shape == (160, 120, 3)
    assert (ours[2, 2] == 255).all() and (ours[80, 60] < 250).any()
    np.testing.assert_array_equal(ours, ref)


def clouds(kind, seed=7):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return ((rng.normal(size=(3000, 3)) * 120).astype(np.float32),
                (rng.normal(size=(4100, 3)) * 120).astype(np.float32))
    if kind == "near_duplicates":  # the expansion form's ill-conditioned regime
        q = (rng.normal(size=(2000, 3)) * 120).astype(np.float32)
        r = np.concatenate([q + rng.normal(size=q.shape).astype(np.float32) * 1e-3,
                            (rng.normal(size=(1500, 3)) * 120).astype(np.float32)])
        return q, r
    # odd sizes: a query count off the chunk, a reference count off the tile,
    # and fewer reference points than candidates
    return (rng.normal(size=(2049, 3)).astype(np.float32),
            rng.normal(size=(int(kind), 3)).astype(np.float32))


@pytest.mark.parametrize("kind", ["random", "near_duplicates", "1000", "5"])
def test_brute_force_index_exact_vs_scipy_and_jax(kind):
    from scipy.spatial import cKDTree

    q, r = clouds(kind)
    d, i = nn.brute_force_directed(q, r, device="cpu")  # 2048-row chunks on the CPU
    d_sp, i_sp = cKDTree(r).query(q)
    d_j, i_j = _device_directed(q, r)
    assert d.dtype == np.float64 and i.dtype == np.int64 and d.shape == (len(q),)
    np.testing.assert_array_equal(i, i_sp)
    np.testing.assert_array_equal(i, i_j)
    np.testing.assert_allclose(d, d_sp, rtol=0, atol=1e-4 if kind in ("random",
                                                                      "near_duplicates") else 1e-6)


def test_brute_force_concurrent_callers_match_serial():
    """The eval CLI's thread pool calls the brute force concurrently: more
    threads than cores, a short switch interval, every result equal to the
    serial one."""
    import threading

    jobs = [clouds("random", seed) for seed in range(4)]
    serial = [nn.brute_force_directed(q, r, device="cpu") for q, r in jobs]
    n_threads = min(32, 2 * (os.cpu_count() or 1))
    results = [None] * n_threads

    def work(t):
        results[t] = nn.brute_force_directed(*jobs[t % len(jobs)], device="cpu")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for t, got in enumerate(results):
        ref = serial[t % len(jobs)]
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])


def test_backends():
    q, r = clouds("1000")
    with pytest.raises(RuntimeError, match="CUDA"):
        nn.nearest_neighbors(q, r, backend="device")
    with pytest.raises(ValueError):
        nn.nearest_neighbors(q, r, backend="tpu")
    assert not nn.use_device(250_000, 250_000)  # no card here: scipy
    d, i = nn.nearest_neighbors(q, r, backend="auto")
    d_sp, i_sp = nn.nearest_neighbors(q, r, backend="scipy")
    np.testing.assert_array_equal(i, i_sp)
    np.testing.assert_array_equal(d, d_sp)


def assert_dicts_close(ours, ref, rtol=1e-9):
    assert sorted(ours) == sorted(ref)
    for k in ref:
        a, b = np.asarray(ours[k], np.float64), np.asarray(ref[k], np.float64)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=0, equal_nan=True, err_msg=k)


def test_metrics_match_jax(meshes):
    rng = np.random.default_rng(0)
    pred = rng.normal(size=(4000, 3)) * 0.3
    gt = pred[:3500] + rng.normal(size=(3500, 3)) * 0.01
    n_pred, n_gt = rng.normal(size=(4000, 3)), rng.normal(size=(3500, 3))
    for kw in (dict(metric_space=False), dict(metric_space=True, scale_to_metric=25.0)):
        assert_dicts_close(metrics.eval_pointcloud(pred, gt, n_pred, n_gt, **kw),
                           jmetrics.eval_pointcloud(pred, gt, n_pred, n_gt, **kw))
    ours, oerr = metrics.eval_pointcloud(pred, gt, metric_space=False, return_error_pcs=True)
    ref, jerr = jmetrics.eval_pointcloud(pred, gt, metric_space=False, return_error_pcs=True)
    assert_dicts_close(ours, ref)
    assert_dicts_close({k: v for k, v in oerr.items() if v is not None},
                       {k: v for k, v in jerr.items() if v is not None})

    a, b = meshes["sphere"], sphere_mesh(r=0.42, res=48)
    for kw in (dict(), dict(remove_wall=True), dict(include_cdists_for_viz=True)):
        assert_dicts_close(metrics.eval_mesh_onet(a, b, n_points=3000, rng=3, **kw),
                           jrender_onet(a, b, n_points=3000, rng=3, **kw))
    assert_dicts_close(metrics.eval_viz_uni_chamfer(a.vertices, b.vertices, a.vertex_normals,
                                                    b.vertex_normals),
                       jmetrics.eval_viz_uni_chamfer(a.vertices, b.vertices,
                                                     jmesh(a).vertex_normals,
                                                     jmesh(b).vertex_normals))


def jrender_onet(a, b, **kw):
    return jmetrics.eval_mesh_onet(jmesh(a), jmesh(b), **kw)


def run(args, env):
    p = subprocess.run([sys.executable] + args, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    return p.stdout


def test_eval_and_gather_clis_match_jax(tree, tmp_path):
    """Both packages' CLIs on one tree and one set of predictions (the GT
    scan of expression 0, a shifted copy for expression 1), each with its
    own GT cache so both draw from fresh rngs."""
    results = {}
    for pkg in ("jax", "torch"):
        result_dir = tmp_path / pkg
        result_dir.mkdir()
        for e in (0, 1):
            scan = load_mesh(os.path.join(tree, "dataset", "341", f"{e:03d}", "scan.ply"))
            Mesh(scan.vertices + np.float32(0.004 * e), scan.faces).export(
                str(result_dir / f"341_{e}.ply"))
        env = cpu_subprocess_env({**dummy_env(tree), "NPHM_FITTING_DIR": str(tmp_path / f"fit_{pkg}")})
        argv = ["--result_dir", str(result_dir), "--subjects", "341"]
        if pkg == "jax":
            run(["scripts/evaluation/eval.py", *argv, "--num_samps", "4000", "--workers", "2"], env)
            out = run(["scripts/evaluation/gather.py", *argv], env)
        else:
            run(["-m", "nphm_tpu_torch.eval", *argv, "--num_samps", "4000", "--workers", "2",
                 "--device", "cpu"], env)
            out = run(["-m", "nphm_tpu_torch.gather", *argv], env)
        assert "total scans: 2" in out
        results[pkg] = result_dir / "evaluation"
    for e in (0, 1):
        for name in ("metrics.json", "metrics_face.json"):
            paths = [results[p] / "341" / f"expression_{e}" / name for p in ("torch", "jax")]
            ours, ref = (json.loads(p.read_text()) for p in paths)
            assert_dicts_close(ours, ref)
    assert json.loads((results["torch"] / "341" / "expression_0" / "metrics.json")
                      .read_text())["chamfer_l1"] < 0.2  # GT against GT: sampling noise
    for name in ("total_merics.csv", "total_metrics_face.csv"):
        rows = [list(csv.DictReader(open(results[p] / name))) for p in ("torch", "jax")]
        assert len(rows[0]) == len(rows[1]) == 1
        assert_dicts_close({k: float(v) for k, v in rows[0][0].items()},
                           {k: float(v) for k, v in rows[1][0].items()})
