"""Each CUDA kernel against its plain PyTorch version, on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
false (decided inside the fixture, never at import).  Run on a GPU machine
with ``python -m pytest tests/test_torch_kernels_cuda.py -q``.  The same
production-dims checks run unconditionally in ``chip_smoke.py`` phase 3;
here they also run at tiny widths, where a hidden layer can be 1 wide and
exercises the zero-padded weight layouts.
"""

import os
import sys

import numpy as np
import pytest
import torch

from nphm_tpu_torch.models import (
    DeepSDFConfig,
    DeformationConfig,
    NPHMConfig,
    make_deformation_decoder,
    make_nphm_decoder,
    make_npm_decoder,
)
from nphm_tpu_torch.models.ensemble import mirror_scale, predict_anchors
from nphm_tpu_torch.ops import ensemble as ens
from nphm_tpu_torch.ops import fit_fields as ff
from nphm_tpu_torch.ops import search as srch
from nphm_tpu_torch.ops import train_fields as trf
from nphm_tpu_torch.ops import trunk

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(lat_dim_glob=8, lat_dim_loc=4, n_loc=39, n_symm_pairs=16, hidden_dim=16,
            n_layers=4, pos_mlp_dim=16)
TINY_DEF = dict(mode="compress", lat_dim_glob_shape=8, lat_dim_loc_shape=4, n_loc=39,
                lat_dim_expr=8, lat_dim_id=8, hidden_dim=48, n_layers=4)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


def tiny_models(device):
    rng = np.random.default_rng(0)
    anchors = (rng.normal(size=(39, 3)) * 0.3).astype(np.float32)
    shape = make_nphm_decoder(NPHMConfig(**TINY), anchors)
    expr = make_deformation_decoder(DeformationConfig(**TINY_DEF))
    gen = torch.Generator().manual_seed(0)
    return shape, shape.init(gen, device), expr, expr.init(gen, device), gen


@pytest.mark.parametrize("cull_eps", [ens.CULL_EPS, 0.0])
def test_k1_tiny_widths(device, cull_eps):
    shape, params, _e, _pe, gen = tiny_models(device)
    lat = (torch.randn(shape.lat_dim, generator=gen) * 0.1).to(device)
    pts = ((torch.rand((5000, 3), generator=gen) - 0.5)).to(device)
    before = ens.nphm_sdf.launches
    out = ens.nphm_sdf(params, shape.cfg, pts, lat, cull_eps=cull_eps)
    assert ens.nphm_sdf.launches == before + 1
    ref = ens.nphm_sdf_plain(params, shape.cfg, pts, lat, cull_eps=cull_eps)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


def test_k2_tiny_widths(device):
    shape, ps, expr, pe, gen = tiny_models(device)
    c = smoke()
    obs, cond, eye = c.search_inputs(shape, ps, expr, pe, gen, device, 3, 777)
    for budget in (1, 4, 15):
        k = srch.broyden_search(pe["trunk"], expr.cfg.trunk_cfg, cond, obs, obs, eye, budget)
        p = srch.broyden_search_plain(pe["trunk"], expr.cfg.trunk_cfg, cond, obs, obs, eye,
                                      budget)
        torch.testing.assert_close(k["result"], p["result"], atol=1e-5, rtol=0)
        torch.testing.assert_close(k["diff"], p["diff"], atol=1e-5, rtol=0)
        assert int((k["valid_ids"] != p["valid_ids"]).sum()) <= 1
        assert int(k["iters"]) == int(p["iters"])


def tiny_shape(device, hidden):
    rng = np.random.default_rng(0)
    anchors = (rng.normal(size=(39, 3)) * 0.3).astype(np.float32)
    shape = make_nphm_decoder(NPHMConfig(**dict(TINY, hidden_dim=hidden)), anchors)
    gen = torch.Generator().manual_seed(0)
    return shape, shape.init(gen, device), gen


@pytest.mark.parametrize("hidden,n_pts", [(16, 700), (72, 1000), (200, 700)])
def test_k3_k4_tiny_widths(device, hidden, n_pts):
    """K3/K4 through apply_nphm_fit vs the plain version: hidden widths that
    are not multiples of K4's 16-wide K slice or 8-wide MMA tiles, and rows
    of points that are not multiples of its 64-point tile (padded inside
    the 512-point cull tile)."""
    shape, params, gen = tiny_shape(device, hidden)
    xyz = (torch.randn((3, n_pts, 3), generator=gen) * 0.3).to(device)
    lat = (torch.randn((3, shape.lat_dim), generator=gen) * 0.1).to(device)
    out = {}
    for name, fn in (("kernel", ff.member_f), ("plain", ff.member_f_plain)):
        x = xyz.clone().requires_grad_(True)
        la = lat.clone().requires_grad_(True)
        sdf, _ = ff.apply_nphm_fit(params, shape.cfg, x, la, cull_eps=1e-10, sort=True,
                                   member_fn=fn)
        torch.sin(3.0 * sdf).sum().backward()
        out[name] = (sdf.detach(), la.grad, x.grad)
    for a, b in zip(out["kernel"], out["plain"]):
        torch.testing.assert_close(a, b, atol=1e-4 * float(b.abs().max()), rtol=0)


@pytest.mark.parametrize("hidden,n_pts", [(16, 700), (72, 1000), (200, 700)])
@pytest.mark.parametrize("cull_eps", [0.0, 1e-10])
def test_k5_k6_tiny_widths(device, hidden, n_pts, cull_eps):
    """apply_nphm_train through K5/K6 vs its plain version: outputs and the
    gradient of a loss over (sdf, grads) w.r.t. params, lat and xyz, at
    hidden widths that are not multiples of K5's 16-wide K slice or 8-wide
    MMA tiles, and rows of points that are not multiples of its 64-point
    tile (padded inside the 512-point cull tile)."""
    shape, params, gen = tiny_shape(device, hidden)
    xyz = (torch.randn((3, n_pts, 3), generator=gen) * 0.3).to(device)
    lat = (torch.randn((3, shape.lat_dim), generator=gen) * 0.1).to(device)
    tgt = torch.randn((3, n_pts, 3), generator=gen).to(device)
    out = {}
    for name, fn in (("kernel", trf.member_fields), ("plain", trf.member_fields_plain)):
        p = {"ensemble": [{k: v.clone().requires_grad_(True) for k, v in lay.items()}
                          for lay in params["ensemble"]],
             "mlp_pos": params["mlp_pos"], "mean_anchors": params["mean_anchors"]}
        x = xyz.clone().requires_grad_(True)
        la = lat.clone().requires_grad_(True)
        before = (trf.member_fields.launches, trf.member_fields.bwd_launches)
        sdf, g, anchors = trf.apply_nphm_train(p, shape.cfg, x, la, cull_eps=cull_eps,
                                               member_fn=fn)
        loss = (sdf.abs().mean() + ((g - tgt) ** 2).sum(-1).mean()
                + (g.norm(dim=-1) - 1).abs().mean())
        leaves = [v for lay in p["ensemble"] for v in lay.values()]
        grads = torch.autograd.grad(loss, leaves + [la, x])
        if name == "kernel":
            assert (trf.member_fields.launches, trf.member_fields.bwd_launches) == (
                before[0] + 1, before[1] + 1)
        out[name] = (sdf.detach(), g.detach()) + tuple(grads)
    for a, b in zip(out["kernel"], out["plain"]):
        torch.testing.assert_close(a, b, atol=1e-4 * float(b.abs().max()), rtol=0)


def test_k5_culled_pairs_write_zero(device):
    """K5 at cull_eps 1e-10 on Morton-sorted points: every culled (member,
    cull tile) pair gets exactly zero F and G, and the live ones match the
    plain version."""
    shape, params, gen = tiny_shape(device, 72)
    cfg, B, tile = shape.cfg, 3, 512
    xyz = (torch.randn((B, 1000, 3), generator=gen) * 0.3).to(device)
    perm = torch.argsort(ff.morton_codes(xyz), dim=1, stable=True)
    xyz = torch.gather(xyz, 1, perm[..., None].expand(B, 1000, 3))
    xyz = torch.cat([xyz, xyz[:, -1:].expand(B, 24, 3)], dim=1)
    lat = (torch.randn((B, shape.lat_dim), generator=gen) * 0.1).to(device)
    with torch.no_grad():
        anchors = predict_anchors(params, cfg, lat)
        centers = torch.cat([anchors, torch.zeros_like(anchors[:, :1])], dim=1)
        coords = (xyz[:, :, None] - centers[:, None]) * mirror_scale(cfg, device)
        coords = coords.permute(2, 3, 0, 1).reshape(cfg.n_members, 3, -1).contiguous()
        layers, _ = ff.prepare_train_operands(params, cfg, lat)
        active = ff.active_mask(cfg, coords, tile, 1e-10)
        F, G = trf.member_fields(cfg, layers, coords, active, tile, B)
    assert 0 < int(active.sum()) < active.numel()  # culling fires
    culled = (active.T == 0).repeat_interleave(tile, dim=1)  # [A, M]
    assert torch.all(F[culled] == 0)
    assert torch.all(G.permute(1, 0, 2)[:, culled] == 0)
    Fp, Gp = (t.detach() for t in trf.member_fields_plain(cfg, layers, coords, active,
                                                           tile, B))
    torch.testing.assert_close(F, Fp, atol=1e-4 * float(Fp.abs().max()), rtol=0)
    torch.testing.assert_close(G, Gp, atol=1e-4 * float(Gp.abs().max()), rtol=0)


@pytest.mark.parametrize("kw,scratch,n", [
    (dict(lat_dim=32, hidden_dim=64, n_layers=4), None, 1000),
    (dict(lat_dim=16, hidden_dim=200, n_layers=8, num_freq_bands=2, out_dim=3),
     4 * 4 * 200 * 256, 1000),
    (dict(lat_dim=0, hidden_dim=32, n_layers=4, out_dim=2, beta=0.0), None, 1000),
    (dict(lat_dim=24, hidden_dim=200, n_layers=6, out_dim=1), None, 77),
    (dict(lat_dim=8, hidden_dim=72, n_layers=8, num_freq_bands=1, out_dim=4),
     4 * 4 * 72 * 384, 1000),
    (dict(lat_dim=40, hidden_dim=300, n_layers=5, out_dim=2), None, 333),
])
def test_k7_tiny_widths(device, monkeypatch, kw, scratch, n):
    """K7 vs its plain version: conditioned and unconditioned trunks, a
    positional encoding, hidden widths that are not multiples of the
    128-output tile or the 32-wide K slice (200, 72, 300, and the skip
    layer's input), 1-4 outputs, ReLU, and point counts that are not
    multiples of the 128-point tile, in one chunk or (a scratch of a few
    hundred points) several."""
    if scratch is not None:
        monkeypatch.setattr(trunk, "SCRATCH_BYTES", scratch)
    cfg = DeepSDFConfig(**kw)
    gen = torch.Generator().manual_seed(0)
    params = make_npm_decoder(cfg).init(gen, device)
    xyz = (torch.randn((n, 3), generator=gen) * 0.4).to(device)
    cond = (torch.randn(cfg.lat_dim, generator=gen) * 0.1).to(device) if cfg.lat_dim else None
    before = trunk.deepsdf_trunk.launches
    out = trunk.deepsdf_trunk(params, cfg, xyz, cond)
    torch.cuda.synchronize()
    assert trunk.deepsdf_trunk.launches == before + 1
    ref = trunk.deepsdf_trunk_plain(params, cfg, xyz, cond)
    assert out.shape == ref.shape == (n, cfg.out_dim)
    torch.testing.assert_close(out, ref, atol=1e-4 * float(ref.abs().max()), rtol=0)


def test_k7_posing_matches_cpu(device):
    """deform_mesh_batch through K7 on the card vs the plain chunked decoder
    on the CPU, for the compress-mode field."""
    from nphm_tpu_torch.reconstruction.extract import deform_mesh_batch
    from nphm_tpu_torch.utils.mesh_io import Mesh
    from nphm_tpu_torch.utils.params import tree_to

    shape, ps, expr, pe, gen = tiny_models(device)
    rng = np.random.default_rng(1)
    mesh = Mesh((rng.normal(size=(3000, 3)) * 0.3).astype(np.float32),
                np.zeros((0, 3), np.int64))
    lat_s = (rng.normal(size=(1, shape.lat_dim)) * 0.1).astype(np.float32)
    lat_e = (rng.normal(size=(2, expr.lat_dim)) * 0.1).astype(np.float32)
    anchors = (rng.normal(size=(39, 3)) * 0.3).astype(np.float32)
    before = trunk.deepsdf_trunk.launches
    gpu = deform_mesh_batch(mesh, expr, pe, lat_e, anchors=anchors, lat_shape=lat_s,
                            device=device)
    assert trunk.deepsdf_trunk.launches == before + 2
    cpu = deform_mesh_batch(mesh, expr, tree_to(pe, "cpu"), lat_e, anchors=anchors,
                            lat_shape=lat_s, device="cpu")
    for a, b in zip(gpu, cpu):
        np.testing.assert_allclose(a.vertices, b.vertices, atol=1e-5)


def test_k2_refuses_npm_offsets_trunk(device):
    """fused_search="on" with the 8x1024 NPM offsets trunk: K2 needs 267,264
    bytes of shared memory, the launch is refused and raises (no fallback),
    and the next launch is unaffected."""
    from nphm_tpu_torch.config import build_expression_decoder, load_yaml

    expr = build_expression_decoder(
        load_yaml(os.path.join(ROOT, "configs", "npm_def.yaml")), "npm")
    gen = torch.Generator().manual_seed(0)
    params = expr.init(gen, device)
    obs = (torch.randn((1, 64, 3), generator=gen) * 0.3).to(device)
    cond = torch.zeros((1, expr.cfg.lat_dim), device=device)
    eye = torch.eye(3, device=device).expand(1, 64, 3, 3).contiguous()
    before = srch.broyden_search.launches
    with pytest.raises(RuntimeError, match="nphm_broyden_search"):
        srch.broyden_search(params, expr.cfg, cond, obs, obs, eye, 3)
    assert srch.broyden_search.launches == before
    out = trunk.deepsdf_trunk(params, expr.cfg, obs[0], cond[0])
    torch.cuda.synchronize()
    torch.testing.assert_close(out, trunk.deepsdf_trunk_plain(params, expr.cfg, obs[0],
                                                              cond[0]),
                               atol=1e-4 * float(out.abs().max()), rtol=0)


def test_production_dims(device):
    """chip_smoke.py's phase 3: every kernel at the main path's shapes."""
    c = smoke()
    models = c.build_models(device)
    rows = c.kernel_checks(models, c.build_npm_models(device), device)
    assert set(rows) == {"ensemble_sdf", "broyden_search", "fit_fwd", "fit_bwd",
                         "train_fwd", "train_bwd", "deepsdf_trunk"}
