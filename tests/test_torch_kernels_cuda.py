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


def k2_case(device, hidden, n_layers, B, N, gain=1.0):
    """A deformation trunk of the given width and depth (the tiny NPHM's
    anchors), its offset head scaled by ``gain``, and search inputs.  Below
    hidden 20 the latents shrink to 4 + 4, so that the layer before the
    skip (hidden - d_in wide) keeps a positive width (5 at hidden 16)."""
    shape, ps, _e, _pe, gen = tiny_models(device)
    kw = dict(TINY_DEF, hidden_dim=hidden, n_layers=n_layers)
    if hidden < 20:
        kw.update(lat_dim_expr=4, lat_dim_id=4)
    expr = make_deformation_decoder(DeformationConfig(**kw))
    pe = expr.init(gen, device)
    obs, cond, eye = smoke().search_inputs(shape, ps, expr, pe, gen, device, B, N)
    head = pe["trunk"]["layers"][-1]
    trunk = {"layers": pe["trunk"]["layers"][:-1] + [{k: v * gain for k, v in head.items()}]}
    return trunk, expr.cfg.trunk_cfg, cond, obs, eye


def assert_k2_matches(k, p, n_lanes):
    """chip_smoke.py's K2 gates: roots and best residuals 1e-4 and J^-1
    1e-2 on the lanes valid in both, n_valid within 0.5% of the lanes,
    executed iterations within one (a lane next to the 1e-6 threshold may
    cross it an iteration apart)."""
    both = k["valid_ids"] & p["valid_ids"]
    if both.any():
        for key, tol in (("result", 1e-4), ("diff", 1e-4), ("j_inv", 1e-2)):
            assert float((k[key] - p[key]).abs()[both].max()) <= tol, key
    assert abs(int(k["valid_ids"].sum()) - int(p["valid_ids"].sum())) <= 0.005 * n_lanes
    assert abs(int(k["iters"]) - int(p["iters"])) <= 1
    assert bool(torch.isfinite(k["diff"]).all())


@pytest.mark.parametrize("B,N", [(1, 1), (1, 31), (1, 33), (1, 63), (1, 65), (5, 1000)])
def test_k2_lane_counts(device, B, N):
    """K2 at lane counts around its 32-lane tile (padding lanes never
    active) and at the fit's 5 x 1000, cold and warm."""
    trunk, tcfg, cond, obs, eye = k2_case(device, 72, 4, B, N)
    before = srch.broyden_search.launches
    x0, j0 = obs, eye
    for budget in (15, 3):
        k = srch.broyden_search(trunk, tcfg, cond, obs, x0, j0, budget)
        p = srch.broyden_search_plain(trunk, tcfg, cond, obs, x0, j0, budget)
        assert k["tile_iters"].shape == (-(-B * N // srch.TILE),)
        assert_k2_matches(k, p, B * N)
        x0, j0 = p["result"], p["j_inv"]
    assert srch.broyden_search.launches == before + 2


@pytest.mark.parametrize("hidden,n_layers", [(16, 4), (72, 4), (512, 6)])
@pytest.mark.parametrize("gain", [1.0, 90.0])
def test_k2_widths_and_hard_trunk(device, hidden, n_layers, gain):
    """K2 at hidden widths 16 (two n8 tiles, the layer before the skip 5
    wide), 72 (not a multiple of 16) and 512 (two 256-wide halves, the
    layer before the skip 512 - d_in wide), on the random-init trunk and
    with the offset head
    scaled 90x (many lanes diverge, the rest need many iterations), budget
    15 cold then 3 warm; two calls are bit-identical."""
    trunk, tcfg, cond, obs, eye = k2_case(device, hidden, n_layers, 5, 1000, gain)
    x0, j0 = obs, eye
    for budget in (15, 3):
        k = srch.broyden_search(trunk, tcfg, cond, obs, x0, j0, budget)
        again = srch.broyden_search(trunk, tcfg, cond, obs, x0, j0, budget)
        assert all(torch.equal(k[key], again[key]) for key in k)
        p = srch.broyden_search_plain(trunk, tcfg, cond, obs, x0, j0, budget)
        assert_k2_matches(k, p, 5000)
        x0, j0 = p["result"], p["j_inv"]


@pytest.mark.parametrize("hidden", [16, 72, 200])
def test_k1_work_list_edges(device, monkeypatch, hidden):
    """K1 over 5000 points (not a multiple of the 1024-point cull tile)
    with a cull mask holding an all-culled tile, a tile with one live
    member, one with the first and last, a fully live one and the real
    mask's last tile, at hidden widths 16, 72 and 200; the kernel matches
    the plain version and two calls are bit-identical."""
    shape, params, gen = tiny_shape(device, hidden)
    lat = (torch.randn(shape.lat_dim, generator=gen) * 0.1).to(device)
    pts = (torch.rand((5000, 3), generator=gen) - 0.5).to(device)
    real = ens.cull_mask

    def mask(points, centers, var, tile, cull_eps):
        a = real(points, centers, var, tile, cull_eps)
        a[:4] = 0
        a[1, 5] = 1
        a[2, 0] = a[2, -1] = 1
        a[3] = 1
        return a

    monkeypatch.setattr(ens, "cull_mask", mask)
    before = ens.nphm_sdf.launches
    out = ens.nphm_sdf(params, shape.cfg, pts, lat, tile=1024)
    again = ens.nphm_sdf(params, shape.cfg, pts, lat, tile=1024)
    assert ens.nphm_sdf.launches == before + 2
    assert torch.equal(out, again)
    ref = ens.nphm_sdf_plain(params, shape.cfg, pts, lat, tile=1024)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    bg = torch.tensor(float(np.exp(shape.cfg.blend_background_dist / shape.cfg.blend_var)),
                      device=device)
    assert torch.all(out[:1024] == bg / (bg + 1e-6))  # the culled tile: background only


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


@pytest.mark.parametrize("hidden,n_pts", [(16, 700), (36, 1000), (72, 1000), (200, 700),
                                          (200, 1000)])
@pytest.mark.parametrize("cull_eps", [0.0, 1e-10])
def test_k5_k6_tiny_widths(device, hidden, n_pts, cull_eps):
    """apply_nphm_train through K5/K6 vs its plain version: outputs and the
    gradient of a loss over (sdf, grads) w.r.t. params, lat and xyz, at
    hidden widths that are not multiples of the 16-wide K slice of K5's and
    K6's passes or of their 8-wide MMA tiles (36 and the layer before the
    skip are not even multiples of 8), of K6's 64-row contraction tiles or
    its 32-lane slices, and rows of points that are not multiples of the
    64-point tile (padded inside the 512-point cull tile)."""
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


def k6_case(device, hidden, cull_eps, B=3, n_pts=1000, tile=512):
    """Member-fields inputs as apply_nphm_train builds them, with random
    cotangents (dF, dG): (cfg, flat operands, coords, active, tile, B, dF, dG)."""
    shape, params, gen = tiny_shape(device, hidden)
    cfg = shape.cfg
    xyz = (torch.randn((B, n_pts, 3), generator=gen) * 0.3).to(device)
    if cull_eps > 0:
        perm = torch.argsort(ff.morton_codes(xyz), dim=1, stable=True)
        xyz = torch.gather(xyz, 1, perm[..., None].expand(B, n_pts, 3))
    Np = -(-n_pts // tile) * tile
    xyz = torch.cat([xyz, xyz[:, -1:].expand(B, Np - n_pts, 3)], dim=1)
    lat = (torch.randn((B, shape.lat_dim), generator=gen) * 0.1).to(device)
    with torch.no_grad():
        anchors = predict_anchors(params, cfg, lat)
        centers = torch.cat([anchors, torch.zeros_like(anchors[:, :1])], dim=1)
        coords = (xyz[:, :, None] - centers[:, None]) * mirror_scale(cfg, device)
        coords = coords.permute(2, 3, 0, 1).reshape(cfg.n_members, 3, -1).contiguous()
        layers, _ = ff.prepare_train_operands(params, cfg, lat)
        active = ff.active_mask(cfg, coords, tile, cull_eps)
    flat = [t.detach().clone().requires_grad_(True) for t in trf._flat(cfg, layers)]
    coords.requires_grad_(True)
    dF = torch.randn(coords[:, 0].shape, generator=gen).to(device)
    dG = torch.randn(coords.shape, generator=gen).to(device)
    return cfg, flat, coords, active, tile, B, dF, dG


def k6_grads(fn, cfg, flat, coords, active, tile, B, dF, dG):
    """d(<dF, F> + <dG, G>) w.r.t. every operand and the coordinates."""
    F, G = fn(cfg, trf._unflat(cfg, flat), coords, active, tile, B)
    return torch.autograd.grad((F * dF).sum() + (G * dG).sum(), flat + [coords])


def test_k6_member_chunks(device, monkeypatch):
    """K6 with its scratch budget cut to one member a chunk (39 + 1 chunks)
    gives the gradients of one chunk bit for bit (each member's sums have
    the same fixed order), and both match the plain version."""
    case = k6_case(device, 200, 1e-10)
    whole = k6_grads(trf.member_fields, *case)
    before = trf.member_fields.bwd_launches
    monkeypatch.setattr(trf, "SCRATCH_BYTES", 1)
    chunked = k6_grads(trf.member_fields, *case)
    assert trf.member_fields.bwd_launches == before + 1
    plain = k6_grads(trf.member_fields_plain, *case)
    for a, b, p in zip(whole, chunked, plain):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, p, atol=1e-4 * float(p.abs().max()), rtol=0)


@pytest.mark.parametrize("cull_eps", [0.0, 1e-10])
def test_k6_is_bit_identical_run_to_run(device, cull_eps):
    """Two K6 calls on the same inputs give the same gradients bit for bit:
    no float atomics, every sum in a fixed order."""
    case = k6_case(device, 200, cull_eps, B=4)
    first = k6_grads(trf.member_fields, *case)
    for _ in range(2):
        again = k6_grads(trf.member_fields, *case)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


# K3 and K6 at the lower precisions against their plain versions at the
# same precision, relative to the plain output's magnitude (chip_smoke.py's
# TOL_LOW): both round the same operands and sum in other orders.
LOW_TOL = {"high": 1e-3, "bfloat16": 1e-2}


def low_rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def k3_low_case(device, hidden, n_pts, B=3, tile=512):
    """K3's inputs as apply_nphm_fit builds them (Morton-sorted, culled at
    1e-10): (cfg, layers, coords, active, tile, B)."""
    shape, params, gen = tiny_shape(device, hidden)
    cfg = shape.cfg
    xyz = (torch.randn((B, n_pts, 3), generator=gen) * 0.3).to(device)
    perm = torch.argsort(ff.morton_codes(xyz), dim=1, stable=True)
    xyz = torch.gather(xyz, 1, perm[..., None].expand(B, n_pts, 3))
    Np = -(-n_pts // tile) * tile
    xyz = torch.cat([xyz, xyz[:, -1:].expand(B, Np - n_pts, 3)], dim=1)
    lat = (torch.randn((B, shape.lat_dim), generator=gen) * 0.1).to(device)
    with torch.no_grad():
        anchors = predict_anchors(params, cfg, lat)
        centers = torch.cat([anchors, torch.zeros_like(anchors[:, :1])], dim=1)
        coords = (xyz[:, :, None] - centers[:, None]) * mirror_scale(cfg, device)
        coords = coords.permute(2, 3, 0, 1).reshape(cfg.n_members, 3, -1).contiguous()
        layers, _ = ff.prepare_train_operands(params, cfg, lat)
        active = ff.active_mask(cfg, coords, tile, 1e-10)
    return cfg, layers, coords, active, tile, B


@pytest.mark.parametrize("hidden,n_pts", [(16, 700), (36, 1000), (200, 700)])
def test_k3_bf16_against_its_twin(device, hidden, n_pts):
    """K3 at BF16 (bf16 weights rounded once per call, one m16n8k16 .bf16 MMA
    a step) against member_f_plain at BF16, at hidden widths that are not
    multiples of 16 (36, 200; the layer before the skip is narrower still):
    within LOW_TOL, nearer its twin than the F32 kernel's output, two calls
    bit-identical, and the BF16 instantiation launched."""
    from nphm_tpu_torch.ops import precision

    cfg, layers, coords, active, tile, B = k3_low_case(device, hidden, n_pts)
    with precision.matmul_precision("bfloat16"):
        before = ff.member_f.launches_at[precision.Precision.BF16]
        with torch.no_grad():
            runs = [ff.member_f(cfg, layers, coords, active, tile, B) for _ in range(2)]
        assert ff.member_f.launches_at[precision.Precision.BF16] == before + 2
        plain = ff.member_f_plain(cfg, layers, coords, active, tile, B)
    with torch.no_grad():
        f32 = ff.member_f(cfg, layers, coords, active, tile, B)
    assert torch.isfinite(runs[0]).all()
    assert torch.equal(runs[0], runs[1])
    err = low_rel(runs[0], plain)
    assert err <= LOW_TOL["bfloat16"]
    assert float((runs[0] - plain).abs().max()) < float((f32 - plain).abs().max())


@pytest.mark.parametrize("hidden,cull_eps", [(16, 0.0), (36, 1e-10), (200, 0.0),
                                             (200, 1e-10)])
def test_k4_k5_bf16_against_their_twins(device, hidden, cull_eps):
    """K4 and K5 at BF16 (bf16 weights rounded once per call, one m16n8k16
    .bf16 MMA a step in the forward and the reverse sweep) against their
    plain versions at BF16, at tiny and production hidden widths (36 and
    the layer before the skip are not multiples of 16), with and without
    culled pairs: K4's cotangents of the two folded biases and the
    coordinates, K5's F and G, each within LOW_TOL of its twin's magnitude
    and nearer its twin than the F32 kernel's output, two calls
    bit-identical, and the BF16 instantiations launched."""
    from nphm_tpu_torch.ops import precision

    bf16 = precision.Precision.BF16
    cfg, flat, coords, active, tile, B, dF, _dG = k6_case(device, hidden, cull_eps)
    layers = trf._unflat(cfg, [t.detach() for t in flat])
    _, skip = cfg.layer_shapes
    ins = [layers[0]["b"].clone().requires_grad_(True),
           layers[skip]["b"].clone().requires_grad_(True),
           coords.detach().clone().requires_grad_(True)]
    lay = [dict(lay) for lay in layers]
    lay[0]["b"], lay[skip]["b"] = ins[0], ins[1]

    def k4(fn):
        F = fn(cfg, lay, ins[2], active, tile, B)
        return torch.autograd.grad(F, ins, dF)

    def k5(fn):
        with torch.no_grad():
            return tuple(t.detach() for t in fn(cfg, layers, coords.detach(), active, tile, B))

    with precision.matmul_precision("bfloat16"):
        before = (ff.member_f.bwd_launches_at[bf16], trf.member_fields.launches_at[bf16])
        runs4 = [k4(ff.member_f) for _ in range(2)]
        runs5 = [k5(trf.member_fields) for _ in range(2)]
        assert (ff.member_f.bwd_launches_at[bf16],
                trf.member_fields.launches_at[bf16]) == (before[0] + 2, before[1] + 2)
        plain4 = k4(ff.member_f_plain)
        plain5 = trf.member_fields_plain(cfg, layers, coords.detach(), active, tile, B)
    f32 = k4(ff.member_f) + k5(trf.member_fields)
    for a, b in zip(runs4[0] + runs5[0], runs4[1] + runs5[1]):
        assert torch.equal(a, b)
    for k, p, c in zip(runs4[0] + runs5[0], plain4 + tuple(plain5), f32):
        p = p.detach()
        assert torch.isfinite(k).all()
        assert low_rel(k, p) <= LOW_TOL["bfloat16"]
        assert float((k - p).abs().max()) < float((c - p).abs().max())


@pytest.mark.parametrize("name", ["high", "bfloat16"])
@pytest.mark.parametrize("hidden,cull_eps", [(16, 0.0), (36, 1e-10), (200, 0.0)])
def test_k6_low_precision_against_its_twin(device, name, hidden, cull_eps):
    """K6 at TF32 (one TF32 pass, operands rounded per fragment) and at
    BF16 (bf16 weights, bf16 MMAs in its passes and its lane contraction,
    [zbar | pbar] rows stored in bf16)
    against the plain double backward at the same precision, at hidden
    widths that are not multiples of 16, with and without culled pairs:
    every gradient within LOW_TOL of its twin's magnitude and nearer its
    twin than the F32 kernel's, two calls bit-identical."""
    from nphm_tpu_torch.ops import precision

    case = k6_case(device, hidden, cull_eps)
    with precision.matmul_precision(name):
        runs = [k6_grads(trf.member_fields, *case) for _ in range(2)]
        plain = k6_grads(trf.member_fields_plain, *case)
    f32 = k6_grads(trf.member_fields, *case)
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    for k, p, c in zip(runs[0], plain, f32):
        assert torch.isfinite(k).all()
        assert low_rel(k, p) <= LOW_TOL[name]
        assert float((k - p).abs().max()) < float((c - p).abs().max())


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
    """fused_search="on" with the 8x1024 NPM offsets trunk: its layers are
    wider than K2's 512, the call is refused before any launch and raises
    (no fallback), and the next launch is unaffected."""
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
    """chip_smoke.py's phase 3: every kernel at the main path's shapes (and
    K1 at its res-256 launch), then phase 7's K2-K4 at the batched shapes."""
    c = smoke()
    models = c.build_models(device)
    rows = c.kernel_checks(models, c.build_npm_models(device), device)
    assert set(rows) == {"ensemble_sdf", "ensemble_sdf@res256", "broyden_search", "fit_fwd",
                         "fit_bwd", "train_fwd", "train_bwd", "deepsdf_trunk"}
    c.check_batched_kernels(models, device, rows)
    assert {"broyden_search@S8", "fit_fwd@S8", "fit_bwd@S8"} <= set(rows)
