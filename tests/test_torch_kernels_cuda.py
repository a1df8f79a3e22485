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
    DeformationConfig,
    NPHMConfig,
    make_deformation_decoder,
    make_nphm_decoder,
)
from nphm_tpu_torch.ops import ensemble as ens
from nphm_tpu_torch.ops import fit_fields as ff
from nphm_tpu_torch.ops import search as srch

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


def test_k3_k4_tiny_widths(device):
    shape, params, _e, _pe, gen = tiny_models(device)
    xyz = (torch.randn((3, 700, 3), generator=gen) * 0.3).to(device)
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


def test_production_dims(device):
    """chip_smoke.py's phase 3: every kernel at the main path's shapes."""
    c = smoke()
    models = c.build_models(device)
    rows = c.kernel_checks(models, device)
    assert set(rows) == {"ensemble_sdf", "broyden_search", "fit_fwd", "fit_bwd"}
