"""Host side of K3-K6's routes at the lower precisions, on the CPU.

The kernels themselves run only on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py`` phase 14); what the wrappers prepare for them is checked
here: the hidden weights rounded once per call for the bf16 MMAs
(bit-equal to ``precision.bf16_round``, in the K order their fragments
read), each kernel's route at each precision (TF32 rounds per fragment,
BF16 runs bf16 MMAs), each backward launching over its forward's trunk,
the launches' shared memory against the card's opt-in limit, and the
bytes K6's scratch moves.
"""

import os
import re

import numpy as np
import pytest
import torch

from nphm_tpu_torch.config import load_yaml, nphm_config_from_yaml
from nphm_tpu_torch.models import NPHMConfig, make_nphm_decoder
from nphm_tpu_torch.ops import fit_fields as ff
from nphm_tpu_torch.ops import precision
from nphm_tpu_torch.ops import train_fields as trf
from nphm_tpu_torch.ops.fit_fields import Route
from nphm_tpu_torch.ops.precision import Precision

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(lat_dim_glob=8, lat_dim_loc=4, n_loc=6, n_symm_pairs=2, hidden_dim=36,
            n_layers=4, pos_mlp_dim=16)


def nphm_cfg():
    return nphm_config_from_yaml(load_yaml(os.path.join(ROOT, "configs", "nphm.yaml"))["decoder"])


def tiny_layers(seed=0):
    rng = np.random.default_rng(seed)
    anchors = (rng.normal(size=(TINY["n_loc"], 3)) * 0.25).astype(np.float32)
    dec = make_nphm_decoder(NPHMConfig(**TINY), anchors)
    params = dec.init(torch.Generator().manual_seed(seed), "cpu")
    lat = torch.tensor(rng.normal(size=(2, dec.lat_dim)).astype(np.float32)) * 0.1
    layers, _ = ff.prepare_train_operands(params, dec.cfg, lat)
    return dec.cfg, layers


def unpermute(w):
    """A BF16_MMA weight row back in K order."""
    k = w.shape[-1]
    inv = np.argsort(ff.K_PERM)
    return w.reshape(*w.shape[:-1], k // 16, 16)[..., inv].reshape(w.shape)


def test_bf16_round_is_the_integer_rounding():
    """precision.bf16_round (torch's bf16 cast) equals the integer form of
    round-to-nearest-even bit for bit: ties both ways, subnormals, the
    largest finite values (which round to infinity) and infinities."""
    rng = np.random.default_rng(3)
    bits = np.concatenate([
        rng.integers(0, 2**31 - 2**23, size=20000, dtype=np.int64),  # finite magnitudes
        np.arange(0x3F80_0000, 0x3F80_0000 + 2**17, 0x4000),  # around ties of 1.0
        [0x3F80_8000, 0x3F81_8000, 0x0000_8000, 0x0001_8000, 0x7F7F_FFFF, 0x7F7F_7FFF,
         0x7F80_0000, 0x0000_0001, 0x0080_0000],
    ]).astype(np.int64)
    bits = np.concatenate([bits, bits | (1 << 31)]).astype(np.uint32).view(np.int32)
    x = torch.from_numpy(bits).view(torch.float32)
    b = x.view(torch.int32)
    ref = ((b + (0x7FFF + ((b >> 16) & 1))) & -0x10000).view(torch.float32)
    assert torch.equal(precision.bf16_round(x).view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("k", [16, 112, 208])
def test_route_weights_round_once_bit_equal(k):
    """route_weights at BF16_MMA is bf16_round in K_PERM order (bf16 bits
    equal), at every other route the weights as given."""
    rng = np.random.default_rng(k)
    w = torch.tensor(rng.normal(size=(3, 5, k)).astype(np.float32)) * 7.0
    w[..., -3:] = 0.0  # zero columns past a width
    w[0, 0, :4] = torch.tensor([1.0 + 2**-8, 1.0 + 3 * 2**-8, -(2**-133), 3.4e38])  # ties, tiny, big
    wb = ff.route_weights(w, Route.BF16_MMA)
    assert wb.dtype == torch.bfloat16 and wb.shape == w.shape and wb.is_contiguous()
    ref = precision.bf16_round(w)
    assert torch.equal(unpermute(wb).float().view(torch.int32), ref.view(torch.int32))
    for r in (Route.F32, Route.TF32):
        assert ff.route_weights(w, r) is w


def test_k_perm_is_the_fragment_order():
    """K_PERM mirrors csrc/tc_tile.cuh kPerm, and it is the K order of the
    A fragment that kBF16Mma packs from two fp32 ldmatrix x4 loads: lane
    (g, t) holds K t and 4 + t of the first 8 columns, 8 + t and 12 + t of
    the next, at m16n8k16 positions 2t, 2t + 1, 2t + 8, 2t + 9."""
    src = open(os.path.join(ROOT, "nphm_tpu_torch", "csrc", "tc_tile.cuh")).read()
    body = re.search(r"constexpr int kPerm\(int s\) \{\s*return ([^;]+);", src).group(1)
    assert tuple(eval(body, {"s": s}) for s in range(16)) == ff.K_PERM  # noqa: S307
    for t in range(4):
        assert (ff.K_PERM[2 * t], ff.K_PERM[2 * t + 1]) == (t, 4 + t)
        assert (ff.K_PERM[2 * t + 8], ff.K_PERM[2 * t + 9]) == (8 + t, 12 + t)
    # a product over permuted K is the same sum of the same products
    rng = np.random.default_rng(1)
    a = torch.tensor(rng.normal(size=(4, 32)).astype(np.float32))
    w = torch.tensor(rng.normal(size=(6, 32)).astype(np.float32))
    wp = ff.route_weights(w, Route.BF16_MMA).float()
    ap = a.reshape(4, 2, 16)[..., list(ff.K_PERM)].reshape(4, 32)
    torch.testing.assert_close(ap @ wp.T, a @ precision.bf16_round(w).T, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("prec", list(Precision))
def test_routes_k4_k5_keep_per_fragment_rounding(prec):
    """K3-K6 share one route at each precision: 3xTF32 at F32, one TF32
    pass on operands rounded per fragment at TF32 (the only per-fragment
    rounding left), bf16 MMAs on bf16 weights at BF16, K4 and K5 included
    (no route rounds to bf16 per fragment any more)."""
    want = {Precision.F32: Route.F32, Precision.TF32: Route.TF32,
            Precision.BF16: Route.BF16_MMA}[prec]
    assert set(ff.ROUTES) == {"fit_fwd", "fit_bwd", "train_fwd", "train_bwd"}
    for kernel in ff.ROUTES:
        assert ff.ROUTES[kernel][prec] == want
    assert sorted(r.name for r in Route) == ["BF16_MMA", "F32", "TF32"]


@pytest.mark.parametrize("prec", list(Precision))
def test_each_kernel_gets_its_routes_weights(prec):
    """The trunk each kernel launches over at its route: the fp32 layout of
    test_torch_fit_fields at F32 and TF32, bf16 in K_PERM order padded to
    K steps of 16 at BF16; a forward and its backward read the same
    weights."""
    cfg, layers = tiny_layers()
    wd = layers[1]["w"]  # [A, out, in]
    ref = ff._fit_trunk(cfg, layers, 2, 128)
    for kernel in ff.ROUTES:
        route = ff.ROUTES[kernel][prec]
        _tr, keep, _, _ = ff._fit_trunk(cfg, layers, 2, 128, route)
        wt = keep[2]  # layer 1's forward weights [A, out, ldwt]
        if route == Route.BF16_MMA:
            assert wt.dtype == torch.bfloat16 and wt.shape[-1] == 48  # 36 to K steps of 16
            assert torch.equal(unpermute(wt)[..., : wd.shape[2]].float(),
                               precision.bf16_round(wd))
        else:
            assert all(a.dtype == torch.float32 and torch.equal(a, b)
                       for a, b in zip(keep, ref[1]))
    for fwd, bwd in (("fit_fwd", "fit_bwd"), ("train_fwd", "train_bwd")):
        assert ff.ROUTES[fwd][prec] == ff.ROUTES[bwd][prec]


class _FakeLib:
    """Stands in for the kernel library on the CPU: records the trunk and
    route of each launch and returns success, writing nothing."""

    def __init__(self):
        self.calls = []

    def _record(self, name):
        def entry(tr, *args):
            t = tr._obj
            ptrs = tuple(t.w[i] for i in range(t.n_layers)) + tuple(
                t.wt[i] for i in range(t.n_layers))
            self.calls.append((name, id(t), ptrs, args[-2]))
            return 0
        return entry

    def __getattr__(self, name):
        if name == "nphm_train_split_k":
            return lambda: 32
        return self._record(name)


def fake_launches(monkeypatch):
    """Route the wrappers' launches to a _FakeLib on CPU tensors, and count
    route_weights calls."""
    lib = _FakeLib()
    monkeypatch.setattr(ff._build, "lib", lambda: lib)
    monkeypatch.setattr(ff._build, "require_cuda_f32", lambda *a, **k: None)
    monkeypatch.setattr(ff._build, "require_mask", lambda *a, **k: None)
    monkeypatch.setattr(ff._build, "stream_ptr", lambda dev: 0)
    rounds = []
    real = ff.route_weights

    def counted(w, route):
        rounds.append(route)
        return real(w, route)

    monkeypatch.setattr(ff, "route_weights", counted)
    return lib, rounds


@pytest.mark.parametrize("prec", list(Precision))
def test_backward_launches_over_its_forwards_trunk(monkeypatch, prec):
    """K4 launches over the very trunk (the same descriptor and weight
    tensors) that K3 launched over, and K6 over K5's, at every precision:
    the backward builds no trunk and rounds no weight again."""
    lib, rounds = fake_launches(monkeypatch)
    cfg, layers = tiny_layers()
    A, B, tile = cfg.n_members, 2, 128
    _, skip = cfg.layer_shapes
    coords = torch.randn((A, 3, B * tile), generator=torch.Generator().manual_seed(1))
    active = torch.ones((B, A), dtype=torch.int32)
    name = {Precision.F32: "default", Precision.TF32: "high", Precision.BF16: "bfloat16"}[prec]
    with precision.matmul_precision(name):
        ins = [layers[0]["b"].clone().requires_grad_(True),
               layers[skip]["b"].clone().requires_grad_(True),
               coords.clone().requires_grad_(True)]
        F = ff._MemberF.apply(*ins, cfg, layers, active, tile, B)
        n_fwd = len(rounds)
        torch.autograd.grad(F.sum(), ins)
        flat = [t.clone().requires_grad_(True) for t in trf._flat(cfg, layers)]
        x = coords.clone().requires_grad_(True)
        F, G = trf._MemberFields.apply(cfg, active, tile, B, x, *flat)
        n_train = len(rounds)
        torch.autograd.grad(F.sum() + G.sum(), flat + [x])
    # both orientations of each hidden layer once per forward, none in a backward
    n_hidden = len(layers) - 2
    assert n_fwd == n_train - n_fwd == 2 * n_hidden and len(rounds) == n_train
    assert [c[0] for c in lib.calls] == ["nphm_fit_fwd", "nphm_fit_bwd", "nphm_train_fwd",
                                         "nphm_train_bwd"]
    route = int(ff.ROUTES["fit_fwd"][prec])
    for fwd, bwd in ((lib.calls[0], lib.calls[1]), (lib.calls[2], lib.calls[3])):
        assert fwd[1] == bwd[1] and fwd[2] == bwd[2]  # one descriptor, the same tensors
        assert fwd[3] == bwd[3] == route


def test_launch_shared_memory_fits_the_card():
    """No K3-K6 instantiation the routes launch needs more shared memory
    than a Hopper block may opt into (232,448 bytes), at the NPHM widths;
    the bf16 contraction's ring is smaller than the fp32 one, and the
    passes take the same shared memory at every route (activation rows pad
    to 8, bf16 ring slices hold twice the K in the same bytes)."""
    cfg = nphm_cfg()
    for kernel, key in (("fit_fwd", "fit_fwd"), ("fit_bwd", "fit_bwd"),
                        ("train_fwd", "train_fwd"), ("train_bwd", "train_bwd"),
                        ("lane_contract", "train_bwd")):
        for prec in Precision:
            b = ff.smem_bytes(kernel, cfg, ff.ROUTES[key][prec])
            assert 0 < b <= ff.SMEM_OPTIN == 232_448, (kernel, prec, b)
    assert ff.smem_bytes("lane_contract", cfg, Route.BF16_MMA) < ff.smem_bytes(
        "lane_contract", cfg, Route.F32)
    for kernel in ("fit_fwd", "fit_bwd", "train_fwd", "train_bwd"):
        assert ff.smem_bytes(kernel, cfg, Route.BF16_MMA) == ff.smem_bytes(kernel, cfg, Route.F32)


def test_k6_scratch_traffic_per_precision():
    """K6's scratch bytes at the training batch (one member, 32 x 2048
    lanes): the fp32 layout at F32 and TF32, the [zbar | pbar] rows at half
    the bytes at BF16."""
    cfg = nphm_cfg()
    M = 32 * 2048
    hq, zp = 200 + 101 + 200 + 200, 101 + 200 + 200
    f32 = trf.scratch_traffic(cfg, M, Precision.F32)
    assert f32 == 4 * 2 * M * (3 * hq + 2 * zp) == trf.scratch_traffic(cfg, M, Precision.TF32)
    assert trf.scratch_traffic(cfg, M, Precision.BF16) == 4 * 2 * M * (3 * hq + zp)


def test_phase_probe_copy_and_slots(tmp_path):
    """kernel_ab --kernels phases builds a copy of a checkout with
    NPHM_PHASE_CLOCKS defined and no build carried over, leaves the
    checkout itself as it was, and reads the phases in field::tile's order
    and the slots tc_tile.cuh writes the slice waits and the block count
    to."""
    from nphm_tpu_torch import kernel_ab

    src = tmp_path / "root"
    (src / "nphm_tpu_torch" / "csrc").mkdir(parents=True)
    (src / "nphm_tpu_torch" / "_build").mkdir()
    header = open(os.path.join(ROOT, "nphm_tpu_torch", "csrc", "tc_tile.cuh")).read()
    (src / "nphm_tpu_torch" / "csrc" / "tc_tile.cuh").write_text(header)
    dst = kernel_ab.phase_clock_copy(str(src), str(tmp_path / "copy"))
    copied = open(os.path.join(dst, "nphm_tpu_torch", "csrc", "tc_tile.cuh")).read()
    assert copied == "#define NPHM_PHASE_CLOCKS 1\n" + header
    assert (src / "nphm_tpu_torch" / "csrc" / "tc_tile.cuh").read_text() == header
    assert not os.path.exists(os.path.join(dst, "nphm_tpu_torch", "_build"))
    tile = open(os.path.join(ROOT, "nphm_tpu_torch", "csrc", "field_tile.cuh")).read()
    names = re.search(r"enum \{ (kSetup[^}]*) \};", tile).group(1).split(", ")
    snake = [re.sub(r"(?<!^)([A-Z])", r"_\1", n[1:]).lower() for n in names]
    body = kernel_ab.KERNELS["phases"][0]
    probe = eval(re.search(r"PHASES = (\([^)]*\))", body, re.S).group(1))  # noqa: S307
    assert tuple(snake) == probe
    slots = dict(re.findall(r"constexpr int (k\w+Slots?) = (\d+);", header))
    assert slots == {"kPhaseSlots": "16", "kRingWaitSlot": "14", "kBlockSlot": "15"}
    assert "out[14]" in body and "out[15]" in body and len(probe) < 14

