"""Forward, no-grad conditioned DeepSDF trunk: kernel K7
(``csrc/deepsdf_trunk.cu``) and its plain PyTorch version (counterpart of
``nphm_tpu/ops/pallas_mlp.py``).

The conditioning code is constant along points, so
``prepare_trunk_operands`` folds its layer-0 and skip-layer contributions
into biases and 1/sqrt(2) into the skip layer's weights, as the JAX package
does; the layout is the port's own (the JAX package's uniform ``[L, H,
H + ds]`` padding exists only for the TPU's layer-streamed grid).
Positional-encoding features are computed outside the kernel.

``deepsdf_trunk`` launches K7 for a CUDA tensor (one launch per layer and
point chunk; ``deepsdf_trunk.launches`` counts the calls that ran it) and
runs ``deepsdf_trunk_plain`` for a CPU tensor.  K7 multiplies on the tensor
cores in 3xTF32 (``ops/tf32.py``): the wrapper splits the hidden weights
into their TF32 halves once per call, K-major ``[out, in]``; the kernel
keeps activations point-major, each as its two halves.  Its wrappers:

- ``npm_sdf``: the NPM identity SDF over points;
- ``deformation``: eval-mode offsets of a ``DeformationConfig`` field
  (every mode with row-constant conditioning: all but ``interpolate``);
- ``npm_grid_sdf``: the dense NPM grid, points generated on the device in
  natural x-major order.
"""

from __future__ import annotations

import torch

from nphm_tpu_torch.models.deepsdf import DeepSDFConfig
from nphm_tpu_torch.models.deformation import DeformationConfig, conditioning
from nphm_tpu_torch.models.mlp import positional_encoding, softplus_beta
from nphm_tpu_torch.ops import _build
from nphm_tpu_torch.ops.tf32 import split_tf32
from nphm_tpu_torch.parallel.mesh import data_parallel, gather_rows, shard_rows

SQRT2 = 1.4142135623730951
# Activation scratch of one point chunk: the ping-pong of layer inputs and
# outputs, each a [chunk, hidden] fp32 buffer per TF32 half (four in all),
# stays within 2 GiB, i.e. 131072 points a chunk at hidden 1024 and 262144
# at hidden 512.
SCRATCH_BYTES = 1 << 31
# Leading dims of every matrix the kernel reads by TMA: rows of 16 bytes.
LD_ALIGN = 4
PLAIN_CHUNK_CPU = 1 << 16  # points of one CPU pass in deepsdf_trunk_plain


def prepare_trunk_operands(params, cfg: DeepSDFConfig, cond):
    """Per-layer operands with the conditioning cond [lat_dim] (or None when
    ``cfg.lat_dim == 0``) folded into biases.

    Returns a list of dicts: layer 0 {"wp" [H0, ds], "b" [H0]}; hidden
    {"w" [out, in], "b" [out]}; the skip layer {"w" [out, h], "wp" [out,
    ds], "b" [out]} with 1/sqrt(2) folded in; the head {"w" [out, in], "b"}.
    The fold is an elementwise product and a row sum, so the kernel path
    runs no library matrix product.
    """
    _shapes, skip_in = cfg.layer_shapes
    ds = cfg.d_in_spatial
    if cond is not None:
        cond = cond.reshape(cfg.lat_dim).to(torch.float32)
    layers = []
    for i, lay in enumerate(params["layers"]):
        w, b = lay["w"], lay["b"]
        if i == 0:
            if cond is not None:
                b = b + (w[:, ds:] * cond).sum(dim=1)
            layers.append({"wp": w[:, :ds], "b": b})
        elif i == skip_in:
            h = w.shape[1] - cfg.d_in
            if cond is not None:
                b = b + (w[:, h + ds :] * cond).sum(dim=1) / SQRT2
            layers.append({"w": w[:, :h] / SQRT2, "wp": w[:, h : h + ds] / SQRT2,
                           "b": b})
        else:
            layers.append({"w": w, "b": b})
    return layers


def _act(z, beta: float):
    return softplus_beta(z, beta) if beta > 0 else torch.relu(z)


@torch.no_grad()
def deepsdf_trunk_plain(params, cfg: DeepSDFConfig, xyz, cond=None):
    """Plain PyTorch version of K7: the same folded operands, ``torch.matmul``
    and softplus.  xyz [N, input_dim] -> [N, out_dim].  On the CPU the points
    go through in chunks of ``PLAIN_CHUNK_CPU``, whose activations stay in
    cache (a row's result does not depend on the chunk)."""
    pe = positional_encoding(xyz.to(torch.float32), cfg.num_freq_bands)
    layers = prepare_trunk_operands(params, cfg, cond)
    _shapes, skip_in = cfg.layer_shapes
    L = len(layers)

    def run(pe):
        h = None
        for i, lay in enumerate(layers):
            if i == 0:
                z = pe @ lay["wp"].T + lay["b"]
            elif i == skip_in:
                z = h @ lay["w"].T + pe @ lay["wp"].T + lay["b"]
            else:
                z = h @ lay["w"].T + lay["b"]
            if i < L - 1:
                h = _act(z, cfg.beta)
        return z

    if pe.is_cuda or pe.shape[0] <= PLAIN_CHUNK_CPU:
        return run(pe)
    return torch.cat([run(pe[s : s + PLAIN_CHUNK_CPU])
                      for s in range(0, pe.shape[0], PLAIN_CHUNK_CPU)])


def chunk_points(ldh: int, tile: int) -> int:
    """Points per chunk: the four [chunk, ldh] activation buffers within
    SCRATCH_BYTES."""
    return max(tile, SCRATCH_BYTES // (4 * 4 * ldh) // tile * tile)


def _kernel_layers(layers):
    """Kernel layouts: hidden weights K-major [out, in] with zero columns up
    to a multiple of LD_ALIGN, split into TF32 halves ``wb`` + ``ws``; point
    weights [out, ds]; the head [out, in] as is.  A K that is not a multiple
    of the kernel's 32-wide slice needs no padding beyond that: TMA reads
    zeros past the tensor map's K extent, for activations and weights alike."""
    ops = []
    for i, lay in enumerate(layers):
        n_out = lay["b"].shape[0]
        op = {"b": lay["b"].contiguous(), "n_out": n_out, "K": 0, "ldw": 0,
              "wb": None, "ws": None, "wp": None}
        if "w" in lay:
            op["K"] = lay["w"].shape[1]
            if i == len(layers) - 1:
                op["w"] = lay["w"].contiguous()
            else:
                op["ldw"] = _build.round_up(op["K"], LD_ALIGN)
                op["wb"], op["ws"] = split_tf32(_build.padded(lay["w"], op["ldw"]))
        if "wp" in lay:
            op["wp"] = lay["wp"].contiguous()
        ops.append(op)
    return ops


def _ptr(t):
    return None if t is None else t.data_ptr()


@torch.no_grad()
def deepsdf_trunk(params, cfg: DeepSDFConfig, xyz, cond=None):
    """Conditioned DeepSDF trunk at xyz [N, input_dim] -> [N, out_dim] fp32.

    cond: [lat_dim] row-constant conditioning, or None when ``cfg.lat_dim ==
    0``.  Matches ``apply_deepsdf`` up to summation order.
    """
    if not xyz.is_cuda:
        return deepsdf_trunk_plain(params, cfg, xyz, cond)
    if cfg.out_dim > _build.MAX_HEAD:
        raise ValueError(f"K7's head takes at most {_build.MAX_HEAD} outputs")
    lib = _build.lib()
    tile = lib.nphm_trunk_tile()
    ops = _kernel_layers(prepare_trunk_operands(params, cfg, cond))
    ds = cfg.d_in_spatial
    dev = xyz.device
    n = xyz.shape[0]
    ldh = _build.round_up(max(op["n_out"] for op in ops[:-1]), LD_ALIGN)
    m = min(chunk_points(ldh, tile), _build.round_up(max(n, 1), tile))
    pe = positional_encoding(xyz.to(torch.float32), cfg.num_freq_bands)
    # [half][points][features]: the TF32 halves of a layer's input or output
    bufs = [torch.empty((2, m, ldh), device=dev) for _ in range(2)]
    pe_c = torch.empty((m, ds), device=dev)
    _build.require_cuda_f32(pe_c, *bufs, *(t for op in ops for t in
                                          (op["b"], op["wb"], op["ws"], op["wp"],
                                           op.get("w")) if t is not None))
    out = torch.empty((n, cfg.out_dim), device=dev)
    stream = _build.stream_ptr(dev)
    L = len(ops)
    for s in range(0, n, m):
        c = min(m, n - s)
        P = _build.round_up(c, tile)
        pe_c[:c] = pe[s : s + c]
        pe_c[c:P] = 0.0
        for i, op in enumerate(ops[:-1]):
            x, o = bufs[(i + 1) % 2], bufs[i % 2]
            rc = lib.nphm_trunk_layer(
                _ptr(op["wb"]), _ptr(op["ws"]), op["ldw"], op["K"],
                x[0].data_ptr(), x[1].data_ptr(), ldh,
                _ptr(op["wp"]), ds if op["wp"] is not None else 0, pe_c.data_ptr(),
                op["b"].data_ptr(), o[0].data_ptr(), o[1].data_ptr(), ldh,
                op["n_out"], P, float(cfg.beta), stream,
            )
            _build.check(rc, f"nphm_trunk_layer (layer {i})")
        head, last = ops[-1], bufs[(L - 2) % 2]
        rc = lib.nphm_trunk_head(
            head["w"].data_ptr(), head["b"].data_ptr(), last[0].data_ptr(),
            last[1].data_ptr(), ldh, head["K"], out[s:].data_ptr(), cfg.out_dim, c,
            stream,
        )
        _build.check(rc, "nphm_trunk_head")
    deepsdf_trunk.launches += 1
    return out


deepsdf_trunk.launches = 0


def npm_sdf(params, cfg: DeepSDFConfig, xyz, lat, *, trunk_fn=deepsdf_trunk):
    """NPM identity SDF at xyz [N, 3] for one latent [lat_dim] -> [N]."""
    return trunk_fn(params, cfg, xyz, lat.reshape(cfg.lat_dim))[:, 0]


@torch.no_grad()
def deformation(params, dcfg: DeformationConfig, xyz, lat, anchors=None):
    """Eval-mode forward-deformation offsets [N, 3] at xyz [N, 3].

    lat: [lat_dim_shape_full + lat_dim_expr]; anchors [K, 3] (compress and
    GNN).  The conditioning is ``models.deformation.conditioning`` without
    noise, row-constant in every mode but ``interpolate``, for which it
    raises: that mode's per-point conditioning goes through the decoder's
    plain ``apply`` (``reconstruction.extract``), as in the JAX package.
    """
    anc = None if anchors is None else anchors.reshape(1, -1, 3)
    cond = conditioning(params, dcfg, lat.reshape(1, -1), anc)[0]
    return deepsdf_trunk(params["trunk"], dcfg.trunk_cfg, xyz, cond)[:, :3]


@torch.no_grad()
def npm_grid_sdf(params, cfg: DeepSDFConfig, lat, mini, maxi, res: int, *,
                 trunk_fn=deepsdf_trunk, device_mesh=None):
    """Dense-grid NPM SDF [res^3] in natural (x-major, z fastest) order, the
    points generated on the latent's device.  With a ``device_mesh`` each
    rank evaluates its block of the grid (K7) and every rank returns all of
    it."""
    dev = lat.device
    axes = [torch.linspace(float(mini[i]), float(maxi[i]), res, dtype=torch.float32,
                           device=dev) for i in range(3)]
    n = res * res * res
    own = shard_rows(n, device_mesh)
    lin = torch.arange(own.start, own.stop, dtype=torch.int64, device=dev)
    pts = torch.stack([axes[0][lin // (res * res)], axes[1][(lin // res) % res],
                       axes[2][lin % res]], dim=-1)
    sdf = npm_sdf(params, cfg, pts, lat, trunk_fn=trunk_fn)
    if data_parallel(device_mesh) is not None:
        sdf = gather_rows(sdf, n, device_mesh)
    return sdf
