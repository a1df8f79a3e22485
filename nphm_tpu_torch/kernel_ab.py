"""Time the fit kernels K3/K4, the training forward K5 or the training
backward K6 of two checkouts on one card, in turns.

    python3 -m nphm_tpu_torch.kernel_ab ROOT_A ROOT_B [--kernels fit|train|train_bwd]
        [--order ABBA]

Each turn runs in a fresh process from one checkout: that checkout's
``chip_smoke.py`` builds its kernels (``device_and_build``) and the NPHM
models (``build_models``), then

- ``--kernels fit`` (default): ``check_k3_k4``, K3 and K4 at the fit's
  shapes (M = 5 x 1024), each against its plain version, timed with CUDA
  events;
- ``--kernels train``: K5 alone at the training batch (B = 32 rows x 1693
  points, padded to 2048, no culling), through ``member_fields`` under
  ``no_grad``, held once against ``member_fields_plain`` and timed with
  CUDA events; no backward runs, so the turn stays far below the ~55 GiB
  peak of ``check_k5_k6``'s plain double backward;
- ``--kernels train_bwd``: K6 at the same shapes, one
  ``torch.autograd.grad`` of <dF, F> + <dG, G> through ``member_fields``
  (random dF, dG) w.r.t. every operand and the coordinates, timed with CUDA
  events; no plain version runs.

Its rows print as one ``ROWS {...}`` JSON line; the summary gives each
checkout's mean kernel times and the ratio A / B.  Comparing two versions is
only fair within one call on one card, in turns (A, B, B, A by default).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_HEAD = """
import json, sys, torch
sys.path.insert(0, {root!r})
import chip_smoke as c
c.device_and_build()
dev = torch.device("cuda", 0)
shape, params, _e, _pe, gen = c.build_models(dev)
"""

_FIT = """
rows = {{}}
c.check_k3_k4(shape, params, gen, dev, rows)
print("ROWS " + json.dumps(rows), flush=True)
"""

# the training batch of check_k5_k6 (B = 32 rows x 1693 points padded to
# 2048, no culling): coords, the folded operands and the cull mask
_TRAIN_INPUTS = """
from nphm_tpu_torch.models.ensemble import mirror_scale, predict_anchors
from nphm_tpu_torch.ops.fit_fields import active_mask, prepare_train_operands
from nphm_tpu_torch.ops.train_fields import _flat, _unflat, member_fields, member_fields_plain

cfg, B, tile, A = shape.cfg, 32, 512, shape.cfg.n_members
xyz = torch.tensor(c.train_batch(B, c.SEED + 4), device=dev)
N = xyz.shape[1]
Np = -(-N // tile) * tile
xyz = torch.cat([xyz, xyz[:, -1:].expand(B, Np - N, 3)], dim=1)
lat = (torch.randn((B, cfg.lat_dim), generator=gen) * 0.1).to(dev)
with torch.no_grad():
    anchors = predict_anchors(params, cfg, lat)
    centers = torch.cat([anchors, torch.zeros_like(anchors[:, :1])], dim=1)
    coords = (xyz[:, :, None] - centers[:, None]) * mirror_scale(cfg, dev)
    coords = coords.permute(2, 3, 0, 1).reshape(A, 3, B * Np).contiguous()
    layers, _ = prepare_train_operands(params, cfg, lat)
    active = active_mask(cfg, coords, tile, 0.0)
"""

_TRAIN = _TRAIN_INPUTS + """
with torch.no_grad():
    F, G = member_fields(cfg, layers, coords, active, tile, B)
Fp, Gp = member_fields_plain(cfg, layers, coords, active, tile, B)
err = max(float((F - Fp).abs().max()), float((G - Gp).detach().abs().max()))
del Fp, Gp
torch.cuda.empty_cache()
with torch.no_grad():
    ms = c.cuda_ms(lambda: member_fields(cfg, layers, coords, active, tile, B), 5)
print(f"[K5] M={{B}}x{{Np}}: kernel {{ms:.3f}} ms; F, G max|err| {{err:.3e}} vs plain",
      flush=True)
print("ROWS " + json.dumps({{"train_fwd": {{"ms": ms, "max_abs_err": err}}}}), flush=True)
"""

_TRAIN_BWD = _TRAIN_INPUTS + """
flat = [t.detach().clone().requires_grad_(True) for t in _flat(cfg, layers)]
coords.requires_grad_(True)
ins = flat + [coords]
dF = torch.randn((A, B * Np), generator=gen).to(dev)
dG = torch.randn((A, 3, B * Np), generator=gen).to(dev)
F, G = member_fields(cfg, _unflat(cfg, flat), coords, active, tile, B)
phi = (F * dF).sum() + (G * dG).sum()
ms = c.cuda_ms(lambda: torch.autograd.grad(phi, ins, retain_graph=True), 5)
print(f"[K6] M={{B}}x{{Np}}: kernel {{ms:.3f}} ms", flush=True)
print("ROWS " + json.dumps({{"train_bwd": {{"ms": ms}}}}), flush=True)
"""

KERNELS = {"fit": (_FIT, ("fit_fwd", "fit_bwd")), "train": (_TRAIN, ("train_fwd",)),
           "train_bwd": (_TRAIN_BWD, ("train_bwd",))}


def run_turn(root: str, body: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", (_HEAD + body).format(root=root)],
                          cwd=root, capture_output=True, text=True)
    for line in proc.stdout.splitlines():
        if line.startswith(("[K3]", "[K4]", "[K5]", "[K6]")):
            print(f"  {line}", flush=True)
        if line.startswith("ROWS "):
            return json.loads(line[5:])
    raise RuntimeError(f"turn in {root} failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root_a")
    ap.add_argument("root_b")
    ap.add_argument("--kernels", choices=sorted(KERNELS), default="fit")
    ap.add_argument("--order", default="ABBA")
    args = ap.parse_args(argv)
    body, names = KERNELS[args.kernels]
    roots = {"A": os.path.abspath(args.root_a), "B": os.path.abspath(args.root_b)}
    times = {"A": [], "B": []}
    for turn in args.order:
        print(f"[ab] turn {turn}: {roots[turn]}", flush=True)
        rows = run_turn(roots[turn], body)
        times[turn].append({k: rows[k]["ms"] for k in names})
    means = {t: {k: sum(r[k] for r in rs) / len(rs) for k in names}
             for t, rs in times.items() if rs}
    summary = {"turns": times, "mean_ms": means}
    if times["A"] and times["B"]:
        summary["ratio_a_over_b"] = {k: means["A"][k] / means["B"][k] for k in names}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
