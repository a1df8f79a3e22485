"""Time the fit kernels K3/K4 of two checkouts on one card, in turns.

    python3 -m nphm_tpu_torch.kernel_ab ROOT_A ROOT_B [--order ABBA]

Each turn runs in a fresh process from one checkout: that checkout's
``chip_smoke.py`` builds its kernels (``device_and_build``), builds the NPHM
models (``build_models``) and runs ``check_k3_k4`` (K3 and K4 at the fit's
shapes, each against its plain version, timed with CUDA events).  Its rows
print as one ``ROWS {...}`` JSON line; the summary gives each checkout's
mean kernel times and the ratio A / B.  Comparing two versions is only fair
within one call on one card, in turns (A, B, B, A by default).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_TURN = """
import json, sys, torch
sys.path.insert(0, {root!r})
import chip_smoke as c
c.device_and_build()
dev = torch.device("cuda", 0)
shape, params, _e, _pe, gen = c.build_models(dev)
rows = {{}}
c.check_k3_k4(shape, params, gen, dev, rows)
print("ROWS " + json.dumps(rows), flush=True)
"""


def run_turn(root: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", _TURN.format(root=root)], cwd=root,
                          capture_output=True, text=True)
    for line in proc.stdout.splitlines():
        if line.startswith("[K3]") or line.startswith("[K4]"):
            print(f"  {line}", flush=True)
        if line.startswith("ROWS "):
            return json.loads(line[5:])
    raise RuntimeError(f"turn in {root} failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root_a")
    ap.add_argument("root_b")
    ap.add_argument("--order", default="ABBA")
    args = ap.parse_args(argv)
    roots = {"A": os.path.abspath(args.root_a), "B": os.path.abspath(args.root_b)}
    times = {"A": [], "B": []}
    for turn in args.order:
        print(f"[ab] turn {turn}: {roots[turn]}", flush=True)
        rows = run_turn(roots[turn])
        times[turn].append({k: rows[k]["ms"] for k in ("fit_fwd", "fit_bwd")})
    means = {t: {k: sum(r[k] for r in rs) / len(rs) for k in ("fit_fwd", "fit_bwd")}
             for t, rs in times.items() if rs}
    summary = {"turns": times, "mean_ms": means}
    if times["A"] and times["B"]:
        summary["ratio_a_over_b"] = {k: means["A"][k] / means["B"][k]
                                     for k in ("fit_fwd", "fit_bwd")}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
