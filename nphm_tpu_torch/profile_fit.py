"""Where the time of one NPHM fit step goes, on the GPU.

    python -m nphm_tpu_torch.profile_fit [ROOT ...] [--steps 60] [--active 20]
                                         [--subjects S]

For each checkout ROOT (default: this one), in a fresh process whose
``nphm_tpu_torch`` and ``chip_smoke`` are that checkout's: builds the NPHM
models of ``chip_smoke.build_models`` (``configs/nphm.yaml``,
``configs/nphm_def.yaml``, seeded), the 20 warped-sphere scans of its fit
phase, and runs ``fit_joint`` at the ``FittingConfig`` defaults (5 obs x
1000 points a step, K2/K3/K4 on CUDA); with ``--subjects S`` > 1,
``fit_joint_batch`` on S subjects of 20 scans each (phase 7's, from their
own seeds), S x 5 obs x 1000 points a step:

- once unprofiled for ``--steps`` steps: the steady wall time of a step
  (``steady_it_s``, the first step excluded);
- once under ``torch.profiler`` over ``--active`` steady steps (after the
  first step and two warm-up steps), with ranges around the phases of a
  step, installed from outside (``fit_joint``'s code is unchanged):
  ``search`` (``ops.search.search_fused``: K2 and its operand folding),
  ``shape_field`` (``ops.fit_fields.apply_nphm_fit``: K3 and its glue),
  ``ift_correction`` (its forward), ``loss_forward`` (the whole loss
  body), ``backward`` (``torch.autograd.grad``: K4 and the backward of the
  IFT and the loss) and ``adam`` (both latent updates).

Prints, per checkout, one ``PROFILE_FIT {...}`` JSON line: the card's name
and power limit, wall and device ms a step, the idle share (1 - device /
wall), the device ms of K2, K3 and K4 by kernel name, and the device and
host ms a step of each phase.  A phase's device time holds the kernels the
profiler links to it: torch's own and K3 (launched inside an autograd
Function), not K2 (a bare ctypes launch), and none of the backward's,
which the autograd engine launches from its own thread.  Host times are
taken under the profiler; ``profiled_step_wall_ms`` is its step.  Naming
a checkout more than once times the checkouts in turns, and a last
``PROFILE_FIT_SUMMARY {...}`` line gives each checkout's quartiles over
its turns.  Needs a GPU; nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = {"K2": ("broyden_search_kernel",), "K3": ("fit_fwd_kernel",),
           "K4": ("fit_bwd_kernel", "sum_block_partials")}
PHASES = ("search", "shape_field", "ift_correction", "loss_forward", "backward", "adam")


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _ranged(name, fn):
    import torch

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return wrapped


def profile_checkout(steps: int, active: int, subjects: int = 1) -> dict:
    """Profile fit steps of ``subjects`` subjects with the ``nphm_tpu_torch``
    and ``chip_smoke`` on ``sys.path`` (one checkout's)."""
    import torch

    import chip_smoke as c
    from nphm_tpu_torch.fitting import inference
    from nphm_tpu_torch.ops import fit_fields, search

    if not torch.cuda.is_available():
        raise SystemExit("profile_fit needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    c.device_and_build()
    shape, ps, expr, pe, _gen = c.build_models(dev)
    obs = c.observations(20, 2500, c.SEED + 3)
    group = [c.observations(20, 2500, c.SEED + 100 + s) for s in range(subjects)]

    def fit(n):
        """The history of an n-step fit, with ``steady_it_s`` in steps/s."""
        cfg = inference.FittingConfig(n_steps=n, seed=c.SEED)
        if subjects == 1:
            return inference.fit_joint(shape, ps, expr, pe, obs, cfg=cfg, device=dev,
                                       verbose=False)[3]
        hist = inference.fit_joint_batch(shape, ps, expr, pe, group, cfg=cfg, device=dev,
                                         verbose=False)[3]
        hist["steady_it_s"] = hist["steady_subject_steps_s"] / subjects
        return hist

    hist = fit(steps)
    wall_ms = 1e3 / hist["steady_it_s"]

    # phase ranges, and a profiler step at the end of each fit step (the
    # second latent update)
    wait, warmup = 1, 2
    sched = torch.profiler.schedule(wait=wait, warmup=warmup, active=active, repeat=1)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts, schedule=sched)
    adam_step = inference._Adam.step
    calls, ends = [0], []

    def step(self, p, g, lr):
        with torch.profiler.record_function("adam"):
            adam_step(self, p, g, lr)
        calls[0] += 1
        if calls[0] % 2 == 0:
            prof.step()
            ends.append(time.perf_counter())

    make_loss = inference._make_joint_loss
    patches = [
        (search, "search_fused", _ranged("search", search.search_fused)),
        (fit_fields, "apply_nphm_fit", _ranged("shape_field", fit_fields.apply_nphm_fit)),
        (inference, "ift_correction", _ranged("ift_correction", inference.ift_correction)),
        (inference, "_make_joint_loss",
         lambda *a, **k: _ranged("loss_forward", make_loss(*a, **k))),
        (torch.autograd, "grad", _ranged("backward", torch.autograd.grad)),
        (inference._Adam, "step", step),
    ]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        with prof:
            fit(wait + warmup + active + 1)
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)

    # device kernels only: a range's device time repeats its kernels', and
    # each range and profiler step also leaves a span on the device
    # timeline under its own name
    kernels, ranges = {}, {}
    for ev in prof.key_averages():
        dev_ms = ev.device_time_total / 1e3 / active
        if ev.key in PHASES or ev.key.startswith("ProfilerStep"):
            if ev.key in PHASES and ev.device_type == torch.autograd.DeviceType.CPU:
                ranges[ev.key] = {"device_ms": dev_ms,
                                  "host_ms": ev.cpu_time_total / 1e3 / active}
        elif ev.device_type == torch.autograd.DeviceType.CUDA and dev_ms > 0:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + dev_ms

    def share(names):
        return sum(v for k, v in kernels.items() if any(n in k for n in names))

    # host clock over the profiled steps (the profiler slows the host)
    first = wait + warmup
    profiled_ms = (ends[first + active - 1] - ends[first - 1]) / active * 1e3
    device_ms = sum(kernels.values())
    if device_ms > wall_ms:
        raise RuntimeError(f"device kernels sum to {device_ms:.3f} ms a step, more than the "
                           f"{wall_ms:.3f} ms wall time: the device-time count is wrong")
    by_kernel = {k: share(names) for k, names in KERNELS.items()}
    return {
        "card": _card(),
        "root": os.getcwd(),
        "subjects": subjects,
        "obs_x_points": [5 * subjects, 1000],
        "steps_timed": steps - 1,
        "steps_profiled": active,
        "steady_it_s": hist["steady_it_s"],
        "steady_subject_steps_s": hist["steady_it_s"] * subjects,
        "step_wall_ms": wall_ms,
        "profiled_step_wall_ms": profiled_ms,
        "device_ms_per_step": device_ms,
        "idle_share": 1.0 - device_ms / wall_ms,
        "kernels_ms": by_kernel,
        "phases": ranges,
        "broyden_iters_mean": float(hist["broyden_iters"][1:].mean()),
        "top_kernels_ms": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:10]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", default=[ROOT])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--active", type=int, default=20)
    ap.add_argument("--subjects", type=int, default=1)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:  # a child: PYTHONPATH holds one checkout
        here = os.path.dirname(os.path.abspath(__file__))
        sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
        print("PROFILE_FIT " + json.dumps(
            profile_checkout(args.steps, args.active, args.subjects)), flush=True)
        return 0
    turns = {}
    for root in args.roots:
        root = os.path.abspath(root)
        env = dict(os.environ, PYTHONPATH=root)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", "--steps", str(args.steps),
             "--active", str(args.active), "--subjects", str(args.subjects)],
            cwd=root, env=env, capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("PROFILE_FIT ")]
        if proc.returncode != 0 or not lines:
            raise RuntimeError(f"profile in {root} failed:\n{proc.stdout[-4000:]}\n"
                               f"{proc.stderr[-4000:]}")
        print(lines[-1], flush=True)
        turns.setdefault(root, []).append(json.loads(lines[-1].split(" ", 1)[1]))
    if any(len(v) > 1 for v in turns.values()):
        print("PROFILE_FIT_SUMMARY " + json.dumps(
            {root: summary(runs) for root, runs in turns.items()}), flush=True)
    return 0


def summary(runs) -> dict:
    """Quartiles [25%, 50%, 75%] over one checkout's turns of the step's
    wall and device ms, its idle share, and each phase's host and device
    ms a step."""
    import numpy as np

    def q(values):
        return [float(x) for x in np.percentile(values, [25, 50, 75])]

    out = {"turns": len(runs)}
    for key in ("steady_it_s", "step_wall_ms", "profiled_step_wall_ms",
                "device_ms_per_step", "idle_share"):
        out[key] = q([r[key] for r in runs])
    for phase in PHASES:
        for kind in ("host_ms", "device_ms"):
            out[f"{phase}.{kind}"] = q([r["phases"].get(phase, {}).get(kind, float("nan"))
                                        for r in runs])
    return out


if __name__ == "__main__":
    sys.exit(main())
