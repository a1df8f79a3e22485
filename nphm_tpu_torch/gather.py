"""Aggregate per-scan metric JSONs into per-subject and total averages
(counterpart of ``scripts/evaluation/gather.py``, same flags):

    python -m nphm_tpu_torch.gather --result_dir FITTING_DIR/forward_EXP/TAG [--subjects S ...]

Writes ``total_merics.csv`` (sic, the reference's name, kept so that
downstream readers find it) and ``total_metrics_face.csv`` under
``{result_dir}/evaluation/``: a header of metric names and one row of their
means over the scans read.  A subject's scans stop at its first missing or
unreadable metrics file, as in the reference.  Host-only.
"""

import argparse
import csv
import json
import os

from nphm_tpu_torch import env_paths
from nphm_tpu_torch.data.manager import DataManager


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--result_dir", required=True, type=str)
    parser.add_argument("--subjects", type=int, nargs="*", default=None)
    args = parser.parse_args(argv)

    manager = DataManager()
    subjects = args.subjects or env_paths.subjects_test

    all_metrics, all_metrics_face = {}, {}
    total_scans = 0
    for subject in subjects:
        try:
            expressions = sorted(manager.get_expressions(subject, testing=True))
            all_metrics[subject] = {}
            all_metrics_face[subject] = {}
            for expression in expressions:
                base = os.path.join(args.result_dir, "evaluation", str(subject),
                                    f"expression_{expression}")
                with open(os.path.join(base, "metrics.json")) as f:
                    metrics = json.load(f)
                for k, v in metrics.items():
                    all_metrics[subject].setdefault(k, []).append(v)
                total_scans += 1
                with open(os.path.join(base, "metrics_face.json")) as f:
                    metrics_face = json.load(f)
                for k, v in metrics_face.items():
                    all_metrics_face[subject].setdefault(k, []).append(v)
        except (OSError, ValueError):
            # the reference's silent skip (gather.py:39-40): the scans read
            # before the missing file still count
            pass

    avg, avg_face, total, total_face = {}, {}, {}, {}
    for subject in subjects:
        avg[subject], avg_face[subject] = {}, {}
        if subject in all_metrics:
            for k in all_metrics[subject]:
                vals = all_metrics[subject][k]
                vals_face = all_metrics_face[subject][k]
                avg[subject][k] = sum(vals) / len(vals)
                avg_face[subject][k] = sum(vals_face) / len(vals_face)
                total[k] = total.get(k, 0.0) + sum(vals)
                total_face[k] = total_face.get(k, 0.0) + sum(vals_face)

    for k in total:
        total[k] /= total_scans
        total_face[k] /= total_scans

    print(json.dumps(avg, indent=4))
    print(json.dumps(total, indent=4))
    print(f"total scans: {total_scans}")

    eval_dir = os.path.join(args.result_dir, "evaluation")
    with open(os.path.join(eval_dir, "total_merics.csv"), "w") as f:
        w = csv.DictWriter(f, total.keys())
        w.writeheader()
        w.writerow(total)
    with open(os.path.join(eval_dir, "total_metrics_face.csv"), "w") as f:
        w = csv.DictWriter(f, total_face.keys())
        w.writeheader()
        w.writerow(total_face)
    return total, total_face


if __name__ == "__main__":
    main()
