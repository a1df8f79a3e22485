"""Generate a synthetic dummy dataset tree for the -demo path and tests
(counterpart of ``scripts/dataset/make_dummy_data.py``, same flags and
printed lines):

    python -m nphm_tpu_torch.make_dummy_data --root ~/nphm_dummy [--print-env]

It lets every CLI of the port (both training stages, the demo fit,
evaluation) run end to end without the license-gated NPHM dataset.  Then
export the variables it prints (or ``eval $(... --print-env)``).  Host
only: numpy and the port's host marching library.
"""

from __future__ import annotations

import argparse

from nphm_tpu_torch.data.dummy import dummy_env, generate_dummy_data


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", required=True, type=str)
    parser.add_argument("--subjects", type=int, nargs="+", default=[351, 365, 199])
    parser.add_argument("--n_expressions", type=int, default=2)
    parser.add_argument("--n_supervision", type=int, default=20000)
    parser.add_argument("--print-env", action="store_true")
    args = parser.parse_args(argv)

    generate_dummy_data(args.root, subjects=tuple(args.subjects),
                        n_expressions=args.n_expressions, n_supervision=args.n_supervision)
    env = dummy_env(args.root)
    if args.print_env:
        for k, v in env.items():
            print(f"export {k}={v}")
    else:
        print(f"dummy data written to {args.root}")
        print("set these to use it:")
        for k, v in env.items():
            print(f"  {k}={v}")


if __name__ == "__main__":
    main()
