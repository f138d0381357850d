"""CLI entry point: ``python -m snngp_torch [--device DEV] {reg,cls} {tr,ts,pr}
...``, ``reg fd`` and ``ens {tr,ts}`` (counterpart of the JAX package's
``run.py``).

``--device`` (default ``cuda``) names the torch device every tensor lives
on; it stands where ``run.py`` has ``--devices``. Asking for CUDA on a
machine without it is an error, not a quiet CPU run.
"""

import argparse
import sys

import torch

import snngp_torch.cli


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", type=str, default="cuda")
    pre_args, rest = pre.parse_known_args(argv)

    device = torch.device(pre_args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {pre_args.device}: CUDA is not available "
                         "on this machine (pass --device cpu to run on the CPU)")

    parser = argparse.ArgumentParser(
        prog="python -m snngp_torch",
        description="Scale Mixtures of NNGP on PyTorch (pre-flag: --device)")
    subparsers = parser.add_subparsers(dest="command", metavar="command", required=True)
    snngp_torch.cli.add_subparser(subparsers)
    args = parser.parse_args(rest)
    args.device = device
    args.func(args)


if __name__ == "__main__":
    main(sys.argv[1:])
