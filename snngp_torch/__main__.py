"""CLI entry point: ``python -m snngp_torch [--device DEV] [--devices N]
{reg,cls} {tr,ts,pr} ...``, ``reg fd`` and ``ens {tr,ts}`` (counterpart of
the JAX package's ``run.py``).

``--device`` (default ``cuda``) names the torch device every tensor lives
on. Asking for CUDA on a machine without it is an error, not a quiet CPU
run. ``--devices N`` sets ``SNNGP_MESH_DEVICES``, as ``run.py`` does: ``reg
tr`` and ``cls tr`` then train on a mesh of N shards of that device type.
"""

import argparse
import os
import sys

import torch

import snngp_torch.cli


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", type=str, default="cuda")
    pre.add_argument("--devices", type=int, default=None)
    pre_args, rest = pre.parse_known_args(argv)
    if pre_args.devices is not None:
        os.environ["SNNGP_MESH_DEVICES"] = str(pre_args.devices)

    device = torch.device(pre_args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {pre_args.device}: CUDA is not available "
                         "on this machine (pass --device cpu to run on the CPU)")

    parser = argparse.ArgumentParser(
        prog="python -m snngp_torch",
        description="Scale Mixtures of NNGP on PyTorch (pre-flags: --device, --devices)")
    subparsers = parser.add_subparsers(dest="command", metavar="command", required=True)
    snngp_torch.cli.add_subparser(subparsers)
    args = parser.parse_args(rest)
    args.device = device
    args.func(args)


if __name__ == "__main__":
    main(sys.argv[1:])
