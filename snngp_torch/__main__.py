"""CLI entry point: ``python -m snngp_torch [--device DEV] [--devices N]
{reg,cls} {tr,ts,pr} ...``, ``reg fd`` and ``ens {tr,ts}`` (counterpart of
the JAX package's ``run.py``).

``--device`` (default ``cuda``) names the torch device every tensor lives
on. Asking for CUDA on a machine without it is an error, not a quiet CPU
run. ``--devices N`` sets ``SNNGP_MESH_DEVICES``, as ``run.py`` does: ``reg
tr`` and ``cls tr`` then train on a mesh of N shards of that device type.

``-f F`` / ``--fraction F`` (0 < F <= 1) caps the caching allocator on a
CUDA ``--device`` at F of the card's memory
(``torch.cuda.set_per_process_memory_fraction``) before the command runs:
an allocation past the cap raises out-of-memory. ``run.py``'s flag of that
name sets ``XLA_PYTHON_CLIENT_MEM_FRACTION``, which makes XLA preallocate F
of the card; PyTorch allocates on demand, and F is a ceiling, not a
reservation. A CPU run ignores it. Only the exact tokens ``-f``, ``-f=F``,
``--fraction`` and ``--fraction=F`` are taken, so that the subcommands'
flags that start with ``-f`` (``reg pr -fs``) reach them: ``run.py``'s
argparse pre-parser reads ``-fs PATH`` as ``-f s`` and exits.
"""

import argparse
import os
import sys

import torch

import snngp_torch.cli


def _take_fraction(argv):
    """(F, the other tokens) for ``-f F``, ``-f=F``, ``--fraction F`` or
    ``--fraction=F`` anywhere in ``argv``; F is None without one."""
    rest, fraction = [], None
    tokens = iter(argv)
    for tok in tokens:
        if tok in ("-f", "--fraction"):
            value = next(tokens, None)
        elif tok.startswith(("-f=", "--fraction=")):
            value = tok.split("=", 1)[1]
        else:
            rest.append(tok)
            continue
        try:
            fraction = float(value)
        except (TypeError, ValueError):
            raise SystemExit(f"{tok.split('=')[0]}: expected a fraction in (0, 1], "
                             f"got {value!r}") from None
        if not 0.0 < fraction <= 1.0:
            raise SystemExit(f"{tok.split('=')[0]}: the fraction {fraction} is not in (0, 1]")
    return fraction, rest


def main(argv=None):
    fraction, argv = _take_fraction(sys.argv[1:] if argv is None else list(argv))
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
    if fraction is not None and device.type == "cuda":
        index = torch.cuda.current_device() if device.index is None else device.index
        torch.cuda.set_per_process_memory_fraction(fraction, index)

    parser = argparse.ArgumentParser(
        prog="python -m snngp_torch",
        description="Scale Mixtures of NNGP on PyTorch (pre-flags: --device, --devices, "
                    "-f/--fraction)")
    subparsers = parser.add_subparsers(dest="command", metavar="command", required=True)
    snngp_torch.cli.add_subparser(subparsers)
    args = parser.parse_args(rest)
    args.device = device
    args.func(args)


if __name__ == "__main__":
    main(sys.argv[1:])
