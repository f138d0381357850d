"""argparse command tree: ``regression|reg`` x ``train|tr``, ``test|ts``,
``predict|pr``."""

from snngp_torch.cli import regression


def add_subparser(subparsers):
    regression.add_subparser(subparsers)


__all__ = ["add_subparser", "regression"]
