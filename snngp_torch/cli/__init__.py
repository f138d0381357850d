"""argparse command tree: ``regression|reg`` and ``classification|cls``, each
x ``train|tr``, ``test|ts``, ``predict|pr``; ``regression`` also has
``find|fd``, the Burr-XII grid search."""

from snngp_torch.cli import classification, regression


def add_subparser(subparsers):
    regression.add_subparser(subparsers)
    classification.add_subparser(subparsers)


__all__ = ["add_subparser", "classification", "regression"]
