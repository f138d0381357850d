"""argparse command tree: ``regression|reg`` and ``classification|cls``, each
x ``train|tr``, ``test|ts``, ``predict|pr``; ``regression`` also has
``find|fd``, the Burr-XII grid search; ``ensemble|ens`` x ``train|tr``,
``test|ts``, the finite-width CNN ensemble baseline."""

from snngp_torch.cli import classification, ensemble, regression


def add_subparser(subparsers):
    classification.add_subparser(subparsers)
    regression.add_subparser(subparsers)
    ensemble.add_subparser(subparsers)


__all__ = ["add_subparser", "classification", "ensemble", "regression"]
