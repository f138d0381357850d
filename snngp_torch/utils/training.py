"""Logging utilities (counterpart of the ``Logger`` and
``get_context_summary`` parts of ``snngp/utils/training.py``)."""

from __future__ import annotations

import os

__all__ = ["Logger", "get_context_summary"]


class Logger:
    def __init__(self, logdir: str, filename: str = "train.log",
                 makedir: bool = True, quite: bool = False):
        self.logdir = logdir
        self.quite = quite
        if makedir:
            os.makedirs(logdir, exist_ok=True)
        self.logfile = open(os.path.join(logdir, filename), "w")

    def log(self, *args, is_tqdm: bool = False):
        s = "".join(map(str, args))
        self.logfile.write(s + "\n")
        self.logfile.flush()
        if not self.quite:
            if is_tqdm:
                try:
                    from tqdm import tqdm
                    tqdm.write(s)
                except ImportError:
                    print(s, flush=True)
            else:
                print(s, flush=True)

    def close(self):
        self.logfile.close()


def get_context_summary(args, values_dict, indent=2):
    args_dict = {k: v for k, v in vars(args).items() if k != "func"}
    keys = list(args_dict.keys()) + list(values_dict.keys())
    key_max_len = max(map(len, keys)) if keys else 0
    s = "Args:\n"
    for k, v in args_dict.items():
        s += f"{' ' * indent}{k.ljust(key_max_len)}: {v}\n"
    s += "\nValues:\n"
    for k, v in values_dict.items():
        s += f"{' ' * indent}{k.ljust(key_max_len)}: {v}\n"
    return s + "\n"
