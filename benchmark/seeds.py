"""Seeds of the benchmark's random streams: one independent stream for each
purpose (data, draws, requests), all from the run's ``--seed``, which may
be any whole number."""

from __future__ import annotations

import hashlib
import random


def sub_seed(seed, purpose):
    """A 63-bit seed for ``purpose``'s stream of run seed ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed, purpose, device):
    """A ``torch.Generator`` on ``device`` for ``purpose``."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, purpose))
    return gen


def host_random(seed, purpose):
    """A ``random.Random`` for ``purpose``."""
    return random.Random(sub_seed(seed, purpose))
