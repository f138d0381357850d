"""Checkpoints and logging."""

from snngp_torch.utils.checkpoint import Checkpointer, load_named, save_params
from snngp_torch.utils.training import Logger, get_context_summary

__all__ = ["Checkpointer", "load_named", "save_params", "Logger",
           "get_context_summary"]
