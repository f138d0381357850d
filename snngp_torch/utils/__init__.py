"""Checkpoints, optimizers, training-loop helpers, logging and profiling."""

from snngp_torch.utils.checkpoint import (Checkpointer, load_named, load_training_state,
                                          save_params, save_training_state)
from snngp_torch.utils.optim import SGD, Adam
from snngp_torch.utils.profiling import Profiler
from snngp_torch.utils.training import (DataLoader, Logger, ReduceLROnPlateau,
                                        get_context_summary, progress, svsp_train_step,
                                        train_step)

__all__ = ["Checkpointer", "load_named", "save_params", "save_training_state",
           "load_training_state", "Adam", "SGD", "Profiler", "Logger",
           "ReduceLROnPlateau", "get_context_summary", "train_step", "svsp_train_step",
           "DataLoader", "progress"]
