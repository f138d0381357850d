"""NNGP kernel engine: dense layer tier and architecture builders."""

from snngp_torch.nn import arch, layers, state
from snngp_torch.nn.state import KernelState, input_state

__all__ = ["arch", "layers", "state", "KernelState", "input_state"]
