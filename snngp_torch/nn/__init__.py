"""NNGP / NTK kernel engine: the layer tier, its finite-width networks and
the reference architectures."""

from snngp_torch.nn import arch, finite, layers, state
from snngp_torch.nn.state import KernelState, input_state

__all__ = ["arch", "finite", "layers", "state", "KernelState", "input_state"]
