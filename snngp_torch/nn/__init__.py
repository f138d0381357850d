"""NNGP / NTK kernel engine: the layer tier, its finite-width networks and
the reference architectures. Exports the names of ``snngp/nn/__init__.py``
(plus ``finite`` and ``state``)."""

from snngp_torch.nn import arch, finite, layers, state
from snngp_torch.nn.state import KernelState, input_state
from snngp_torch.nn.layers import (
    Layer, Dense, Conv, Relu, Erf, Flatten, Identity, FanOut, FanInSum,
    serial, parallel, kernel_fn_of,
)
from snngp_torch.nn.arch import (
    get_mlp_kernel, get_cnn_kernel, get_conv_resnet_kernel, get_dense_resnet_kernel,
    get_mlp_layer, get_cnn_layer, get_conv_resnet_layer, get_dense_resnet_layer,
)

__all__ = [
    "arch", "finite", "layers", "state", "KernelState", "input_state",
    "Layer", "Dense", "Conv", "Relu", "Erf", "Flatten", "Identity",
    "FanOut", "FanInSum", "serial", "parallel", "kernel_fn_of",
    "get_mlp_kernel", "get_cnn_kernel", "get_conv_resnet_kernel",
    "get_dense_resnet_kernel", "get_mlp_layer", "get_cnn_layer",
    "get_conv_resnet_layer", "get_dense_resnet_layer",
]
