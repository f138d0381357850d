"""snngp_torch — Scale Mixtures of Neural Network Gaussian Processes on
PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``snngp`` (the reference it is tested against),
module for module: each ``snngp_torch.<path>`` is the counterpart of
``snngp.<path>``. This slice covers the exact-GP serving path:

- ``snngp_torch.nn``      dense NNGP kernel tier (Dense / ReLU / Erf /
                          residual combinators) and the MLP / dense-ResNet
                          builders, which route every 2-D Gram block to the
                          fused Gram of ``snngp_torch.ops.gram``.
- ``snngp_torch.ops``     Cholesky-based linear algebra and the fused NNGP
                          Gram (a hand-written CUDA kernel, ``csrc/gram.cu``,
                          with a plain PyTorch twin for CPU tensors).
- ``snngp_torch.models``  softplus-constrained parameters, ``NNGPKernel``,
                          Gaussian / Student-t likelihoods, ``SPR`` and the
                          fitted predictor ``fit_spr`` / ``FittedSPR``.
- ``snngp_torch.utils``   ``.npz`` named-variable checkpoints (the JAX
                          package's layout) and the line logger.
- ``snngp_torch.data``    the regression datasets (a numpy copy of
                          ``snngp.data``; importing ``snngp`` pulls in JAX).
- ``snngp_torch.cli``     ``reg ts`` / ``reg pr`` (``python -m snngp_torch``).

Importing this package never imports JAX.
"""

import torch as _torch

# NNGP Gram matrices are near-singular; a TF32 matmul pass (10-bit mantissa)
# breaks the fp32 Cholesky the same way bf16 passes did on the TPU, where the
# JAX package pins "highest" matmul precision. Both switches stay off.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from snngp_torch import nn  # noqa: E402
from snngp_torch import ops  # noqa: E402
from snngp_torch import models  # noqa: E402
from snngp_torch import utils  # noqa: E402
from snngp_torch import data  # noqa: E402

__version__ = "0.1.0"

__all__ = ["nn", "ops", "models", "utils", "data", "__version__"]
