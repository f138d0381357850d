"""snngp_torch — Scale Mixtures of Neural Network Gaussian Processes on
PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``snngp`` (the reference it is tested against),
module for module: each ``snngp_torch.<path>`` is the counterpart of
``snngp.<path>``. This covers exact-GP regression, serving and ML-II
training:

- ``snngp_torch.nn``      dense NNGP kernel tier (Dense / ReLU / Erf /
                          residual combinators) and the MLP / dense-ResNet
                          builders, which route every 2-D Gram block to the
                          fused Gram of ``snngp_torch.ops.gram``.
- ``snngp_torch.ops``     Cholesky-based linear algebra, the marginal
                          likelihoods, and the fused NNGP Gram with its
                          scalar-tangent backward (hand-written CUDA kernels,
                          ``csrc/gram.cu``, with plain PyTorch twins for CPU
                          tensors).
- ``snngp_torch.models``  softplus-constrained parameters, ``NNGPKernel``,
                          Gaussian / Student-t likelihoods, ``SPR`` (the
                          ML-II loss and the predictive NLL) and the fitted
                          predictor ``fit_spr`` / ``FittedSPR``.
- ``snngp_torch.utils``   objax-exact Adam / SGD, the plateau schedule, the
                          ML-II step, ``.npz`` checkpoints and
                          ``resume.state`` (the JAX package's layouts), the
                          line logger and the phase profiler.
- ``snngp_torch.data``    the regression datasets (a numpy copy of
                          ``snngp.data``; importing ``snngp`` pulls in JAX).
- ``snngp_torch.cli``     ``reg tr`` / ``reg ts`` / ``reg pr``
                          (``python -m snngp_torch``).
- ``snngp_torch.sklearn`` ``SNNGPRegressor`` (imported on demand).

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
