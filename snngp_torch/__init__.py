"""snngp_torch — Scale Mixtures of Neural Network Gaussian Processes on
PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``snngp`` (the reference it is tested against),
module for module: each ``snngp_torch.<path>`` is the counterpart of
``snngp.<path>``. This covers exact-GP regression (serving and ML-II
training) and sparse variational classification of images:

- ``snngp_torch.nn``      the NNGP / NTK kernel tier (Dense / Conv / ReLU /
                          Erf / Flatten / pooling / residual combinators)
                          with its finite-width networks, and the MLP,
                          dense-ResNet, CNN and conv-WideResNet builders,
                          which route NNGP Gram blocks to the fused Grams of
                          ``snngp_torch.ops``.
- ``snngp_torch.ops``     Cholesky / eigh linear algebra, the marginal
                          likelihoods, the Student-t sampler, the softmax
                          estimators, the fused NNGP and CNN Grams with
                          their scalar-tangent backwards and the fused
                          WideResNet Gram (hand-written CUDA kernels,
                          ``csrc/gram.cu``, ``csrc/conv_gram.cu`` and
                          ``csrc/resnet_conv_gram.cu``, with plain PyTorch
                          twins for CPU tensors).
- ``snngp_torch.models``  softplus-constrained parameters, ``NNGPKernel``,
                          likelihoods and priors, ``SPR`` and ``SVSP``, and
                          the fitted predictors (``fit_spr`` / ``FittedSPR``,
                          ``fit_svsp`` / ``FittedSVSP``).
- ``snngp_torch.utils``   objax-exact Adam / SGD, the plateau schedule, the
                          training steps, the data loader, ``.npz``
                          checkpoints and ``resume.state`` (the JAX
                          package's layouts), the logger and the profiler.
- ``snngp_torch.data``    the regression and classification datasets and
                          the host resize (numpy copies of ``snngp.data``;
                          importing ``snngp`` pulls in JAX).
- ``snngp_torch.parallel`` (imported with the package) the device mesh of one process: sharded Grams,
                          blocked / in-place / cyclic / distributed
                          Cholesky, the distributed ML-II step.
- ``snngp_torch.cli``     ``reg`` and ``cls`` x ``tr`` / ``ts`` / ``pr``, ``reg
                          fd`` and ``ens`` x ``tr`` / ``ts``
                          (``python -m snngp_torch``).
- ``snngp_torch.sklearn`` ``SNNGPRegressor``, ``SNNGPClassifier`` (imported
                          on demand).

Importing this package never imports JAX and does not initialize CUDA.
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
from snngp_torch import parallel  # noqa: E402
from snngp_torch import utils  # noqa: E402
from snngp_torch import data  # noqa: E402

__version__ = "0.1.0"

__all__ = ["nn", "ops", "models", "parallel", "utils", "data", "__version__"]
