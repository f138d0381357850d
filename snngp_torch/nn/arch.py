"""Architecture builders (counterpart of ``snngp/nn/arch.py``: the MLP,
dense-ResNet, CNN and conv-WideResNet networks).

``get_*_layer`` compose the layer tier (its kernel recursion, and the
finite-width ``init`` / ``apply`` at the ``width`` / ``channels`` / ``k``
they take); ``get_*_kernel`` return a ``kernel_fn(x1, x2=None, get="nngp")``
that sends every 2-D NNGP block to
the fused Gram (:mod:`snngp_torch.ops.gram`), every CNN block of images
with at most 1,024 pixels to the fused conv Gram
(:mod:`snngp_torch.ops.conv_gram`) and every such WideResNet block to the
fused WideResNet Gram (:mod:`snngp_torch.ops.resnet_conv_gram`), and every
Myrtle block of square power-of-two images from 8 x 8 to 32 x 32 to the
fused Myrtle Gram (:mod:`snngp_torch.ops.myrtle_gram`). Each launches its
CUDA kernels for CUDA tensors and runs their plain versions for CPU
tensors. The fused Grams take ``get="nngp"`` only: ``get="ntk"`` and tuple
requests go to the layer tier (the Myrtle kernel's to the full tier), as in
the JAX package. There is no size threshold on N: the JAX package's
``SNNGP_PALLAS_MIN_N`` amortized TPU compile latency, which a prebuilt CUDA
kernel does not have (nor the Myrtle dispatch's 2 GB full-tier threshold).
"""

from __future__ import annotations

from snngp_torch.nn import layers as L
from snngp_torch.ops import conv_gram as CG
from snngp_torch.ops import gram as G
from snngp_torch.ops import myrtle_gram as MG
from snngp_torch.ops import resnet_conv_gram as RG

__all__ = [
    "get_act",
    "get_mlp_kernel",
    "get_dense_resnet_kernel",
    "get_cnn_kernel",
    "get_conv_resnet_kernel",
    "get_myrtle_kernel",
    "get_mlp_layer",
    "get_dense_resnet_layer",
    "get_cnn_layer",
    "get_conv_resnet_layer",
    "KERNELS",
]


def get_act(act: str) -> L.Layer:
    if act == "relu":
        return L.Relu()
    if act == "erf":
        return L.Erf()
    raise KeyError(f"Unsupported act '{act}'")


def get_mlp_layer(num_hiddens, num_class=1, act="relu", w_std=1.0, b_std=0.0,
                  last_w_std=1.0, width=512) -> L.Layer:
    """N x [Dense(512) + act] + Dense(num_class)  (nt_kernels.py:21-31)."""
    stack = []
    for _ in range(num_hiddens):
        stack.append(L.Dense(width, w_std=w_std, b_std=b_std))
        stack.append(get_act(act))
    stack.append(L.Dense(num_class, w_std=last_w_std))
    return L.serial(*stack)


def get_cnn_layer(num_hiddens, num_class=1, act="relu", w_std=1.0, b_std=0.0,
                  last_w_std=1.0, channels=1) -> L.Layer:
    """N x [Conv3x3 SAME + act] + Flatten + Dense  (nt_kernels.py:34-45)."""
    stack = []
    for _ in range(num_hiddens):
        stack.append(L.Conv(channels, (3, 3), (1, 1), "SAME", w_std=w_std, b_std=b_std))
        stack.append(get_act(act))
    stack.append(L.Flatten())
    stack.append(L.Dense(num_class, w_std=last_w_std))
    return L.serial(*stack)


def get_conv_resnet_layer(num_hiddens, num_class, act="relu", w_std=1.0,
                          b_std=0.0, last_w_std=1.0, k=1) -> L.Layer:
    """WideResNet NNGP: FanOut/parallel/FanInSum residual blocks, 4 groups with
    stride-2 downsampling (nt_kernels.py:48-80). Channel counts only affect the
    finite-width path (the kernel recursion is width-independent)."""
    act_layer = lambda: get_act(act)  # noqa: E731

    def block(channels, strides=(1, 1), channel_mismatch=False):
        main = L.serial(
            act_layer(), L.Conv(channels, (3, 3), strides, "SAME", w_std=w_std, b_std=b_std),
            act_layer(), L.Conv(channels, (3, 3), (1, 1), "SAME", w_std=w_std, b_std=b_std),
        )
        shortcut = (L.Identity() if not channel_mismatch
                    else L.Conv(channels, (3, 3), strides, "SAME", w_std=w_std, b_std=b_std))
        return L.serial(L.FanOut(2), L.parallel(main, shortcut), L.FanInSum())

    def group(n, channels, strides=(1, 1)):
        blocks = [block(channels, strides, channel_mismatch=True)]
        for _ in range(n - 1):
            blocks.append(block(channels, (1, 1)))
        return L.serial(*blocks)

    return L.serial(
        L.Conv(16, (3, 3), (1, 1), "SAME", w_std=w_std, b_std=b_std),
        group(num_hiddens, int(8 * k)),
        group(num_hiddens, int(16 * k), (2, 2)),
        group(num_hiddens, int(32 * k), (2, 2)),
        group(num_hiddens, int(64 * k), (2, 2)),
        L.Flatten(),
        L.Dense(num_class, w_std=last_w_std),
    )


def get_dense_resnet_layer(num_hiddens, num_class=1, act="relu", w_std=1.0,
                           b_std=0.0, last_w_std=1.0, width=512) -> L.Layer:
    """Dense residual blocks (nt_kernels.py:83-103)."""

    def res_block():
        return L.serial(
            L.FanOut(2),
            L.parallel(
                L.serial(get_act(act), L.Dense(width, w_std=w_std, b_std=b_std)),
                L.Identity(),
            ),
            L.FanInSum(),
        )

    stack = [L.Dense(width, w_std=w_std, b_std=b_std)]
    stack += [res_block() for _ in range(num_hiddens)]
    stack += [get_act(act), L.Dense(num_class, w_std=last_w_std)]
    return L.serial(*stack)


def _fused_kernel_fn(layer_builder, gram_fn, num_hiddens, num_class, act,
                     w_std, b_std, last_w_std, width, trainable_inputs):
    ref_fn = L.kernel_fn_of(layer_builder(num_hiddens, num_class, act, w_std,
                                          b_std, last_w_std, width=width))

    def kernel_fn(x1, x2=None, get="nngp"):
        if get == "nngp" and x1.ndim == 2:
            return gram_fn(x1, x1 if x2 is None else x2, depth=num_hiddens,
                           act=act, w_std=w_std, b_std=b_std,
                           last_w_std=last_w_std, trainable_inputs=trainable_inputs)
        return ref_fn(x1, x2, get=get)

    return kernel_fn


def get_mlp_kernel(num_hiddens, num_class=1, act="relu", w_std=1.0, b_std=0.0,
                   last_w_std=1.0, width=512, trainable_inputs=True):
    """MLP kernel_fn: 2-D NNGP blocks go to the fused Gram.

    ``trainable_inputs=False`` declares that gradients are only ever taken
    with respect to the scale scalars (the ML-II regression configuration):
    the fused Gram's backward is then K2, the scalar-tangent kernel, with
    zero x cotangents."""
    return _fused_kernel_fn(get_mlp_layer, G.mlp_gram, num_hiddens, num_class,
                            act, w_std, b_std, last_w_std, width, trainable_inputs)


def get_dense_resnet_kernel(num_hiddens, num_class=1, act="relu", w_std=1.0,
                            b_std=0.0, last_w_std=1.0, width=512,
                            trainable_inputs=True):
    """Dense-ResNet kernel_fn: 2-D NNGP blocks go to the fused Gram.
    ``trainable_inputs``: see :func:`get_mlp_kernel`."""
    return _fused_kernel_fn(get_dense_resnet_layer, G.resnet_gram, num_hiddens,
                            num_class, act, w_std, b_std, last_w_std, width,
                            trainable_inputs)


def get_cnn_kernel(num_hiddens, num_class=1, act="relu", w_std=1.0, b_std=0.0,
                   last_w_std=1.0, channels=1, trainable_inputs=True):
    """CNN kernel_fn: NNGP blocks of [N, H, W, C] images with H W <= 1,024
    (CIFAR's 32 x 32 included) go to the fused conv Gram; larger images and
    2-D inputs go to the layer tier, as in the JAX package.

    ``trainable_inputs=False``: scalar-only gradients through K4, the fused
    tangent kernel (see :func:`get_mlp_kernel`); keep True for SVSP
    classification, which trains its inducing inputs."""
    ref_fn = L.kernel_fn_of(get_cnn_layer(num_hiddens, num_class, act, w_std, b_std,
                                          last_w_std, channels=channels))

    def kernel_fn(x1, x2=None, get="nngp"):
        if get == "nngp" and x1.ndim == 4 and x1.shape[1] * x1.shape[2] <= CG.MAX_HW:
            return CG.cnn_gram(x1, x1 if x2 is None else x2, depth=num_hiddens, act=act,
                               w_std=w_std, b_std=b_std, last_w_std=last_w_std,
                               trainable_inputs=trainable_inputs)
        return ref_fn(x1, x2, get=get)

    return kernel_fn


def get_conv_resnet_kernel(num_hiddens, num_class=1, act="relu", w_std=1.0, b_std=0.0,
                           last_w_std=1.0, k=1, trainable_inputs=True):
    """Conv-WideResNet kernel_fn: NNGP blocks of [N, H, W, C] images with
    H W <= 1,024 go to the fused WideResNet Gram (K5 and K6); larger images
    and 2-D inputs go to the layer tier, as in the JAX package.

    ``trainable_inputs=False``: the backward differentiates the three scales
    only and gives x zero cotangents (the same layer-tier recompute; there
    is no scalar-tangent kernel for this network)."""
    ref_fn = L.kernel_fn_of(get_conv_resnet_layer(num_hiddens, num_class, act, w_std,
                                                  b_std, last_w_std, k=k))

    def kernel_fn(x1, x2=None, get="nngp"):
        if get == "nngp" and x1.ndim == 4 and x1.shape[1] * x1.shape[2] <= RG.MAX_HW:
            return RG.conv_resnet_gram(x1, x1 if x2 is None else x2, depth=num_hiddens,
                                       num_class=num_class, act=act, w_std=w_std,
                                       b_std=b_std, last_w_std=last_w_std,
                                       trainable_inputs=trainable_inputs)
        return ref_fn(x1, x2, get=get)

    return kernel_fn


MYRTLE_SIDES = (8, 16, 32)   # the fused Myrtle Gram's image sides


def get_myrtle_kernel(depth=5, num_class=1, act="relu", w_std=1.0, b_std=0.0,
                      last_w_std=1.0, trainable_inputs=True):
    """Myrtle-{5,7,10} kernel_fn (the full spatial-covariance tier with 2 x 2
    average pools and GAP, :func:`snngp_torch.nn.full.get_myrtle_kernel`):
    NNGP blocks of square [N, h, h, C] images with h in 8, 16, 32 go to the
    fused Myrtle Gram (K7 on the card); other shapes and ``get="ntk"`` go to
    the full tier, as in the JAX package.

    ``trainable_inputs=False``: scalar-only gradients through K7's tangent
    mode, with zero x cotangents (the ML-II configuration and ``cls tr -n
    myrtle``, whose inducing inputs are frozen)."""
    from snngp_torch.nn.full import get_myrtle_kernel as full_myrtle
    ref_fn = full_myrtle(depth, num_class, act, w_std=w_std, b_std=b_std,
                         last_w_std=last_w_std)

    def kernel_fn(x1, x2=None, get="nngp"):
        if (get == "nngp" and x1.ndim == 4 and x1.shape[1] == x1.shape[2]
                and x1.shape[1] in MYRTLE_SIDES):
            return MG.myrtle_gram(x1, x1 if x2 is None else x2, depth=depth, act=act,
                                  w_std=w_std, b_std=b_std, last_w_std=last_w_std,
                                  trainable_inputs=trainable_inputs)
        return ref_fn(x1, x2, get=get)

    return kernel_fn


KERNELS = {
    "mlp": get_mlp_kernel,
    "cnn": get_cnn_kernel,
    "resnet-conv": get_conv_resnet_kernel,
    "resnet-dense": get_dense_resnet_kernel,
    "myrtle": get_myrtle_kernel,
}
