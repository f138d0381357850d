"""Fused conv-WideResNet NNGP Gram: the stride-1 residual tail (K5) and the
stride-2 group-boundary block (K6); counterpart of
``snngp/ops/pallas/resnet_conv_gram.py``.

The WideResNet kernel (``arch.get_conv_resnet_layer``: an initial Conv, four
groups of residual blocks, the last three opened by a stride-2 block, then
Flatten and Dense) runs on the matched-pixel state, one [H, W] image of
covariances per pair of inputs. :func:`conv_resnet_gram` computes it as the
JAX package does:

- the input moment and the initial conv in plain PyTorch (XLA in the JAX
  package);
- group 1 (stride 1): K5 over all its blocks, the first with a conv
  shortcut (``mismatch``): one launch for up to four blocks (the kernel's
  limit), more chained (:func:`tail_chunks`);
- groups 2-4: one K6 launch for the leading stride-2 block, then K5 over
  the remaining ``depth - 1`` blocks;
- the readout ``last^2 mean_p k``.

The variance maps (the diagonal recursion, O(N HW depth)) run outside the
kernels (:func:`tail_var_stack`, :func:`strided_var_pieces`). K6 computes
its block at the reduced resolution directly: the stride-2 stencils are
evaluated only at the (oh, ow) lattice points (:func:`_stride2_offsets`),
where the TPU kernel ran at full resolution and XLA subsampled afterwards.
For K(x, x) every K5 and K6 launch takes ``same=True``: the state
entering each is bitwise symmetric, so the kernels run the pairs j <= i
and mirror them.

:func:`conv_resnet_gram` goes through one ``torch.autograd.Function``:
the kernels for CUDA tensors, :func:`resnet_tail_plain` /
:func:`strided_block_plain` for CPU tensors; the backward recomputes through
the layer tier and differentiates it, as the JAX package's ``custom_vjp``
does. There is no scalar-tangent kernel for the resnet in either package:
``trainable_inputs=False`` asks the same recompute for the three scales
only, and x gets zero cotangents.

A CUDA tensor never reaches a plain version: the wrappers launch their
kernel or raise. ``LAUNCHES`` counts the launches of each kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from snngp_torch.ops import _build
from snngp_torch.ops.conv_gram import _INT_MAX, _stencil, stream_geometry
from snngp_torch.ops.gram import _ACT_T, _ACTS, _check_same, _post_act_var

__all__ = ["conv_resnet_gram", "tail_var_stack", "strided_var_pieces",
           "resnet_tail_plain", "strided_block_plain", "resnet_tail_cuda",
           "strided_cuda", "strided_geometry", "tail_chunks", "MAX_HW", "LAUNCHES"]

# Launches of each CUDA kernel in this process; the wrappers add one per
# launch. "resnet_tail" is K5, "resnet_strided" is K6.
LAUNCHES = {"resnet_tail": 0, "resnet_strided": 0}

MAX_HW = 1024     # the route's gate (arch.get_conv_resnet_kernel), as in the JAX package


def _stride2_offsets(h: int, w: int):
    """Lattice offsets (oh, ow) such that SAME stride-2 3x3 conv output (i, j)
    equals the SAME stride-1 conv output at (2i + oh, 2j + ow): an even
    extent pads at the high end only (window centred at 2i + 1), an odd one
    at both ends (centred at 2i)."""
    return (1 if h % 2 == 0 else 0), (1 if w % 2 == 0 else 0)


def _half(n: int) -> int:
    return -(-n // 2)


def _flat(v: torch.Tensor) -> torch.Tensor:
    """[..., H, W] -> [..., H W], contiguous: the kernels' layout of the
    variance maps."""
    return v.reshape(v.shape[:-2] + (-1,)).contiguous()


def _lattice(z: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[..., H W] -> [..., ceil(H/2) ceil(W/2)]: the values at the stride-2
    lattice points (2a + oh, 2b + ow)."""
    oh, ow = _stride2_offsets(h, w)
    lead = z.shape[:-1]
    return z.reshape(lead + (h, w))[..., oh::2, ow::2].reshape(lead + (-1,))


# -- the variance maps --------------------------------------------------------------

def tail_var_stack(v: torch.Tensor, nblocks: int, act: str, w_std, b_std,
                   mismatch: bool = False):
    """Variance maps entering each activation of the tail blocks
    (``_tail_var_stack`` in the JAX package, with the closed-form
    post-activation variance of :func:`snngp_torch.ops.gram._post_act_var`).

    v: [N, H, W] entering the first block. Returns ([2 nblocks, N, H, W],
    the variance leaving the last block)."""
    from snngp_torch.nn.layers import _patch_mean
    w2 = w_std * w_std
    b2 = b_std * b_std
    rows = []
    for blk in range(nblocks):
        rows.append(v)                                              # enters act 1
        c1 = w2 * _patch_mean(_post_act_var(v, act), (3, 3), (1, 1)) + b2
        rows.append(c1)                                             # enters act 2
        main = w2 * _patch_mean(_post_act_var(c1, act), (3, 3), (1, 1)) + b2
        if mismatch and blk == 0:
            v = main + (w2 * _patch_mean(v, (3, 3), (1, 1)) + b2)   # conv shortcut
        else:
            v = v + main
    return torch.stack(rows), v


def strided_var_pieces(v: torch.Tensor, act: str, w_std, b_std):
    """Variance recursion through a stride-2 mismatch block
    (``_strided_var_pieces`` in the JAX package). v: [N, H, W] entering the
    block. Returns (v_mid [N, H2, W2] entering the second activation, v_out
    [N, H2, W2] leaving the block)."""
    from snngp_torch.nn.layers import _patch_mean
    w2 = w_std * w_std
    b2 = b_std * b_std
    c1 = w2 * _patch_mean(_post_act_var(v, act), (3, 3), (2, 2)) + b2
    main = w2 * _patch_mean(_post_act_var(c1, act), (3, 3), (1, 1)) + b2
    sc = w2 * _patch_mean(v, (3, 3), (2, 2)) + b2
    return c1, main + sc


# -- the plain versions ---------------------------------------------------------------

def resnet_tail_plain(k, v1s, v2s, scales, *, nblocks: int, act: str, h: int, w: int,
                      mismatch: bool = False):
    """K5's plain PyTorch version, in the kernel's order: ``nblocks``
    stride-1 residual blocks on k [N1, N2, HW], fed the variance rows
    v1s [2 nblocks, N1, HW], v2s [2 nblocks, N2, HW] and ``scales`` =
    [w^2, b^2]. Per block t1 = T(k), c1 = w^2 S(t1) + b^2, t2 = T(c1),
    k <- k + w^2 S(t2) + b^2; with ``mismatch`` block 0 takes the conv
    shortcut, (w^2 S(t2) + b^2) + (w^2 S(k) + b^2)."""
    w2, b2 = scales.unbind()
    t_fn = _ACT_T[act]
    for blk in range(nblocks):
        t1 = t_fn(k, v1s[2 * blk][:, None, :], v2s[2 * blk][None, :, :])
        c1 = w2 * _stencil(t1, h, w) + b2
        t2 = t_fn(c1, v1s[2 * blk + 1][:, None, :], v2s[2 * blk + 1][None, :, :])
        if mismatch and blk == 0:
            k = (w2 * _stencil(t2, h, w) + b2) + (w2 * _stencil(k, h, w) + b2)
        else:
            k = k + w2 * _stencil(t2, h, w) + b2
    return k


def strided_block_plain(k, v1s, v2s, scales, *, act: str, h: int, w: int):
    """K6's plain PyTorch version, in the kernel's order: a group's leading
    stride-2 mismatch block on k [N1, N2, H W], returning the reduced
    [N1, N2, H2 W2] state (H2, W2 the ceil halves). ``v1s`` = (v_in
    [N1, H W], v_mid [N1, H2 W2]) and ``v2s`` likewise: the variances
    entering the block's two activations; ``scales`` = [w^2, b^2].

        t1 = T(k, v_in)                       full resolution
        c1 = w^2 S(t1)|lattice + b^2          the stride-2 conv
        t2 = T(c1, v_mid)                     reduced resolution
        c2 = w^2 S(t2) + b^2                  stride-1 conv, zeros off the reduced image
        out = c2 + (w^2 S(k)|lattice + b^2)   plus the stride-2 conv shortcut

    S(.)|lattice is the stride-1 stencil at the (oh, ow) lattice points."""
    w2, b2 = scales.unbind()
    (v1_in, v1_mid), (v2_in, v2_mid) = v1s, v2s
    t_fn = _ACT_T[act]
    t1 = t_fn(k, v1_in[:, None, :], v2_in[None, :, :])
    c1 = w2 * _lattice(_stencil(t1, h, w), h, w) + b2
    t2 = t_fn(c1, v1_mid[:, None, :], v2_mid[None, :, :])
    c2 = w2 * _stencil(t2, _half(h), _half(w)) + b2
    sc = w2 * _lattice(_stencil(k, h, w), h, w) + b2
    return c2 + sc


# -- the CUDA kernels -----------------------------------------------------------------

def tail_chunks(nblocks: int, mismatch: bool, per_launch: int):
    """K5's launches for a tail of ``nblocks`` blocks: (first block, blocks,
    conv shortcut) each, at most ``per_launch`` blocks a launch (the
    kernel's ``snngp_resnet_tail_max_blocks``), in order; only the first
    launch takes the conv shortcut."""
    return [(first, min(per_launch, nblocks - first), mismatch and first == 0)
            for first in range(0, nblocks, per_launch)]


def strided_geometry(h: int, w: int):
    """K6's streamed layout of an [h, w] state and its [ceil(h/2), ceil(w/2)]
    reduction: :func:`stream_geometry`'s (lanes, rows, lg, rstride, cstride),
    then (ors, ocs), reduced element (a, b) of the stream (a < ceil(rows /
    2), b < ceil(lanes / 2)) being pixel a * ors + b * ocs of the reduced
    state. The kernel reads the lattice offsets from the parity of rows and
    lanes, so a state wider than 32, which streams transposed, swaps the
    reduced strides and (oh, ow) with the full ones."""
    lanes, rows, lg, rstride, cstride = stream_geometry(h, w)
    wr = _half(w)
    return lanes, rows, lg, rstride, cstride, *((1, wr) if w > 32 else (wr, 1))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("resnet_conv_gram")
    fn = lib.snngp_resnet_tail_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.snngp_resnet_tail_max_blocks.argtypes = []
    lib.snngp_resnet_tail_max_blocks.restype = ctypes.c_int
    fn = lib.snngp_resnet_strided_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.snngp_resnet_error_string.argtypes = [ctypes.c_int]
    lib.snngp_resnet_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda_inputs(tensors, act, h, w):
    """Device, dtype, contiguity and the state's shape; ``tensors`` maps
    names to tensors, k first. Returns (n1, n2)."""
    if act not in _ACTS:
        raise KeyError(f"unsupported act '{act}'")
    k = tensors["k"]
    for name, t in tensors.items():
        if t.device != k.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the resnet Gram kernels need "
                             f"every input on one CUDA device ({k.device})")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the resnet Gram kernels take float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if k.ndim != 3 or min(k.shape[0], k.shape[1], h, w) < 1 or k.shape[2] != h * w:
        raise ValueError(f"k must be [N1, N2, {h} x {w}]; got {tuple(k.shape)}")
    if h * w > MAX_HW:
        raise ValueError(f"{h} x {w} images exceed the kernels' {MAX_HW} pixels")
    if tensors["scales"].shape != (2,):
        raise ValueError(f"scales must be [2]; got {tuple(tensors['scales'].shape)}")
    return k.shape[0], k.shape[1]


def _check_same_state(same, k, pairs):
    """``same=True`` (run the pairs j <= i and mirror them) only on K(x, x)'s
    square state, each second operand in ``pairs`` its first."""
    _check_same(same, pairs)
    if same and (k.ndim != 3 or k.shape[0] != k.shape[1]):
        raise ValueError(f"same=True needs K(x, x)'s state; got k {tuple(k.shape)}")


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({lib.snngp_resnet_error_string(err).decode()})")


def resnet_tail_cuda(k, v1s, v2s, scales, *, nblocks: int, act: str, h: int, w: int,
                     mismatch: bool = False, same: bool = False):
    """Launch K5 (``csrc/resnet_conv_gram.cu``) on the current stream, one
    launch per :func:`tail_chunks` entry; same inputs and result as
    :func:`resnet_tail_plain`. ``same=True`` says that k is K(x, x)'s state
    (bitwise symmetric) and v2s is v1s: the kernel runs each pair j <= i
    once and writes both entries."""
    _check_same_state(same, k, dict(v=(v1s, v2s)))
    n1, n2 = _check_cuda_inputs(dict(k=k, v1s=v1s, v2s=v2s, scales=scales), act, h, w)
    if nblocks < 1:
        raise ValueError(f"nblocks {nblocks} < 1")
    if v1s.shape != (2 * nblocks, n1, h * w) or v2s.shape != (2 * nblocks, n2, h * w):
        raise ValueError(f"variance rows {tuple(v1s.shape)}, {tuple(v2s.shape)} do not "
                         f"match {nblocks} blocks, n = ({n1}, {n2}) and HW = {h * w}")
    lanes, rows, lg, rstride, cstride = stream_geometry(h, w)
    lib = _lib()
    per_launch = lib.snngp_resnet_tail_max_blocks()
    if 2 * min(nblocks, per_launch) * max(n1, n2) * h * w > _INT_MAX:
        raise ValueError(f"{max(n1, n2)} variance rows of {h * w} pixels exceed the "
                         "kernel's int indices")
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream().cuda_stream
        for first, count, shortcut in tail_chunks(nblocks, mismatch, per_launch):
            out = torch.empty_like(k)
            err = lib.snngp_resnet_tail_f32(
                k.data_ptr(), v1s[2 * first].data_ptr(), v2s[2 * first].data_ptr(),
                scales.data_ptr(), out.data_ptr(), n1, n2, lanes, rows, lg, rstride,
                cstride, count, int(shortcut), _ACTS[act], int(same), stream)
            _raise_on(lib, err, "resnet tail kernel")
            LAUNCHES["resnet_tail"] += 1
            k = out
    return k


def strided_cuda(k, v1s, v2s, scales, *, act: str, h: int, w: int, same: bool = False):
    """Launch K6 (``csrc/resnet_conv_gram.cu``) on the current stream; same
    inputs and result as :func:`strided_block_plain`. ``same=True`` says
    that k is K(x, x)'s state (bitwise symmetric) and v2s is v1s: the
    kernel runs each pair j <= i once and writes both entries."""
    (v1_in, v1_mid), (v2_in, v2_mid) = v1s, v2s
    _check_same_state(same, k, dict(v_in=(v1_in, v2_in), v_mid=(v1_mid, v2_mid)))
    n1, n2 = _check_cuda_inputs(dict(k=k, v1_in=v1_in, v1_mid=v1_mid, v2_in=v2_in,
                                     v2_mid=v2_mid, scales=scales), act, h, w)
    hwr = _half(h) * _half(w)
    if (v1_in.shape != (n1, h * w) or v2_in.shape != (n2, h * w)
            or v1_mid.shape != (n1, hwr) or v2_mid.shape != (n2, hwr)):
        raise ValueError(f"variance rows {tuple(v1_in.shape)}, {tuple(v1_mid.shape)}, "
                         f"{tuple(v2_in.shape)}, {tuple(v2_mid.shape)} do not match "
                         f"n = ({n1}, {n2}), HW = {h * w} and the reduced {hwr}")
    if max(n1, n2) * h * w > _INT_MAX:
        raise ValueError(f"{max(n1, n2)} variance rows of {h * w} pixels exceed the "
                         "kernel's int indices")
    lib = _lib()
    out = torch.empty((n1, n2, hwr), dtype=torch.float32, device=k.device)
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.snngp_resnet_strided_f32(
            k.data_ptr(), v1_in.data_ptr(), v2_in.data_ptr(), v1_mid.data_ptr(),
            v2_mid.data_ptr(), scales.data_ptr(), out.data_ptr(), n1, n2,
            *strided_geometry(h, w), _ACTS[act], int(same), stream)
    _raise_on(lib, err, "resnet strided kernel")
    LAUNCHES["resnet_strided"] += 1
    return out


# -- the whole Gram -------------------------------------------------------------------

def _front(x1, x2, w2, b2, same):
    """The input moment and the initial Conv (plain PyTorch, as XLA runs
    them in the JAX package): (k [N1, N2, H, W], v1 [N1, H, W], v2)."""
    from snngp_torch.nn.layers import _patch_mean
    c = x1.shape[-1]
    # The moment summed in channel order, so K(x, x) is symmetric bitwise.
    k = x1[:, None, ..., 0] * x2[None, ..., 0]
    for ch in range(1, c):
        k = k + x1[:, None, ..., ch] * x2[None, ..., ch]
    k = k / c
    v1 = torch.mean(x1 * x1, dim=-1)
    v2 = v1 if same else torch.mean(x2 * x2, dim=-1)

    def conv(z):
        return w2 * _patch_mean(z, (3, 3), (1, 1)) + b2

    v1c = conv(v1)
    return conv(k), v1c, v1c if same else conv(v2)


def _resnet_forward(x1, x2, w, b, last, depth, act, same):
    """The Gram through K5 / K6 on CUDA tensors, their plain versions on
    CPU tensors (``_conv_resnet_gram`` in the JAX package); K(x, x) takes
    K5's and K6's symmetric launches."""
    plain = x1.device.type == "cpu"
    tail_fn = (resnet_tail_plain if plain
               else functools.partial(resnet_tail_cuda, same=same))
    strided_fn = (strided_block_plain if plain
                  else functools.partial(strided_cuda, same=same))
    w2, b2 = w * w, b * b
    scales = torch.stack([w2, b2])
    n1, n2 = x1.shape[0], x2.shape[0]
    k, v1, v2 = _front(x1, x2, w2, b2, same)
    h, wd = k.shape[2:]
    k = k.reshape(n1, n2, h * wd)

    def tail(k, v1, v2, nblocks, mismatch):
        s1, v1o = tail_var_stack(v1, nblocks, act, w, b, mismatch)
        s2, v2o = (s1, v1o) if same else tail_var_stack(v2, nblocks, act, w, b, mismatch)
        k = tail_fn(k, _flat(s1), _flat(s2), scales, nblocks=nblocks, act=act,
                    h=v1.shape[-2], w=v1.shape[-1], mismatch=mismatch)
        return k, v1o, v2o

    k, v1, v2 = tail(k, v1, v2, depth, True)              # group 1, stride 1
    for _ in range(3):                                    # groups 2-4, stride 2
        m1, o1 = strided_var_pieces(v1, act, w, b)
        m2, o2 = (m1, o1) if same else strided_var_pieces(v2, act, w, b)
        k = strided_fn(k, (_flat(v1), _flat(m1)), (_flat(v2), _flat(m2)),
                       scales, act=act, h=v1.shape[-2], w=v1.shape[-1])
        v1, v2 = o1, o2
        if depth > 1:
            k, v1, v2 = tail(k, v1, v2, depth - 1, False)
    return (last * last) * torch.mean(k, dim=-1)           # Flatten + Dense


def _reference_recursion(x1, x2, depth, act, w, b, last):
    """The layer tier's Gram, the backward's recompute."""
    from snngp_torch.nn import arch, layers
    return layers.kernel_fn_of(arch.get_conv_resnet_layer(depth, 1, act, w, b, last))(
        x1, x2, get="nngp")


class _ConvResnetGram(torch.autograd.Function):
    """Fused conv-WideResNet Gram; the backward recomputes through the
    layer tier (the JAX package's ``_bwd``)."""

    @staticmethod
    def forward(ctx, x1, x2, w, b, last, depth, act, trainable_inputs, same):
        ctx.save_for_backward(x1, x2, w, b, last)
        ctx.conf = (depth, act, trainable_inputs, same)
        return _resnet_forward(x1, x2, w, b, last, depth, act, same)

    @staticmethod
    def backward(ctx, g):
        x1, x2, w, b, last = ctx.saved_tensors
        depth, act, trainable_inputs, same = ctx.conf
        # trainable_inputs=False: only the scales are differentiated; x1 / x2
        # get zero cotangents by contract.
        need = [n and trainable_inputs for n in ctx.needs_input_grad[:2]]
        need += list(ctx.needs_input_grad[2:5])
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip((x1, x2, w, b, last), need)]
            a1, a2, ww, bb, ll = leaves
            k = _reference_recursion(a1, a1 if same else a2, depth, act, ww, bb, ll)
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(k, wanted, g, allow_unused=True)
                         if wanted else ())
        out = [next(grads) if t.requires_grad else None for t in leaves]
        for i in range(2):
            if ctx.needs_input_grad[i] and out[i] is None:
                out[i] = torch.zeros_like((x1, x2)[i])
        return (*out, None, None, None, None)


def conv_resnet_gram(x1: torch.Tensor, x2: torch.Tensor, *, depth: int, num_class: int = 1,
                     act: str = "relu", w_std, b_std, last_w_std,
                     trainable_inputs: bool = True) -> torch.Tensor:
    """Fused conv-WideResNet NNGP Gram of [N, H, W, C] images — equals
    ``arch.get_conv_resnet_layer(depth, num_class, act, ...)``'s kernel on
    (x1, x2). ``num_class`` does not change the NNGP (kept for the JAX
    signature). ``trainable_inputs=False``: x1 / x2 get zero cotangents and
    only the three scales are differentiated (the same recompute)."""
    del num_class
    if act not in _ACT_T:
        raise KeyError(f"unsupported act '{act}'")
    if depth < 1:
        raise ValueError(f"depth {depth} < 1")
    if x1.ndim != 4 or x2.ndim != 4 or x1.shape[1:] != x2.shape[1:]:
        raise ValueError(f"x1, x2 must be [N, H, W, C] images of one shape; got "
                         f"{tuple(x1.shape)}, {tuple(x2.shape)}")
    like = dict(dtype=x1.dtype, device=x1.device)
    w = torch.as_tensor(w_std, **like)
    b = torch.as_tensor(b_std, **like)
    last = torch.as_tensor(last_w_std, **like)
    return _ConvResnetGram.apply(x1, x2, w, b, last, depth, act, trainable_inputs,
                                 x2 is x1)
