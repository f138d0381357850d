"""Fused CNN-NNGP Gram (K3) and its scalar-tangent backward (K4);
counterpart of ``snngp/ops/pallas/conv_gram.py``.

The CNN kernel (``arch.get_cnn_layer``: depth x [Conv 3x3 SAME stride 1 +
act], Flatten, Dense) runs on the matched-pixel state, one [H, W] image of
covariances per pair of inputs. The layer tier materializes that
[N1, N2, H, W] state once per layer; the fused Gram runs the whole depth
recursion per pair and writes one number:

- the variance maps (the diagonal recursion, O(N HW depth)) run outside the
  kernel (:func:`conv_var_stack`);
- the kernel computes the input moment sum_c x1 x2 / C per pixel in its own
  body, then depth x [3 x 3 SAME stencil mean -> w^2 (.) + b^2 -> dual
  activation], fed the per-layer variance maps, then the Flatten readout
  last^2 / HW sum_p k.

:func:`cnn_gram` goes through one ``torch.autograd.Function`` on both
devices, with the JAX package's ``trainable_inputs`` contract (as
:mod:`snngp_torch.ops.gram` does for the MLP Gram):

- forward: K3 (``csrc/conv_gram.cu``, :func:`conv_gram_cuda`) for a CUDA
  tensor, with ``same=True`` for K(x, x), :func:`conv_gram_plain` for a
  CPU tensor;
- backward with ``trainable_inputs=False`` (only the three scales are
  trained): the variance maps and their tangents (``torch.func.jvp``), then
  K4 (:func:`conv_gram_grads_cuda`, with ``same=True`` for K(x, x)) for a
  CUDA tensor or its plain version
  (:func:`conv_gram_grads_plain`) for a CPU tensor, which return
  (g . dK/dw_std, g . dK/db_std, g . dK/dlast_w_std); x1 and x2 get zero
  cotangents;
- backward with ``trainable_inputs=True`` (SVSP, which trains its inducing
  inputs): recompute through the layer tier and differentiate it, x
  cotangents included. No kernel runs there, as in the JAX package.

A CUDA tensor never reaches a plain version: the wrappers launch their
kernel or raise. ``LAUNCHES`` counts the launches of each kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from snngp_torch.ops import _build
from snngp_torch.ops.gram import _ACT_T, _ACT_T_PARTIALS, _ACTS, _check_same, _post_act_var

__all__ = ["cnn_gram", "conv_var_stack", "conv_gram_plain", "conv_gram_cuda",
           "conv_gram_tangents_plain", "conv_gram_grads_plain", "conv_gram_grads_cuda",
           "grads_blocks", "stream_geometry", "MAX_HW", "LAUNCHES"]

# Launches of each CUDA kernel in this process; the wrappers add one per
# launch. "conv_gram" is K3, "conv_gram_grads" is K4.
LAUNCHES = {"conv_gram": 0, "conv_gram_grads": 0}

MAX_HW = 1024          # the route's gate (arch.get_cnn_kernel), as in the JAX package
_INT_MAX = 2**31 - 1


def conv_var_stack(x: torch.Tensor, depth: int, act: str, w_std, b_std) -> torch.Tensor:
    """Pre-activation variance maps per layer: [depth + 1, N, H, W].

    Row 0 is the input's channel mean of squares; row l is the variance map
    entering the l-th activation (``_conv_var_stack`` in the JAX package,
    with the closed-form post-activation variance of
    :func:`snngp_torch.ops.gram._post_act_var`)."""
    from snngp_torch.nn.layers import _patch_mean
    w2 = w_std * w_std
    b2 = b_std * b_std
    v = torch.mean(x * x, dim=-1)
    out = [v]
    for _ in range(depth):
        v = w2 * _patch_mean(v, (3, 3), (1, 1)) + b2
        out.append(v)
        v = _post_act_var(v, act)
    return torch.stack(out)


def _stencil(k: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """3 x 3 SAME mean on the flattened pixel axis, zeros off the edge, in
    the kernel's order: column sums (z + left) + right, then row sums
    (zc + up) + down, then / 9."""
    z = k.reshape(k.shape[:-1] + (h, w))
    zc = z + F.pad(z[..., :, :-1], (1, 0)) + F.pad(z[..., :, 1:], (0, 1))
    zr = zc + F.pad(zc[..., :-1, :], (0, 0, 1, 0)) + F.pad(zc[..., 1:, :], (0, 0, 0, 1))
    return (zr / 9.0).reshape(k.shape)


def _moment(x1, x2, inv_c):
    """k0 [N1, N2, HW]: the input moment per matched pixel."""
    n1, h, w, c = x1.shape
    a = x1.reshape(n1, h * w, c)
    b = x2.reshape(x2.shape[0], h * w, c)
    return torch.einsum("ipc,jpc->ijp", a, b) * inv_c


def conv_gram_plain(x1, x2, v1s, v2s, scales, *, depth: int, act: str):
    """K3's plain PyTorch version, on the kernel's own inputs: images
    x1 [N1, H, W, C], x2 [N2, H, W, C], variance maps v1s [depth+1, N1, HW],
    v2s [depth+1, N2, HW] and ``scales`` = [w^2, b^2, last^2, 1/C]."""
    w2, b2, last2, inv_c = scales.unbind()
    h, w = x1.shape[1:3]
    t_fn = _ACT_T[act]
    k = _moment(x1, x2, inv_c)
    for layer in range(1, depth + 1):
        k = t_fn(w2 * _stencil(k, h, w) + b2, v1s[layer][:, None, :], v2s[layer][None, :, :])
    return (last2 / (h * w)) * torch.sum(k, dim=-1)


def conv_gram_tangents_plain(x1, x2, v1s, v2s, dv1s, dv2s, scales, *, depth: int,
                             act: str):
    """The four Grams of K4 as the TPU kernel computes them: (K, dK/dw_std,
    dK/db_std, dK/dlast_w_std). ``dv1s`` [2, depth+1, N1, HW] and ``dv2s``
    [2, depth+1, N2, HW] are the variance maps' tangents in (w_std, b_std);
    ``scales`` = [w^2, b^2, last^2, 1/C, w, b, last]. The stencil is linear,
    so the tangents go through it too: du/dw = w^2 S(dk/dw) + 2 w S(k),
    du/db = w^2 S(dk/db) + 2 b."""
    w2, b2, last2, inv_c, ws, bs, ls = scales.unbind()
    h, w = x1.shape[1:3]
    partials = _ACT_T_PARTIALS[act]
    k = _moment(x1, x2, inv_c)
    dkw = torch.zeros_like(k)
    dkb = torch.zeros_like(k)
    for layer in range(1, depth + 1):
        sk = _stencil(k, h, w)
        u = w2 * sk + b2
        duw = w2 * _stencil(dkw, h, w) + (2.0 * ws) * sk
        dub = w2 * _stencil(dkb, h, w) + 2.0 * bs
        t, tk, tv1, tv2 = partials(u, v1s[layer][:, None, :], v2s[layer][None, :, :])
        dkw = tk * duw + tv1 * dv1s[0, layer][:, None, :] + tv2 * dv2s[0, layer][None, :, :]
        dkb = tk * dub + tv1 * dv1s[1, layer][:, None, :] + tv2 * dv2s[1, layer][None, :, :]
        k = t

    def flat(z, s):
        return (s / (h * w)) * torch.sum(z, dim=-1)

    return flat(k, last2), flat(dkw, last2), flat(dkb, last2), flat(k, 2.0 * ls)


def conv_gram_grads_plain(x1, x2, v1s, v2s, dv1s, dv2s, scales, g, *, depth: int,
                          act: str) -> torch.Tensor:
    """K4's plain PyTorch version: [sum g dK/dw, sum g dK/db, sum g dK/dlast]
    in float64, from :func:`conv_gram_tangents_plain`'s Grams."""
    _, dkw, dkb, dkl = conv_gram_tangents_plain(x1, x2, v1s, v2s, dv1s, dv2s, scales,
                                                depth=depth, act=act)
    g64 = g.double()
    return torch.stack([torch.sum(g64 * t.double()) for t in (dkw, dkb, dkl)])


# -- the CUDA kernels -----------------------------------------------------------

def stream_geometry(h: int, w: int):
    """The streamed kernels' layout of an [h, w] state (K3-K6): (lanes,
    rows, lg, rstride, cstride). Lane c of a segment of 2^lg >= lanes lanes
    owns column c, so a warp holds 32 / 2^lg pairs, and the rows stream;
    element (r, c) is pixel r * rstride + c * cstride. An image wider than
    32 runs transposed (h w <= 1,024 keeps its h <= 32): its columns
    stream and its rows take the lanes, which changes only the order of
    the stencil's sums."""
    if w > 32:
        lanes, rows, strides = h, w, (1, w)
    else:
        lanes, rows, strides = w, h, (w, 1)
    if not 1 <= lanes <= 32:
        raise ValueError(f"{h} x {w}: the streamed kernels need a side of at most 32")
    return lanes, rows, (lanes - 1).bit_length(), *strides


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv_gram")
    fn = lib.snngp_conv_gram_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.snngp_conv_gram_grads_f32
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.snngp_conv_gram_grads_blocks
    fn.argtypes = [ctypes.c_int] * 7
    fn.restype = ctypes.c_longlong
    lib.snngp_conv_error_string.argtypes = [ctypes.c_int]
    lib.snngp_conv_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda_inputs(tensors, depth, act):
    """Device, dtype, contiguity and the shapes both kernels share;
    ``tensors`` maps names to tensors, x1 first. Returns (n1, n2, h, w, c)."""
    if act not in _ACTS:
        raise KeyError(f"unsupported act '{act}'")
    x1, x2 = tensors["x1"], tensors["x2"]
    for name, t in tensors.items():
        if t.device != x1.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the conv Gram kernels need "
                             f"every input on one CUDA device ({x1.device})")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the conv Gram kernels take float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if x1.ndim != 4 or x2.ndim != 4 or x1.shape[1:] != x2.shape[1:]:
        raise ValueError(f"x1, x2 must be [N, H, W, C] images of one shape; got "
                         f"{tuple(x1.shape)}, {tuple(x2.shape)}")
    n1, h, w, c = x1.shape
    n2 = x2.shape[0]
    if min(n1, n2, h, w, c) < 1:
        raise ValueError(f"empty input: x1 {tuple(x1.shape)}, x2 {tuple(x2.shape)}")
    if h * w > MAX_HW:
        raise ValueError(f"{h} x {w} images exceed the kernels' {MAX_HW} pixels")
    if depth < 0:
        raise ValueError(f"depth {depth} < 0")
    v1s, v2s = tensors["v1s"], tensors["v2s"]
    if v1s.shape != (depth + 1, n1, h * w) or v2s.shape != (depth + 1, n2, h * w):
        raise ValueError(f"variance maps {tuple(v1s.shape)}, {tuple(v2s.shape)} do not "
                         f"match depth {depth}, n = ({n1}, {n2}) and HW = {h * w}")
    return n1, n2, h, w, c


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({lib.snngp_conv_error_string(err).decode()})")


def conv_gram_cuda(x1, x2, v1s, v2s, scales, *, depth: int, act: str, same: bool = False):
    """Launch K3 (``csrc/conv_gram.cu``) on the current stream; same inputs
    and result as :func:`conv_gram_plain`. ``same=True`` says that x2 and
    v2s are x1 and v1s: the kernel runs each pair j <= i once and writes
    both entries, so K(x, x) is bitwise symmetric."""
    _check_same(same, dict(x=(x1, x2), v=(v1s, v2s)))
    n1, n2, h, w, c = _check_cuda_inputs(dict(x1=x1, x2=x2, v1s=v1s, v2s=v2s,
                                              scales=scales), depth, act)
    if scales.shape != (4,):
        raise ValueError(f"scales must be [4]; got {tuple(scales.shape)}")
    if (depth + 1) * max(n1, n2) * h * w > _INT_MAX:
        raise ValueError(f"{depth + 1} x {max(n1, n2)} variance maps of {h * w} pixels "
                         "exceed the kernel's int indices")
    lanes, rows, lg, rstride, cstride = stream_geometry(h, w)
    lib = _lib()
    out = torch.empty((n1, n2), dtype=torch.float32, device=x1.device)
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.snngp_conv_gram_f32(
            x1.data_ptr(), x2.data_ptr(), v1s.data_ptr(), v2s.data_ptr(),
            scales.data_ptr(), out.data_ptr(), n1, n2, lanes, rows, lg, rstride, cstride,
            c, depth, _ACTS[act], int(same), stream)
    _raise_on(lib, err, "conv Gram kernel")
    LAUNCHES["conv_gram"] += 1
    return out


def grads_blocks(n1: int, n2: int, h: int, w: int, depth: int, same: bool) -> int:
    """The blocks of a K4 launch on these shapes, each writing one float64
    triple: the columns of its partial sums. Read from the kernel's library
    (``snngp_conv_gram_grads_blocks``), which sizes the launch itself."""
    lanes, rows, lg, _, _ = stream_geometry(h, w)
    blocks = _lib().snngp_conv_gram_grads_blocks(n1, n2, lanes, rows, lg, depth, int(same))
    if blocks < 0:
        raise ValueError(f"{n1} x {n2} pairs of {h} x {w} images at depth {depth} do not "
                         "fit one K4 launch")
    return blocks


def conv_gram_grads_cuda(x1, x2, v1s, v2s, dv1s, dv2s, scales, g, *, depth: int,
                         act: str, same: bool = False) -> torch.Tensor:
    """Launch K4 (``csrc/conv_gram.cu``) on the current stream; same inputs
    and result as :func:`conv_gram_grads_plain`: the three float64 sums. The
    kernel writes one partial triple per block; they are added here in
    float64. ``same=True`` says that x2, v2s and dv2s are x1, v1s and dv1s:
    the kernel runs each pair j <= i once and weights it by g[i, j] +
    g[j, i], so g need not be symmetric."""
    _check_same(same, dict(x=(x1, x2), v=(v1s, v2s), dv=(dv1s, dv2s)))
    n1, n2, h, w, c = _check_cuda_inputs(
        dict(x1=x1, x2=x2, v1s=v1s, v2s=v2s, dv1s=dv1s, dv2s=dv2s, scales=scales, g=g),
        depth, act)
    hw = h * w
    if dv1s.shape != (2, depth + 1, n1, hw) or dv2s.shape != (2, depth + 1, n2, hw):
        raise ValueError(f"variance tangents {tuple(dv1s.shape)}, {tuple(dv2s.shape)} "
                         f"do not match depth {depth}, n = ({n1}, {n2}) and HW = {hw}")
    if scales.shape != (7,):
        raise ValueError(f"scales must be [7]; got {tuple(scales.shape)}")
    if g.shape != (n1, n2):
        raise ValueError(f"cotangent {tuple(g.shape)} does not match ({n1}, {n2})")
    if 2 * (depth + 1) * max(n1, n2) * hw > _INT_MAX:
        raise ValueError(f"2 x {depth + 1} x {max(n1, n2)} variance tangents of {hw} "
                         "pixels exceed the kernel's int indices")
    geometry = stream_geometry(h, w)
    lib = _lib()
    partial = torch.empty((3, grads_blocks(n1, n2, h, w, depth, same)), dtype=torch.float64,
                          device=x1.device)
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.snngp_conv_gram_grads_f32(
            x1.data_ptr(), x2.data_ptr(), v1s.data_ptr(), v2s.data_ptr(),
            dv1s.data_ptr(), dv2s.data_ptr(), scales.data_ptr(), g.data_ptr(),
            partial.data_ptr(), n1, n2, *geometry, c, depth, _ACTS[act], int(same), stream)
    _raise_on(lib, err, "conv Gram gradient kernel")
    LAUNCHES["conv_gram_grads"] += 1
    return partial.sum(dim=1)


# -- autograd -------------------------------------------------------------------

def _flat_stack(x, depth, act, w, b):
    v = conv_var_stack(x, depth, act, w, b)
    return v.reshape(depth + 1, x.shape[0], -1)


def _stack_with_tangents(x, depth, act, w, b):
    """(v, [dv/dw_std, dv/db_std]) of the flattened variance maps:
    forward-mode AD of the O(N HW depth) recursion
    (``_conv_var_stack_with_tangents`` in the JAX package)."""
    v, dv_w = torch.func.jvp(lambda ww: _flat_stack(x, depth, act, ww, b),
                             (w,), (torch.ones_like(w),))
    _, dv_b = torch.func.jvp(lambda bb: _flat_stack(x, depth, act, w, bb),
                             (b,), (torch.ones_like(b),))
    return v, torch.stack([dv_w, dv_b])


def _reference_recursion(x1, x2, depth, act, w, b, last):
    """The layer tier's Gram, the backward surrogate of the
    ``trainable_inputs=True`` contract."""
    from snngp_torch.nn import arch, layers
    return layers.kernel_fn_of(arch.get_cnn_layer(depth, 1, act, w, b, last))(
        x1, x2, get="nngp")


def _inv_c(x1, w):
    return torch.full((), 1.0 / x1.shape[-1], dtype=w.dtype, device=w.device)


class _ConvGram(torch.autograd.Function):
    """Fused CNN Gram with the JAX package's two backward contracts."""

    @staticmethod
    def forward(ctx, x1, x2, w, b, last, depth, act, trainable_inputs, same):
        v1s = _flat_stack(x1, depth, act, w, b)
        v2s = v1s if same else _flat_stack(x2, depth, act, w, b)
        scales = torch.stack([w * w, b * b, last * last, _inv_c(x1, w)])
        ctx.save_for_backward(x1, x2, w, b, last)
        ctx.conf = (depth, act, trainable_inputs, same)
        if x1.device.type == "cpu":
            return conv_gram_plain(x1, x2, v1s, v2s, scales, depth=depth, act=act)
        a, v = x1.contiguous(), v1s.contiguous()
        b, u = (a, v) if same else (x2.contiguous(), v2s.contiguous())
        return conv_gram_cuda(a, b, v, u, scales, depth=depth, act=act, same=same)

    @staticmethod
    def backward(ctx, g):
        x1, x2, w, b, last = ctx.saved_tensors
        depth, act, trainable_inputs, same = ctx.conf
        if trainable_inputs:
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(need)
                          for t, need in zip((x1, x2, w, b, last), ctx.needs_input_grad)]
                a1, a2, ww, bb, ll = leaves
                k = _reference_recursion(a1, a1 if same else a2, depth, act, ww, bb, ll)
                wanted = [t for t in leaves if t.requires_grad]
                grads = iter(torch.autograd.grad(k, wanted, g, allow_unused=True))
            out = [next(grads) if t.requires_grad else None for t in leaves]
            return (*out, None, None, None, None)

        with torch.no_grad():
            v1s, dv1s = _stack_with_tangents(x1, depth, act, w, b)
            v2s, dv2s = ((v1s, dv1s) if same
                         else _stack_with_tangents(x2, depth, act, w, b))
            scales = torch.stack([w * w, b * b, last * last, _inv_c(x1, w), w, b, last])
            if x1.device.type == "cpu":
                sums = conv_gram_grads_plain(x1, x2, v1s, v2s, dv1s, dv2s, scales, g,
                                             depth=depth, act=act)
            else:
                a, v, dv = x1.contiguous(), v1s.contiguous(), dv1s.contiguous()
                b, u, du = ((a, v, dv) if same
                            else (x2.contiguous(), v2s.contiguous(), dv2s.contiguous()))
                sums = conv_gram_grads_cuda(a, b, v, u, dv, du, scales.contiguous(),
                                            g.contiguous(), depth=depth, act=act,
                                            same=same)
        gw, gb, gl = (s.to(w.dtype) for s in sums.unbind())
        zero_x = [torch.zeros_like(x) if need else None
                  for x, need in zip((x1, x2), ctx.needs_input_grad[:2])]
        return (*zero_x, gw, gb, gl, None, None, None, None)


def cnn_gram(x1: torch.Tensor, x2: torch.Tensor, *, depth: int, act: str = "relu",
             w_std, b_std, last_w_std, trainable_inputs: bool = True) -> torch.Tensor:
    """Fused CNN-NNGP Gram of [N, H, W, C] images — equals
    ``arch.get_cnn_layer(depth, act=act, ...)``'s kernel on (x1, x2)
    (stride-1 SAME 3 x 3 convs, Flatten + Dense readout).

    ``trainable_inputs=False`` switches the backward to K4, the fused
    scalar-tangent kernel: x1 / x2 get zero cotangents by contract (only
    the three scales are trained). Keep True for SVSP classification, which
    trains its inducing inputs."""
    if act not in _ACT_T:
        raise KeyError(f"unsupported act '{act}'")
    like = dict(dtype=x1.dtype, device=x1.device)
    w = torch.as_tensor(w_std, **like)
    b = torch.as_tensor(b_std, **like)
    last = torch.as_tensor(last_w_std, **like)
    return _ConvGram.apply(x1, x2, w, b, last, depth, act, trainable_inputs, x2 is x1)
