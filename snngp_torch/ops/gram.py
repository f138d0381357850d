"""Fused MLP / dense-ResNet NNGP Gram (K1; counterpart of
``snngp/ops/pallas/gram.py``).

The layer tier (:mod:`snngp_torch.nn.layers`) materializes one [N1, N2]
state per layer. The fused Gram runs the whole depth recursion per output
element and writes each output once:

- the diagonal (variance) recursion is 1-D and runs outside the kernel
  (:func:`mlp_var_stack` / :func:`resnet_var_stack`, O(N depth));
- the kernel computes the input moment x1 x2^T / D in its own body and then
  applies the closed-form Dense / dual-activation recursion elementwise,
  fed the per-layer variance rows.

:func:`mlp_gram` / :func:`resnet_gram` dispatch on the device of ``x1``:

- a CPU tensor takes :func:`gram_plain`, the same fused recursion on whole
  tensors with ``torch.acos`` / ``torch.asin``;
- a CUDA tensor launches the hand-written CUDA kernel (``csrc/gram.cu``,
  :func:`gram_cuda`) or raises. There is no fallback.

``LAUNCHES`` counts the kernel's launches. Forward only: the kernel's
backward (the ML-II scalar-tangent kernel) comes with training, so a CUDA
call that autograd would record raises; serving runs under
``torch.inference_mode()``. CPU calls stay differentiable through the plain
version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from snngp_torch.ops import _build

__all__ = ["mlp_gram", "resnet_gram", "mlp_var_stack", "resnet_var_stack",
           "gram_plain", "gram_cuda", "LAUNCHES"]

# Launches of the CUDA kernel in this process (gram_cuda adds one per launch).
LAUNCHES = 0

_MODES = {"mlp": 0, "resnet": 1}
_ACTS = {"relu": 0, "erf": 1}
_MAX_DEPTH = 256  # the variance rows must fit the block's shared memory
_MAX_ROW_TILES = 65535  # grid.y limit, in 64-row tiles


def _post_act_var(v: torch.Tensor, act: str) -> torch.Tensor:
    """Variance after the activation, from the variance before it."""
    if act == "relu":
        return v / 2.0
    return (2.0 / math.pi) * torch.asin(torch.clamp(2.0 * v / (1.0 + 2.0 * v), -1.0, 1.0))


def mlp_var_stack(x: torch.Tensor, depth: int, act: str, w_std, b_std) -> torch.Tensor:
    """Pre-activation variances per hidden layer: [depth + 1, N].

    Row 0 is the input second moment |x|^2 / D; row l (1-indexed) is the
    variance after the l-th Dense, i.e. the v entering the l-th activation.
    """
    w2 = w_std * w_std
    b2 = b_std * b_std
    v = torch.sum(x * x, dim=-1) / x.shape[-1]
    out = [v]
    for _ in range(depth):
        v = w2 * v + b2                       # Dense
        out.append(v)
        v = _post_act_var(v, act)
    return torch.stack(out)


def resnet_var_stack(x: torch.Tensor, depth: int, act: str, w_std, b_std) -> torch.Tensor:
    """Pre-activation variances for the dense-ResNet recursion: row l is the
    variance entering block l's activation (l < depth) / the final
    activation (l == depth)."""
    w2 = w_std * w_std
    b2 = b_std * b_std
    v = torch.sum(x * x, dim=-1) / x.shape[-1]
    v = w2 * v + b2                           # initial Dense
    out = [v]
    for _ in range(depth):
        v = v + w2 * _post_act_var(v, act) + b2   # residual block
        out.append(v)
    return torch.stack(out)


def _relu_t(k, v1, v2):
    """Arccos kernel, written as the CUDA kernel computes it."""
    s = torch.sqrt(torch.clamp(v1 * v2, min=1e-30))
    c = torch.clamp(k / s, -1.0, 1.0)
    theta = torch.acos(c)
    sin_t = torch.sqrt(torch.clamp(1.0 - c * c, min=0.0))
    return (s * sin_t + (math.pi - theta) * k) * (0.5 / math.pi)


def _erf_t(k, v1, v2):
    """Arcsin kernel, written as the CUDA kernel computes it."""
    denom = torch.sqrt((1.0 + 2.0 * v1) * (1.0 + 2.0 * v2))
    return (2.0 / math.pi) * torch.asin(torch.clamp(2.0 * k / denom, -1.0, 1.0))


_ACT_T = {"relu": _relu_t, "erf": _erf_t}


def gram_plain(x1, x2, v1s, v2s, scales, *, depth: int, act: str, mode: str):
    """K1's plain PyTorch version, on the kernel's own inputs: variance
    stacks v1s [depth+1, N1], v2s [depth+1, N2] and ``scales`` =
    [w^2, b^2, last^2, 1/D]."""
    w2, b2, last2, inv_d = scales.unbind()
    t_fn = _ACT_T[act]
    k = (x1 @ x2.T) * inv_d
    if mode == "mlp":
        for layer in range(1, depth + 1):
            k = t_fn(w2 * k + b2, v1s[layer][:, None], v2s[layer][None, :])
        return last2 * k
    k = w2 * k + b2
    for layer in range(depth):
        k = k + w2 * t_fn(k, v1s[layer][:, None], v2s[layer][None, :]) + b2
    return last2 * t_fn(k, v1s[depth][:, None], v2s[depth][None, :])


def _check_cuda_inputs(x1, x2, v1s, v2s, scales, depth):
    tensors = {"x1": x1, "x2": x2, "v1s": v1s, "v2s": v2s, "scales": scales}
    for name, t in tensors.items():
        if t.device != x1.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the Gram kernel needs "
                             f"every input on one CUDA device ({x1.device})")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the Gram kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if x1.ndim != 2 or x2.ndim != 2:
        raise ValueError(f"x1, x2 must be 2-D; got {tuple(x1.shape)}, {tuple(x2.shape)}")
    n1, d = x1.shape
    n2 = x2.shape[0]
    if x2.shape[1] != d:
        raise ValueError(f"feature dims differ: {d} vs {x2.shape[1]}")
    if min(n1, n2, d) < 1:
        raise ValueError(f"empty input: x1 {tuple(x1.shape)}, x2 {tuple(x2.shape)}")
    if not 0 <= depth <= _MAX_DEPTH:
        raise ValueError(f"depth {depth} outside [0, {_MAX_DEPTH}]")
    if -(-n1 // 64) > _MAX_ROW_TILES:
        raise ValueError(f"n1 = {n1} exceeds the kernel's row grid")
    if v1s.shape != (depth + 1, n1) or v2s.shape != (depth + 1, n2):
        raise ValueError(f"variance stacks {tuple(v1s.shape)}, {tuple(v2s.shape)} "
                         f"do not match depth {depth} and n = ({n1}, {n2})")
    if scales.shape != (4,):
        raise ValueError(f"scales must be [4]; got {tuple(scales.shape)}")


def _gram_lib() -> ctypes.CDLL:
    lib = _build.load("gram")
    fn = lib.snngp_gram_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.snngp_error_string.argtypes = [ctypes.c_int]
    lib.snngp_error_string.restype = ctypes.c_char_p
    return lib


def gram_cuda(x1, x2, v1s, v2s, scales, *, depth: int, act: str, mode: str):
    """Launch the CUDA kernel (``csrc/gram.cu``) on the current stream; same
    inputs and result as :func:`gram_plain`."""
    global LAUNCHES
    if act not in _ACTS:
        raise KeyError(f"unsupported act '{act}'")
    if mode not in _MODES:
        raise KeyError(f"unsupported mode '{mode}'")
    _check_cuda_inputs(x1, x2, v1s, v2s, scales, depth)
    n1, d = x1.shape
    n2 = x2.shape[0]
    lib = _gram_lib()
    out = torch.empty((n1, n2), dtype=torch.float32, device=x1.device)
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.snngp_gram_f32(
            x1.data_ptr(), x2.data_ptr(), v1s.data_ptr(), v2s.data_ptr(),
            scales.data_ptr(), out.data_ptr(), n1, n2, d, depth,
            _MODES[mode], _ACTS[act], stream)
    if err != 0:
        raise RuntimeError(f"Gram kernel launch failed: CUDA error {err} "
                           f"({lib.snngp_error_string(err).decode()})")
    LAUNCHES += 1
    return out


def _gram(mode, x1, x2, depth, act, w_std, b_std, last_w_std):
    if act not in _ACT_T:
        raise KeyError(f"unsupported act '{act}'")
    like = dict(dtype=x1.dtype, device=x1.device)
    w = torch.as_tensor(w_std, **like)
    b = torch.as_tensor(b_std, **like)
    last = torch.as_tensor(last_w_std, **like)
    stack_fn = resnet_var_stack if mode == "resnet" else mlp_var_stack
    v1s = stack_fn(x1, depth, act, w, b)
    v2s = v1s if x2 is x1 else stack_fn(x2, depth, act, w, b)
    scales = torch.stack([w * w, b * b, last * last,
                          torch.full((), 1.0 / x1.shape[-1], **like)])
    if x1.device.type == "cpu":
        return gram_plain(x1, x2, v1s, v2s, scales, depth=depth, act=act, mode=mode)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x1, x2, w, b, last)):
        raise NotImplementedError("backward lands with K2")
    return gram_cuda(x1.contiguous(), x2.contiguous(), v1s.contiguous(),
                     v2s.contiguous(), scales, depth=depth, act=act, mode=mode)


def mlp_gram(x1: torch.Tensor, x2: torch.Tensor, *, depth: int, act: str = "relu",
             w_std, b_std, last_w_std) -> torch.Tensor:
    """Fused MLP-NNGP Gram — equals
    ``arch.get_mlp_layer(depth, act=act, ...)``'s kernel on (x1, x2)."""
    return _gram("mlp", x1, x2, depth, act, w_std, b_std, last_w_std)


def resnet_gram(x1: torch.Tensor, x2: torch.Tensor, *, depth: int, act: str = "relu",
                w_std, b_std, last_w_std) -> torch.Tensor:
    """Fused dense-ResNet NNGP Gram — equals
    ``arch.get_dense_resnet_layer(depth, ...)``'s kernel on (x1, x2)."""
    return _gram("resnet", x1, x2, depth, act, w_std, b_std, last_w_std)
