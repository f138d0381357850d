"""Fused MLP / dense-ResNet NNGP Gram (K1) and its scalar-tangent backward
(K2); counterpart of ``snngp/ops/pallas/gram.py``.

The layer tier (:mod:`snngp_torch.nn.layers`) materializes one [N1, N2]
state per layer. The fused Gram runs the whole depth recursion per output
element and writes each output once:

- the diagonal (variance) recursion is 1-D and runs outside the kernel
  (:func:`mlp_var_stack` / :func:`resnet_var_stack`, O(N depth));
- the kernel computes the input moment x1 x2^T / D in its own body and then
  applies the closed-form Dense / dual-activation recursion elementwise,
  fed the per-layer variance rows.

:func:`mlp_gram` / :func:`resnet_gram` go through one
``torch.autograd.Function`` on both devices, with the JAX package's
``trainable_inputs`` contract:

- forward: K1 (``csrc/gram.cu``, :func:`gram_cuda`, with ``same=True`` for
  K(x, x)) for a CUDA tensor, :func:`gram_plain` for a CPU tensor;
- backward with ``trainable_inputs=False`` (ML-II: only the three scales
  are trained): the variance stacks and their tangents (``torch.func.jvp``),
  then K2 (:func:`gram_grads_cuda`, with ``same=True`` for K(x, x)) for a
  CUDA tensor or its plain version
  (:func:`gram_grads_plain`) for a CPU tensor, which return
  (g . dK/dw_std, g . dK/db_std, g . dK/dlast_w_std); x1 and x2 get zero
  cotangents;
- backward with ``trainable_inputs=True``: recompute through the layer tier
  and differentiate it, x cotangents included. No kernel runs there, as in
  the JAX package.

A CUDA tensor never reaches a plain version: the wrappers launch their
kernel or raise. ``LAUNCHES`` counts the launches of each kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from snngp_torch.ops import _build

__all__ = ["mlp_gram", "resnet_gram", "mlp_var_stack", "resnet_var_stack",
           "gram_plain", "gram_cuda", "gram_tangents_plain", "gram_grads_plain",
           "gram_grads_cuda", "gram_blocks", "LAUNCHES"]

# Launches of each CUDA kernel in this process; the wrappers add one per
# launch. "gram" is K1, "gram_grads" is K2.
LAUNCHES = {"gram": 0, "gram_grads": 0}

_MODES = {"mlp": 0, "resnet": 1}
_ACTS = {"relu": 0, "erf": 1}
_MAX_ROW_TILES = 65535  # a cross launch's grid.y limit, in 64-row tiles
_TILE = 64
_INV_4PI = 0.25 / math.pi


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


_STACKS = {"mlp": mlp_var_stack, "resnet": resnet_var_stack}


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


def _relu_t_partials(k, v1, v2):
    """(T, dT/dk, dT/dv1, dT/dv2) of the arccos kernel, written as K2
    computes them: the analytic forms of the layer tier's backward, finite
    at the Gram's diagonal c = +-1."""
    s = torch.sqrt(torch.clamp(v1 * v2, min=1e-30))
    c = torch.clamp(k / s, -1.0, 1.0)
    theta = torch.acos(c)
    sin_t = torch.sqrt(torch.clamp(1.0 - c * c, min=0.0))
    q = sin_t / s * _INV_4PI
    t = (s * sin_t + (math.pi - theta) * k) * (0.5 / math.pi)
    return t, (math.pi - theta) * (0.5 / math.pi), q * v2, q * v1


def _erf_t_partials(k, v1, v2):
    """(T, dT/dk, dT/dv1, dT/dv2) of the arcsin kernel, written as K2
    computes them. The clip zeroes the gradient outside the strict interval
    |g| < 1, as autodiff through the reference tier does."""
    d1 = 1.0 + 2.0 * v1
    d2 = 1.0 + 2.0 * v2
    r = 1.0 / torch.sqrt(d1 * d2)
    g = 2.0 * k * r
    c = torch.clamp(g, -1.0, 1.0)
    inside = (g > -1.0) & (g < 1.0)
    base = torch.where(inside, (2.0 / math.pi) / torch.sqrt(torch.clamp(1.0 - c * c, min=1e-30)),
                       0.0)
    bgr2 = base * g * (r * r)                  # 1/d1 = r^2 d2, 1/d2 = r^2 d1
    t = (2.0 / math.pi) * torch.asin(c)
    return t, base * (2.0 * r), -bgr2 * d2, -bgr2 * d1


_ACT_T_PARTIALS = {"relu": _relu_t_partials, "erf": _erf_t_partials}


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


def gram_tangents_plain(x1, x2, v1s, v2s, dv1s, dv2s, scales, *, depth: int,
                        act: str, mode: str):
    """The four Grams of K2 as the TPU kernel computes them: (K, dK/dw_std,
    dK/db_std, dK/dlast_w_std). ``dv1s`` [2, depth+1, N1] and ``dv2s``
    [2, depth+1, N2] are the variance stacks' tangents in (w_std, b_std);
    ``scales`` = [w^2, b^2, last^2, 1/D, w, b, last]."""
    w2, b2, last2, inv_d, w, b, last = scales.unbind()
    partials = _ACT_T_PARTIALS[act]

    def rows(layer):
        return (v1s[layer][:, None], v2s[layer][None, :],
                dv1s[0, layer][:, None], dv2s[0, layer][None, :],
                dv1s[1, layer][:, None], dv2s[1, layer][None, :])

    k = (x1 @ x2.T) * inv_d
    if mode == "mlp":
        dkw = torch.zeros_like(k)
        dkb = torch.zeros_like(k)
        for layer in range(1, depth + 1):
            v1, v2, dw1, dw2, db1, db2 = rows(layer)
            u = w2 * k + b2                                     # Dense
            duw = w2 * dkw + (2.0 * w) * k
            dub = w2 * dkb + 2.0 * b
            t, tk, tv1, tv2 = partials(u, v1, v2)
            dkw = tk * duw + tv1 * dw1 + tv2 * dw2
            dkb = tk * dub + tv1 * db1 + tv2 * db2
            k = t
        return last2 * k, last2 * dkw, last2 * dkb, (2.0 * last) * k
    k0 = k
    k = w2 * k0 + b2                                            # initial Dense
    dkw = (2.0 * w) * k0
    dkb = torch.zeros_like(k0) + 2.0 * b
    for layer in range(depth):
        v1, v2, dw1, dw2, db1, db2 = rows(layer)
        t, tk, tv1, tv2 = partials(k, v1, v2)
        dtw = tk * dkw + tv1 * dw1 + tv2 * dw2
        dtb = tk * dkb + tv1 * db1 + tv2 * db2
        k = k + w2 * t + b2                                     # residual block
        dkw = dkw + w2 * dtw + (2.0 * w) * t
        dkb = dkb + w2 * dtb + 2.0 * b
    v1, v2, dw1, dw2, db1, db2 = rows(depth)
    t, tk, tv1, tv2 = partials(k, v1, v2)
    return (last2 * t, last2 * (tk * dkw + tv1 * dw1 + tv2 * dw2),
            last2 * (tk * dkb + tv1 * db1 + tv2 * db2), (2.0 * last) * t)


def gram_grads_plain(x1, x2, v1s, v2s, dv1s, dv2s, scales, g, *, depth: int,
                     act: str, mode: str) -> torch.Tensor:
    """K2's plain PyTorch version: [sum g dK/dw, sum g dK/db, sum g dK/dlast]
    in float64, from :func:`gram_tangents_plain`'s Grams."""
    _, dkw, dkb, dkl = gram_tangents_plain(x1, x2, v1s, v2s, dv1s, dv2s, scales,
                                           depth=depth, act=act, mode=mode)
    g64 = g.double()
    return torch.stack([torch.sum(g64 * t.double()) for t in (dkw, dkb, dkl)])


def _check_cuda(name, t, device):
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}; the Gram kernels need "
                         f"every input on one CUDA device ({device})")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} is {t.dtype}; the Gram kernels take float32")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_same(same, pairs):
    """``same=True`` (run the pairs j <= i and mirror them) only where each
    second operand is its first: ``pairs`` maps a name to (first, second)."""
    if not same:
        return
    for name, (a, b) in pairs.items():
        if (a.data_ptr(), a.shape, a.stride()) != (b.data_ptr(), b.shape, b.stride()):
            raise ValueError(f"same=True needs one operand twice; {name}2 is not {name}1")


def _check_cuda_inputs(tensors, depth, same):
    """Device, dtype, contiguity and the shapes both kernels share;
    ``tensors`` maps names to tensors, x1 first."""
    x1, x2 = tensors["x1"], tensors["x2"]
    for name, t in tensors.items():
        _check_cuda(name, t, x1.device)
    if x1.ndim != 2 or x2.ndim != 2:
        raise ValueError(f"x1, x2 must be 2-D; got {tuple(x1.shape)}, {tuple(x2.shape)}")
    n1, d = x1.shape
    n2 = x2.shape[0]
    if x2.shape[1] != d:
        raise ValueError(f"feature dims differ: {d} vs {x2.shape[1]}")
    if min(n1, n2, d) < 1:
        raise ValueError(f"empty input: x1 {tuple(x1.shape)}, x2 {tuple(x2.shape)}")
    if depth < 0:
        raise ValueError(f"depth {depth} < 0")
    if not same and -(-n1 // _TILE) > _MAX_ROW_TILES:
        raise ValueError(f"n1 = {n1} exceeds the kernel's row grid")
    v1s, v2s = tensors["v1s"], tensors["v2s"]
    if v1s.shape != (depth + 1, n1) or v2s.shape != (depth + 1, n2):
        raise ValueError(f"variance stacks {tuple(v1s.shape)}, {tuple(v2s.shape)} "
                         f"do not match depth {depth} and n = ({n1}, {n2})")
    return n1, n2, d


def _check_mode_act(mode, act):
    if act not in _ACTS:
        raise KeyError(f"unsupported act '{act}'")
    if mode not in _MODES:
        raise KeyError(f"unsupported mode '{mode}'")


@functools.cache
def _gram_lib() -> ctypes.CDLL:
    lib = _build.load("gram")
    fn = lib.snngp_gram_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.snngp_gram_grads_f32
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.snngp_gram_blocks
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    lib.snngp_error_string.argtypes = [ctypes.c_int]
    lib.snngp_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({lib.snngp_error_string(err).decode()})")


def gram_blocks(n1: int, n2: int, same: bool) -> int:
    """The blocks of a K1 or K2 launch on these shapes: the T (T + 1) / 2
    lower-triangle 64 x 64 tiles of a symmetric one, else every tile; K2
    writes one float64 triple a block. Read from the kernels' library
    (``snngp_gram_blocks``), which sizes the launch itself."""
    blocks = _gram_lib().snngp_gram_blocks(n1, n2, int(same))
    if blocks < 0:
        raise ValueError(f"{n1} x {n2} pairs (same={same}) do not fit one Gram launch")
    return blocks


def gram_cuda(x1, x2, v1s, v2s, scales, *, depth: int, act: str, mode: str,
              same: bool = False):
    """Launch K1 (``csrc/gram.cu``) on the current stream; same inputs and
    result as :func:`gram_plain`. ``same=True`` says that x2 and v2s are x1
    and v1s: the kernel runs each pair j <= i once and writes both entries,
    so K(x, x) is bitwise symmetric."""
    _check_same(same, dict(x=(x1, x2), v=(v1s, v2s)))
    _check_mode_act(mode, act)
    n1, n2, d = _check_cuda_inputs(dict(x1=x1, x2=x2, v1s=v1s, v2s=v2s, scales=scales),
                                   depth, same)
    if scales.shape != (4,):
        raise ValueError(f"scales must be [4]; got {tuple(scales.shape)}")
    lib = _gram_lib()
    gram_blocks(n1, n2, same)   # raises past the grid's limits
    out = torch.empty((n1, n2), dtype=torch.float32, device=x1.device)
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.snngp_gram_f32(
            x1.data_ptr(), x2.data_ptr(), v1s.data_ptr(), v2s.data_ptr(),
            scales.data_ptr(), out.data_ptr(), n1, n2, d, depth,
            _MODES[mode], _ACTS[act], int(same), stream)
    _raise_on(lib, err, "Gram kernel")
    LAUNCHES["gram"] += 1
    return out


def gram_grads_cuda(x1, x2, v1s, v2s, dv1s, dv2s, scales, g, *, depth: int,
                    act: str, mode: str, same: bool = False) -> torch.Tensor:
    """Launch K2 (``csrc/gram.cu``) on the current stream; same inputs and
    result as :func:`gram_grads_plain`: the three float64 sums. The kernel
    writes one partial triple per 64 x 64 block; they are added here in
    float64. ``same=True`` says that x2, v2s and dv2s are x1, v1s and dv1s:
    the kernel runs each pair j <= i once and weights it by g[i, j] +
    g[j, i] (g[i, i] on the diagonal), so g need not be symmetric."""
    _check_same(same, dict(x=(x1, x2), v=(v1s, v2s), dv=(dv1s, dv2s)))
    _check_mode_act(mode, act)
    n1, n2, d = _check_cuda_inputs(
        dict(x1=x1, x2=x2, v1s=v1s, v2s=v2s, dv1s=dv1s, dv2s=dv2s, scales=scales, g=g),
        depth, same)
    if dv1s.shape != (2, depth + 1, n1) or dv2s.shape != (2, depth + 1, n2):
        raise ValueError(f"variance tangents {tuple(dv1s.shape)}, {tuple(dv2s.shape)} "
                         f"do not match depth {depth} and n = ({n1}, {n2})")
    if scales.shape != (7,):
        raise ValueError(f"scales must be [7]; got {tuple(scales.shape)}")
    if g.shape != (n1, n2):
        raise ValueError(f"cotangent {tuple(g.shape)} does not match ({n1}, {n2})")
    lib = _gram_lib()
    partial = torch.empty((3, gram_blocks(n1, n2, same)), dtype=torch.float64,
                          device=x1.device)
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.snngp_gram_grads_f32(
            x1.data_ptr(), x2.data_ptr(), v1s.data_ptr(), v2s.data_ptr(),
            dv1s.data_ptr(), dv2s.data_ptr(), scales.data_ptr(), g.data_ptr(),
            partial.data_ptr(), n1, n2, d, depth, _MODES[mode], _ACTS[act], int(same),
            stream)
    _raise_on(lib, err, "Gram gradient kernel")
    LAUNCHES["gram_grads"] += 1
    return partial.sum(dim=1)


def _stack_with_tangents(mode, x, depth, act, w, b):
    """(v, [dv/dw_std, dv/db_std]) of a variance stack: forward-mode AD of
    the O(N depth) recursion (``_var_stack_with_tangents`` in the JAX
    package)."""
    stack_fn = _STACKS[mode]
    v, dv_w = torch.func.jvp(lambda ww: stack_fn(x, depth, act, ww, b),
                             (w,), (torch.ones_like(w),))
    _, dv_b = torch.func.jvp(lambda bb: stack_fn(x, depth, act, w, bb),
                             (b,), (torch.ones_like(b),))
    return v, torch.stack([dv_w, dv_b])


def _reference_recursion(x1, x2, depth, act, w, b, last, mode):
    """The layer tier's Gram, the backward surrogate of the
    ``trainable_inputs=True`` contract."""
    from snngp_torch.nn import arch, layers
    builder = arch.get_dense_resnet_layer if mode == "resnet" else arch.get_mlp_layer
    return layers.kernel_fn_of(builder(depth, 1, act, w, b, last))(x1, x2, get="nngp")


class _Gram(torch.autograd.Function):
    """Fused Gram with the JAX package's two backward contracts."""

    @staticmethod
    def forward(ctx, x1, x2, w, b, last, mode, depth, act, trainable_inputs, same):
        v1s = _STACKS[mode](x1, depth, act, w, b)
        v2s = v1s if same else _STACKS[mode](x2, depth, act, w, b)
        scales = torch.stack([w * w, b * b, last * last,
                              torch.full((), 1.0 / x1.shape[-1], dtype=w.dtype,
                                         device=w.device)])
        ctx.save_for_backward(x1, x2, w, b, last)
        ctx.conf = (mode, depth, act, trainable_inputs, same)
        if x1.device.type == "cpu":
            return gram_plain(x1, x2, v1s, v2s, scales, depth=depth, act=act, mode=mode)
        a, v = x1.contiguous(), v1s.contiguous()
        b, u = (a, v) if same else (x2.contiguous(), v2s.contiguous())
        return gram_cuda(a, b, v, u, scales, depth=depth, act=act, mode=mode, same=same)

    @staticmethod
    def backward(ctx, g):
        x1, x2, w, b, last = ctx.saved_tensors
        mode, depth, act, trainable_inputs, same = ctx.conf
        if trainable_inputs:
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(need)
                          for t, need in zip((x1, x2, w, b, last), ctx.needs_input_grad)]
                a1, a2, ww, bb, ll = leaves
                k = _reference_recursion(a1, a1 if same else a2, depth, act, ww, bb,
                                         ll, mode)
                wanted = [t for t in leaves if t.requires_grad]
                grads = iter(torch.autograd.grad(k, wanted, g, allow_unused=True))
            out = [next(grads) if t.requires_grad else None for t in leaves]
            return (*out, None, None, None, None, None)

        with torch.no_grad():
            v1s, dv1s = _stack_with_tangents(mode, x1, depth, act, w, b)
            v2s, dv2s = ((v1s, dv1s) if same
                         else _stack_with_tangents(mode, x2, depth, act, w, b))
            inv_d = torch.full((), 1.0 / x1.shape[-1], dtype=w.dtype, device=w.device)
            scales = torch.stack([w * w, b * b, last * last, inv_d, w, b, last])
            kw = dict(depth=depth, act=act, mode=mode)
            if x1.device.type == "cpu":
                sums = gram_grads_plain(x1, x2, v1s, v2s, dv1s, dv2s, scales, g, **kw)
            else:
                a, v, dv = x1.contiguous(), v1s.contiguous(), dv1s.contiguous()
                b, u, du = ((a, v, dv) if same
                            else (x2.contiguous(), v2s.contiguous(), dv2s.contiguous()))
                sums = gram_grads_cuda(a, b, v, u, dv, du, scales.contiguous(),
                                       g.contiguous(), **kw, same=same)
        gw, gb, gl = (s.to(w.dtype) for s in sums.unbind())
        zero_x = [torch.zeros_like(x) if need else None
                  for x, need in zip((x1, x2), ctx.needs_input_grad[:2])]
        return (*zero_x, gw, gb, gl, None, None, None, None, None)


def _gram(mode, x1, x2, depth, act, w_std, b_std, last_w_std, trainable_inputs):
    if act not in _ACT_T:
        raise KeyError(f"unsupported act '{act}'")
    like = dict(dtype=x1.dtype, device=x1.device)
    w = torch.as_tensor(w_std, **like)
    b = torch.as_tensor(b_std, **like)
    last = torch.as_tensor(last_w_std, **like)
    return _Gram.apply(x1, x2, w, b, last, mode, depth, act, trainable_inputs,
                       x2 is x1)


def mlp_gram(x1: torch.Tensor, x2: torch.Tensor, *, depth: int, act: str = "relu",
             w_std, b_std, last_w_std, trainable_inputs: bool = True) -> torch.Tensor:
    """Fused MLP-NNGP Gram — equals
    ``arch.get_mlp_layer(depth, act=act, ...)``'s kernel on (x1, x2).

    ``trainable_inputs=False`` switches the backward to K2, the fused
    scalar-tangent kernel: x1 / x2 get zero cotangents by contract — the
    ML-II training configuration, which trains only the scale scalars."""
    return _gram("mlp", x1, x2, depth, act, w_std, b_std, last_w_std, trainable_inputs)


def resnet_gram(x1: torch.Tensor, x2: torch.Tensor, *, depth: int, act: str = "relu",
                w_std, b_std, last_w_std, trainable_inputs: bool = True) -> torch.Tensor:
    """Fused dense-ResNet NNGP Gram — equals
    ``arch.get_dense_resnet_layer(depth, ...)``'s kernel on (x1, x2).
    ``trainable_inputs=False``: see :func:`mlp_gram`."""
    return _gram("resnet", x1, x2, depth, act, w_std, b_std, last_w_std, trainable_inputs)
