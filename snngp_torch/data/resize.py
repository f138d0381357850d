"""Host-side bilinear image resize matching ``jax.image.resize`` (a numpy
copy of ``snngp/data/resize.py``).

The reference downscales images on device with ``jax.image.resize(...,
method="bilinear")`` (``experiments/classification/train.py:156-161``).
Resizing is a data-layer transform, so it runs on the host in numpy:

- upscale: standard bilinear (triangle kernel, support 1);
- downscale: antialiased bilinear (triangle dilated by in/out, the
  ``antialias=True`` default jax applies when shrinking);
- edge handling: weights renormalized over the valid support (jax's
  ``_scale_and_translate`` does the same).

Weights are built as small [out, in] matrices and applied as two einsums;
the result is byte-identical to the JAX package's copy
(tests/test_torch_data.py), which matches ``jax.image.resize`` to fp32
reassociation noise.
"""

from __future__ import annotations

import numpy as np

__all__ = ["bilinear_resize"]


def _resize_weights(n_in: int, n_out: int, dtype=np.float64) -> np.ndarray:
    """[n_out, n_in] separable bilinear/triangle weight matrix."""
    if n_in == n_out:
        return np.eye(n_in, dtype=dtype)
    scale = n_out / n_in
    # Sample centers of output pixels in input coordinates.
    centers = (np.arange(n_out, dtype=np.float64) + 0.5) / scale - 0.5
    j = np.arange(n_in, dtype=np.float64)
    t = j[None, :] - centers[:, None]
    if scale < 1.0:
        t = t * scale                       # antialias: dilate the kernel
    w = np.maximum(0.0, 1.0 - np.abs(t))
    w = w / np.sum(w, axis=1, keepdims=True)  # edge renormalization
    return w.astype(dtype)


def bilinear_resize(x: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Resize [..., H, W, C] images to [..., out_h, out_w, C] on the host.

    Drop-in for ``np.asarray(jax.image.resize(jnp.asarray(x),
    (..., out_h, out_w, C), method="bilinear"))`` without the device round
    trip. Computation runs in float64 and is cast to float32 (at least as
    accurate as the f32 device op it replaces).
    """
    x = np.asarray(x)
    h, w = x.shape[-3], x.shape[-2]
    wh = _resize_weights(h, out_h)          # [out_h, H]
    ww = _resize_weights(w, out_w)          # [out_w, W]
    out = np.einsum("oh,...hwc->...owc", wh, x.astype(np.float64))
    out = np.einsum("pw,...owc->...opc", ww, out)
    return out.astype(np.float32)
