"""Bilinear remap (stereo rectification sampling).

Replacement for the reference's forked
``image_geometry::PinholeCameraModel::rectifyImageGPU`` → cv::cuda::remap
call chain (reference: src/GPUStereoProcessor.cpp:236-262, fork calls at
:244,248).  The (undistort ∘ rectify) source-coordinate maps are precomputed
on host (utils/calib.py); this module does the bilinear sampling on device
as a 4-tap jnp gather, which XLA lowers to one fused kernel.

Out-of-range samples produce 0 (OpenCV BORDER_CONSTANT default, which is what
cv::cuda::remap uses in the fork's configuration).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def remap_bilinear(img: jnp.ndarray, src_map: jnp.ndarray) -> jnp.ndarray:
    """Sample ``img`` at real-valued source coordinates.

    Args:
      img: (H, W) or (H, W, C) array, any real dtype.
      src_map: (H', W', 2) float32 of (x_src, y_src) per destination pixel.

    Returns:
      (H', W'[, C]) array of ``img.dtype`` (rounded if integral).
    """
    H, W = img.shape[0], img.shape[1]
    chan = img.ndim == 3

    x = src_map[..., 0].astype(jnp.float32)
    y = src_map[..., 1].astype(jnp.float32)

    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    def sample(yi, xi):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        xi_c = jnp.clip(xi, 0, W - 1)
        yi_c = jnp.clip(yi, 0, H - 1)
        flat = img.reshape((H * W,) + img.shape[2:])
        v = jnp.take(flat, yi_c * W + xi_c, axis=0)
        mask = valid[..., None] if chan else valid
        return jnp.where(mask, v, 0).astype(jnp.float32), valid

    v00, m00 = sample(y0i, x0i)
    v01, m01 = sample(y0i, x0i + 1)
    v10, m10 = sample(y0i + 1, x0i)
    v11, m11 = sample(y0i + 1, x0i + 1)

    if chan:
        fx = fx[..., None]
        fy = fy[..., None]
    w00 = (1 - fx) * (1 - fy)
    w01 = fx * (1 - fy)
    w10 = (1 - fx) * fy
    w11 = fx * fy
    out = v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11

    if jnp.issubdtype(img.dtype, jnp.integer):
        info = jnp.iinfo(img.dtype)
        out = jnp.clip(jnp.round(out), info.min, info.max)
    return out.astype(img.dtype)


def rectify_pair(images: jnp.ndarray, maps: jnp.ndarray) -> jnp.ndarray:
    """Rectify a batched L/R stack: images (2, H, W[, C]) with maps
    (2, H, W, 2) → (2, H, W[, C]).  The two sides vectorise into one device
    launch — the counterpart of the reference's dual-CUDA-stream side
    parallelism (src/GPUStereoProcessor.cpp:190-200)."""
    return jax.vmap(remap_bilinear)(images, maps)
