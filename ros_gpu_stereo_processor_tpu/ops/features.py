"""Feature detection, description and matching — the sparse frontend.

Extends the engine beyond the reference's dense-only pipeline into VO/SLAM
(SURVEY.md §7 build step 6; BASELINE.json config 4).  Data-parallel design:

  * **FAST-9** corner test as 16 static circle shifts + a bit-mask doubling
    trick for the contiguous-arc test — elementwise, no loops over pixels;
  * 3×3 non-max suppression via max-pool comparison;
  * fixed-capacity keypoint sets (``top_k`` over the score map) — static
    shapes for XLA, with validity masks instead of dynamic counts;
  * rotation-steered binary descriptors (BRIEF-style 256-pair pattern with
    ORB's intensity-centroid orientation), packed into uint32 words;
  * brute-force Hamming matching as an XOR + popcount distance matrix with
    mutual-nearest + ratio gating (vectorised over K×K).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# FAST circle of radius 3 (Bresenham), (dy, dx) pairs in ring order
_CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    np.int32,
)


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set (static shapes; ``valid`` gates slots)."""

    xy: jnp.ndarray       # (K, 2) float32 (x, y)
    score: jnp.ndarray    # (K,) float32
    angle: jnp.ndarray    # (K,) float32 radians
    desc: jnp.ndarray     # (K, 8) uint32 packed 256-bit descriptors
    valid: jnp.ndarray    # (K,) bool


def _shift2(x: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """Shift with edge replication (boundary pixels never become corners —
    they are masked out later)."""
    H, W = x.shape
    ys = jnp.clip(jnp.arange(H) + dy, 0, H - 1)
    xs = jnp.clip(jnp.arange(W) + dx, 0, W - 1)
    return x[ys][:, xs]


def _rot16(m: jnp.ndarray, k: int) -> jnp.ndarray:
    return ((m << k) | (m >> (16 - k))) & jnp.uint32(0xFFFF)


def _has_arc9(mask16: jnp.ndarray) -> jnp.ndarray:
    """True where the 16-bit circle mask contains ≥9 contiguous set bits
    (wrap-around) — doubling AND-reduction."""
    a = mask16 & _rot16(mask16, 1)      # runs of ≥2
    a = a & _rot16(a, 2)                # ≥4
    a = a & _rot16(a, 4)                # ≥8
    a = a & _rot16(mask16, 8)           # ≥9
    return a > 0


def fast_score_map(img: jnp.ndarray, threshold: float = 20.0) -> jnp.ndarray:
    """FAST-9 corner response: 0 where not a corner, else a contrast score
    (sum of circle |differences| beyond the threshold)."""
    x = img.astype(jnp.float32)
    H, W = x.shape
    circle = [
        _shift2(x, int(dy), int(dx)) for dy, dx in _CIRCLE
    ]
    bright = jnp.zeros((H, W), jnp.uint32)
    dark = jnp.zeros((H, W), jnp.uint32)
    s_bright = jnp.zeros((H, W), jnp.float32)
    s_dark = jnp.zeros((H, W), jnp.float32)
    for i, c in enumerate(circle):
        db = c - x
        is_b = db > threshold
        is_d = -db > threshold
        bright = bright | (is_b.astype(jnp.uint32) << i)
        dark = dark | (is_d.astype(jnp.uint32) << i)
        s_bright = s_bright + jnp.where(is_b, db - threshold, 0.0)
        s_dark = s_dark + jnp.where(is_d, -db - threshold, 0.0)

    corner = _has_arc9(bright) | _has_arc9(dark)
    score = jnp.maximum(s_bright, s_dark)

    # 3×3 non-max suppression + border mask (patch radius 15 for descriptors)
    nb = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    row = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    margin = 16
    inb = (row >= margin) & (row < H - margin) & (col >= margin) & (col < W - margin)
    return jnp.where(corner & (score >= nb) & inb, score, 0.0)


def select_keypoints(score_map: jnp.ndarray, k: int = 512):
    """Top-K corner slots: returns (xy (K,2) f32, score (K,), valid (K,))."""
    H, W = score_map.shape
    vals, idx = jax.lax.top_k(score_map.reshape(-1), k)
    ys = (idx // W).astype(jnp.float32)
    xs = (idx % W).astype(jnp.float32)
    return jnp.stack([xs, ys], -1), vals, vals > 0.0


# ---------------------------------------------------------------------------
# Orientation + descriptors (patch-based, no per-pixel gathers)
#
#   1. extract one 32×32 patch per keypoint with dynamic_slice (a lax.scan of
#      cheap aligned copies — keypoints are integer pixels, so this is exact);
#   2. orientation moments are two einsums of the patch stack against static
#      coordinate masks;
#   3. descriptor steering is quantised to 16 angle bins (ORB quantises to
#      12°); each bin's rotated sampling positions are STATIC indices into
#      the flattened patch, so sampling is constant-index vectorised loads —
#      the per-keypoint bin picks among the 16 bit-planes with selects.
# ---------------------------------------------------------------------------

_PATCH_R = 15
_PATCH = 2 * _PATCH_R + 2            # 32
_NBINS = 16                          # steering quantisation (22.5°)


def _pattern(seed: int = 7, n: int = 256) -> np.ndarray:
    """(n, 4) sampling offsets (x1, y1, x2, y2), Gaussian-distributed, with
    norm ≤ _PATCH_R − 1 so every rotation stays inside the patch."""
    rng = np.random.default_rng(seed)
    p = rng.normal(0.0, _PATCH_R / 2.5, size=(n, 4))
    for sl in (slice(0, 2), slice(2, 4)):
        v = p[:, sl]
        norm = np.linalg.norm(v, axis=1, keepdims=True)
        scale = np.minimum(1.0, (_PATCH_R - 1.0) / np.maximum(norm, 1e-9))
        p[:, sl] = v * scale
    return p.astype(np.float32)


_PATTERN = _pattern()


def _binned_indices() -> np.ndarray:
    """(NBINS, 2, 256) static flattened-patch indices of the rotated pattern
    taps for each quantised steering angle."""
    out = np.zeros((_NBINS, 2, _PATTERN.shape[0]), np.int32)
    c = _PATCH_R + 0  # patch centre offset (patch[15,15] is the keypoint)
    for b in range(_NBINS):
        a = 2.0 * np.pi * b / _NBINS
        ca, sa = np.cos(a), np.sin(a)
        for t, sl in enumerate((slice(0, 2), slice(2, 4))):
            px, py = _PATTERN[:, sl][:, 0], _PATTERN[:, sl][:, 1]
            rx = np.clip(np.round(px * ca - py * sa) + c, 0, _PATCH - 1)
            ry = np.clip(np.round(px * sa + py * ca) + c, 0, _PATCH - 1)
            out[b, t] = (ry * _PATCH + rx).astype(np.int32)
    return out


_BIN_IDX = _binned_indices()

_MASK_CIRC = None


def _moment_masks():
    global _MASK_CIRC
    if _MASK_CIRC is None:
        ys, xs = np.mgrid[0:_PATCH, 0:_PATCH].astype(np.float32)
        dx = xs - _PATCH_R
        dy = ys - _PATCH_R
        circ = (dx * dx + dy * dy <= _PATCH_R * _PATCH_R).astype(np.float32)
        _MASK_CIRC = (circ * dx, circ * dy)
    return _MASK_CIRC


def extract_patches(img: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """(K, 32, 32) float32 patches centred on integer keypoints (clamped)."""
    H, W = img.shape
    imf = img.astype(jnp.float32)
    y0 = jnp.clip(jnp.round(xy[:, 1]).astype(jnp.int32) - _PATCH_R, 0, H - _PATCH)
    x0 = jnp.clip(jnp.round(xy[:, 0]).astype(jnp.int32) - _PATCH_R, 0, W - _PATCH)

    def one(carry, se):
        yy, xx = se
        return carry, jax.lax.dynamic_slice(imf, (yy, xx), (_PATCH, _PATCH))

    _, patches = jax.lax.scan(one, None, (y0, x0))
    return patches


def orientations_from_patches(patches: jnp.ndarray) -> jnp.ndarray:
    mx, my = _moment_masks()
    # full f32: TF32 inputs (the GPU default) can move a keypoint's angle
    # across a steering-bin boundary and change its descriptor
    hi = jax.lax.Precision.HIGHEST
    m10 = jnp.einsum("kij,ij->k", patches, jnp.asarray(mx), precision=hi)
    m01 = jnp.einsum("kij,ij->k", patches, jnp.asarray(my), precision=hi)
    return jnp.arctan2(m01, m10)


def describe_from_patches(patches: jnp.ndarray, angle: jnp.ndarray) -> jnp.ndarray:
    """Quantised-steering 256-bit descriptors, packed (K, 8) uint32."""
    K = patches.shape[0]
    flat = patches.reshape(K, -1)                            # (K, 1024)
    two_pi = 2.0 * np.pi
    bins = jnp.round(
        (jnp.mod(angle, two_pi) / two_pi) * _NBINS
    ).astype(jnp.int32) % _NBINS                             # (K,)

    bits = jnp.zeros((K, _PATTERN.shape[0]), jnp.uint32)
    for b in range(_NBINS):
        i1 = _BIN_IDX[b, 0]
        i2 = _BIN_IDX[b, 1]
        bb = (flat[:, i1] < flat[:, i2]).astype(jnp.uint32)  # static indices
        bits = jnp.where((bins == b)[:, None], bb, bits)
    words = bits.reshape(K, 8, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, None]
    return jnp.sum(words << shifts, axis=-1, dtype=jnp.uint32)


def orientations(img: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """ORB intensity-centroid angle per keypoint (patch formulation)."""
    return orientations_from_patches(extract_patches(img, xy))


def describe(img: jnp.ndarray, xy: jnp.ndarray, angle: jnp.ndarray) -> jnp.ndarray:
    """Rotation-steered binary descriptors (quantised steering)."""
    return describe_from_patches(extract_patches(img, xy), angle)


@functools.partial(jax.jit, static_argnames=("k",))
def detect_and_describe(
    img: jnp.ndarray, k: int = 512, threshold: float = 20.0
) -> Keypoints:
    """Full sparse frontend for one image: FAST-9 → NMS → top-K → orientation
    → steered binary descriptors."""
    score = fast_score_map(img, threshold)
    xy, s, valid = select_keypoints(score, k)
    patches = extract_patches(img, xy)
    ang = orientations_from_patches(patches)
    desc = describe_from_patches(patches, ang)
    return Keypoints(xy=xy, score=s, angle=ang, desc=desc, valid=valid)


# ---------------------------------------------------------------------------
# Matching
# ---------------------------------------------------------------------------


def _popcount32(x: jnp.ndarray) -> jnp.ndarray:
    x = x - ((x >> 1) & jnp.uint32(0x55555555))
    x = (x & jnp.uint32(0x33333333)) + ((x >> 2) & jnp.uint32(0x33333333))
    x = (x + (x >> 4)) & jnp.uint32(0x0F0F0F0F)
    return (x * jnp.uint32(0x01010101)) >> 24


def hamming_matrix(da: jnp.ndarray, db: jnp.ndarray) -> jnp.ndarray:
    """(Ka, 8) × (Kb, 8) uint32 → (Ka, Kb) int32 Hamming distances."""
    x = da[:, None, :] ^ db[None, :, :]
    return jnp.sum(_popcount32(x), axis=-1).astype(jnp.int32)


def match_desc(
    desc_a: jnp.ndarray,
    valid_a: jnp.ndarray,
    desc_b: jnp.ndarray,
    valid_b: jnp.ndarray,
    max_distance: int = 64,
    ratio: float = 0.9,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Descriptor-level mutual-nearest matching (the core of :func:`match`,
    exposed separately so it can be ``vmap``-ped over stacked keyframe pairs —
    one device dispatch for a whole loop-closure candidate batch)."""
    BIG = jnp.int32(10_000)
    d = hamming_matrix(desc_a, desc_b)
    d = jnp.where(valid_a[:, None] & valid_b[None, :], d, BIG)

    best_b = jnp.argmin(d, axis=1)
    dist1 = jnp.min(d, axis=1)
    # second best for the ratio test
    d2 = d.at[jnp.arange(d.shape[0]), best_b].set(BIG)
    dist2 = jnp.min(d2, axis=1)
    # mutual check
    best_a_of_b = jnp.argmin(d, axis=0)
    mutual = best_a_of_b[best_b] == jnp.arange(d.shape[0])

    ok = (
        (dist1 <= max_distance)
        & (dist1.astype(jnp.float32) <= ratio * dist2.astype(jnp.float32))
        & mutual
        & valid_a
    )
    return jnp.where(ok, best_b, -1), ok


@functools.partial(jax.jit, static_argnames=("max_distance",))
def match(
    kp_a: Keypoints,
    kp_b: Keypoints,
    max_distance: int = 64,
    ratio: float = 0.9,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Mutual-nearest Hamming matching with Lowe ratio test.

    Returns (idx_b (Ka,) int32 — match in b for each a-slot, −1 if none;
    valid (Ka,) bool)."""
    return match_desc(kp_a.desc, kp_a.valid, kp_b.desc, kp_b.valid,
                      max_distance=max_distance, ratio=ratio)


def descriptor_signature(desc: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """(K, 8) uint32 packed descriptors + (K,) validity → (256,) L2-normalised
    bit-frequency signature — a compact whole-image appearance vector (the
    bag-of-words role for loop-closure candidate scoring; similarity between
    keyframes is then ONE (n_kf × n_kf) matmul)."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = ((desc[:, :, None] >> shifts[None, None, :]) & 1).astype(jnp.float32)
    bits = bits.reshape(desc.shape[0], 256)
    w = valid.astype(jnp.float32)
    sig = jnp.sum(bits * w[:, None], axis=0) / jnp.maximum(jnp.sum(w), 1.0)
    sig = sig - jnp.mean(sig)   # remove the DC bias common to all frames
    return sig / jnp.maximum(jnp.linalg.norm(sig), 1e-9)
