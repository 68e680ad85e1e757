"""SAD block-matching stereo disparity — pure-jnp reference path.

Re-design of the reference's disparity engine, which delegates to
``cv::cuda::StereoBM`` (GPU) paired with ``cv::StereoBM`` (CPU oracle) with
mirrored settings (reference: src/GPUStereoProcessor.cpp:12-39,264-321).  The
algorithm re-implemented here from its published semantics:

  1. XSobel (or normalized-response) prefilter clamped to ±prefilter_cap,
  2. SAD cost volume over a block_size² window for num_disparities candidates,
  3. winner-take-all argmin with texture & uniqueness validity checks,
  4. optional parabolic sub-pixel refinement,

producing *true float disparity* — the reference's intended-but-dead 32F
output (the /16 + cx-shift conversion commented out at
src/GPUStereoProcessor.cpp:290-295; we implement the intent per SURVEY.md
"reference bugs").

Everything is static-shaped and scan-based: the disparity loop is a
``lax.scan`` (no Python-level unrolling), window sums are
``lax.reduce_window`` which XLA lowers to fused separable accumulations.
This module is the one matcher path on every device, tested against
OpenCV's CPU StereoBM (the same parity strategy the reference uses).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ros_gpu_stereo_processor_tpu.config import StereoBMConfig

_BIG = np.float32(1e9)  # np, not jnp: module import must not init a backend


# ---------------------------------------------------------------------------
# Prefilters
# ---------------------------------------------------------------------------


def xsobel_prefilter(img: jnp.ndarray, cap: int = 31) -> jnp.ndarray:
    """Horizontal Sobel response clamped to [0, 2·cap] (neutral = cap).

    Matches OpenCV's PREFILTER_XSOBEL semantics: response
    (p[y-1][x+1]−p[y-1][x-1]) + 2(p[y][x+1]−p[y][x-1]) + (p[y+1][x+1]−p[y+1][x-1]),
    rows replicated at top/bottom, first/last column set to the neutral value.
    """
    x = img.astype(jnp.float32)
    xp = jnp.pad(x, ((1, 1), (0, 0)), mode="edge")
    rows = xp[:-2] + 2.0 * xp[1:-1] + xp[2:]
    d = jnp.pad(rows[:, 2:] - rows[:, :-2], ((0, 0), (1, 1)))
    out = jnp.clip(d + cap, 0.0, 2.0 * cap)
    # border columns carry the neutral value
    out = out.at[:, 0].set(float(cap))
    out = out.at[:, -1].set(float(cap))
    return out


def normalized_response_prefilter(
    img: jnp.ndarray, cap: int = 31, win: int = 9
) -> jnp.ndarray:
    """PREFILTER_NORMALIZED_RESPONSE — OpenCV's exact integer formula
    (``prefilterNorm``, modules/calib3d/src/stereobm.cpp; the reference's
    non-XSobel mode, src/GPUStereoProcessor.cpp:389-393):

        scale_g = (win²/8) · scale_s,  scale_s = (1024 + win²/8) / (2·win²/8)
        val     = (cross·scale_g − winsum·scale_s) >> 10
        out     = clamp(val, −cap, cap) + cap                 ∈ [0, 2·cap]

    where ``cross`` = 4·p + its 4-neighbours and ``winsum`` is the win×win
    box sum, both with replicate (edge-clamped) padding, all in int32 with
    an arithmetic shift (floor division)."""
    x = img.astype(jnp.int32)
    wsz2 = win // 2
    scale_g0 = (win * win) // 8
    scale_s = (1024 + scale_g0) // (scale_g0 * 2)
    scale_g = scale_g0 * scale_s

    xe = jnp.pad(x, wsz2, mode="edge").astype(jnp.float32)
    winsum = jax.lax.reduce_window(
        xe, 0.0, jax.lax.add, (win, win), (1, 1), "VALID"
    ).astype(jnp.int32)

    xp = jnp.pad(x, 1, mode="edge")
    cross = (
        4 * x
        + xp[:-2, 1:-1] + xp[2:, 1:-1]      # up, down (row-clamped)
        + xp[1:-1, :-2] + xp[1:-1, 2:]      # left, right (col-clamped)
    )
    val = jnp.floor_divide(cross * scale_g - winsum * scale_s, 1024)
    return jnp.clip(val, -cap, cap).astype(jnp.float32) + cap


def prefilter(img: jnp.ndarray, cfg: StereoBMConfig) -> jnp.ndarray:
    if cfg.xsobel:
        return xsobel_prefilter(img, cfg.prefilter_cap)
    return normalized_response_prefilter(img, cfg.prefilter_cap)


# ---------------------------------------------------------------------------
# Cost volume + WTA
# ---------------------------------------------------------------------------


def _box_sum(x: jnp.ndarray, block: int) -> jnp.ndarray:
    """Sum over a block×block window, zero-padded SAME, over last two dims."""
    return jax.lax.reduce_window(
        x, 0.0, jax.lax.add, (block, block), (1, 1), "SAME"
    )


def sad_cost_volume(
    left_f: jnp.ndarray,
    right_f: jnp.ndarray,
    cfg: StereoBMConfig,
) -> jnp.ndarray:
    """(ndisp, H, W) float32 SAD cost volume over prefiltered images.

    cost[d, y, x] = Σ_window |L(y+i, x+j) − R(y+i, x+j−(min_disparity+d))|,
    +∞ (1e9) where the right window would leave the image.
    """
    H, W = left_f.shape
    nd = cfg.num_disparities
    mind = cfg.min_disparity
    r = cfg.block_radius

    max_d = mind + nd - 1
    pad_l = max(0, max_d)
    pad_r = max(0, -mind)
    right_p = jnp.pad(right_f, ((0, 0), (pad_l, pad_r)))

    col = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)

    def one_disp(_, di):
        d = mind + di
        shifted = jax.lax.dynamic_slice(
            right_p, (0, pad_l - d), (H, W)
        )
        sad = _box_sum(jnp.abs(left_f - shifted), cfg.block_size)
        # right window must fit: 0 <= x-d-r and x-d+r <= W-1
        valid = (col - d >= r) & (col - d <= W - 1 - r)
        return None, jnp.where(valid, sad, _BIG)

    _, cost = jax.lax.scan(one_disp, None, jnp.arange(nd, dtype=jnp.int32))
    return cost


def texture_sum(left_f: jnp.ndarray, cfg: StereoBMConfig) -> jnp.ndarray:
    """Σ_window |prefiltered − cap| — the texture-validity statistic."""
    return _box_sum(jnp.abs(left_f - cfg.prefilter_cap), cfg.block_size)


def wta_disparity(
    cost: jnp.ndarray,
    left_f: jnp.ndarray = None,
    cfg: StereoBMConfig = StereoBMConfig(),
    *,
    tex: jnp.ndarray = None,
    row_offset: int | jnp.ndarray = 0,
    total_rows: int | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Winner-take-all with texture/uniqueness checks and subpixel refine.

    Returns (disparity float32 — absolute, i.e. includes min_disparity —
    and validity mask bool).  Invalid pixels carry min_disparity−1, the
    OpenCV sentinel.

    ``tex`` may be passed precomputed (sharded path); otherwise it is derived
    from ``left_f``.  ``row_offset``/``total_rows`` let a row-band shard
    evaluate border validity against *global* image coordinates
    (parallel/frontend.py).
    """
    nd, H, W = cost.shape
    mind = cfg.min_disparity
    r = cfg.block_radius
    if total_rows is None:
        total_rows = H

    best = jnp.argmin(cost, axis=0).astype(jnp.int32)            # (H, W)
    cbest = jnp.min(cost, axis=0)

    valid = cbest < _BIG

    # image-border validity: full left window must fit (global coordinates)
    row = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0) + row_offset
    col = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    valid &= (row >= r) & (row <= total_rows - 1 - r) & (col >= r) & (col <= W - 1 - r)

    # texture check: Σ_window |prefiltered − cap| must reach the threshold
    if cfg.texture_threshold > 0:
        if tex is None:
            tex = texture_sum(left_f, cfg)
        valid &= tex >= cfg.texture_threshold

    # uniqueness: any cost within ratio outside best±1 invalidates
    if cfg.uniqueness_ratio > 0:
        thresh = cbest * (1.0 + cfg.uniqueness_ratio / 100.0)
        didx = jax.lax.broadcasted_iota(jnp.int32, (nd, H, W), 0)
        near = jnp.abs(didx - best[None]) <= 1
        contender = (cost <= thresh[None]) & (~near)
        valid &= ~jnp.any(contender, axis=0)

    disp = (best + mind).astype(jnp.float32)

    if cfg.refine_disparity:
        dm = jnp.clip(best - 1, 0, nd - 1)
        dp = jnp.clip(best + 1, 0, nd - 1)
        take = lambda idx: jnp.take_along_axis(cost, idx[None], axis=0)[0]
        cm = take(dm)
        cp = take(dp)
        denom = cm + cp - 2.0 * cbest
        delta = jnp.where(denom > 0, (cm - cp) / (2.0 * denom), 0.0)
        delta = jnp.clip(delta, -0.5, 0.5)
        interior = (best > 0) & (best < nd - 1) & (cm < _BIG) & (cp < _BIG)
        disp = disp + jnp.where(interior, delta, 0.0)

    disp = jnp.where(valid, disp, jnp.float32(mind - 1))
    return disp, valid


@partial(jax.jit, static_argnames=("cfg",))
def compute_disparity(
    left: jnp.ndarray,
    right: jnp.ndarray,
    cfg: StereoBMConfig = StereoBMConfig(),
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Full block-matching pass: prefilter → cost volume → WTA
    (→ left-right consistency when ``cfg.lr_check``).

    Args:
      left/right: (H, W) mono images (uint8 or float).
    Returns:
      (disparity float32 (H, W), valid bool (H, W)).
    """
    lf = prefilter(left, cfg)
    rf = prefilter(right, cfg)
    cost = sad_cost_volume(lf, rf, cfg)
    disp, valid = wta_disparity(cost, lf, cfg)
    if cfg.lr_check:
        disp_r = right_disparity_from_cost(cost, cfg)
        valid &= left_right_check(disp, disp_r, cfg, cfg.lr_max_diff)
        disp = jnp.where(valid, disp, jnp.float32(cfg.min_disparity - 1))
    return disp, valid


def right_disparity_from_cost(cost: jnp.ndarray, cfg: StereoBMConfig) -> jnp.ndarray:
    """Right-image WTA disparity from the *left-indexed* cost volume.

    cost[d, y, x] measures L(x) vs R(x−(mind+d)), so the candidates for right
    pixel xr are cost[d, y, xr + mind + d].  Computed gather-free by scanning
    d with accumulators kept in a frame rolled by one column per step.

    Returns float32 absolute right disparity (mind−1 where no candidate).
    """
    nd, H, W = cost.shape
    mind = cfg.min_disparity

    def shift1(x, fill):
        # non-wrapping shift right by one column (wrap would smear stale
        # accumulator values onto near-edge right pixels)
        return jnp.concatenate([jnp.full_like(x[:, :1], fill), x[:, :-1]], 1)

    def step(carry, xs):
        best, bestd = carry
        d, plane = xs
        # invariant: best[x] tracks right pixel x − (mind+d)
        newbest = plane < best
        best = jnp.where(newbest, plane, best)
        bestd = jnp.where(newbest, d, bestd)
        # the entry shifted off the right edge is FINAL for its right pixel
        # (xr = W−1−mind−d gets no candidates at larger d) — record it
        out = (best[:, -1], bestd[:, -1])
        return (shift1(best, _BIG), shift1(bestd, -1)), out

    # fills derive from `cost` (full_like) so the scan carry keeps the same
    # varying-manual-axes type as the body outputs under shard_map
    init = (jnp.full_like(cost[0], _BIG),
            jnp.full_like(cost[0], -1, dtype=jnp.int32))
    (best, bestd), (tail_c, tail_d) = jax.lax.scan(
        step, init, (jnp.arange(nd, dtype=jnp.int32), cost)
    )
    # main body: final frame column x holds right pixel x − mind − nd
    total = nd + mind
    if total > 0:
        best = jnp.concatenate(
            [best[:, total:], jnp.full_like(best[:, :total], _BIG)], 1)
        bestd = jnp.concatenate(
            [bestd[:, total:], jnp.full_like(bestd[:, :total], -1)], 1
        )
    elif total < 0:
        k = -total
        best = jnp.concatenate(
            [jnp.full_like(best[:, :k], _BIG), best[:, :-k]], 1)
        bestd = jnp.concatenate(
            [jnp.full_like(bestd[:, :k], -1), bestd[:, :-k]], 1
        )
    # tail: step d recorded right pixel W−1−mind−d → columns
    # [W−mind−nd, W−mind), increasing xr = reversed d order
    start = W - mind - nd
    tb = jnp.flip(tail_c.T, axis=1)               # (H, nd)
    td = jnp.flip(tail_d.T, axis=1)
    if start < 0:
        tb, td = tb[:, -start:], td[:, -start:]
        start = 0
    width = min(tb.shape[1], W - start)
    if width > 0:
        best = jax.lax.dynamic_update_slice(best, tb[:, :width], (0, start))
        bestd = jax.lax.dynamic_update_slice(bestd, td[:, :width], (0, start))
    ok = best < _BIG
    return jnp.where(ok, (bestd + mind).astype(jnp.float32),
                     jnp.float32(mind - 1))


def left_right_check(
    disp_l: jnp.ndarray,
    disp_r: jnp.ndarray,
    cfg: StereoBMConfig,
    max_diff: int = 1,
) -> jnp.ndarray:
    """Gather-free left-right consistency: pixel x passes iff
    |disp_l[x] − disp_r[x − disp_l[x]]| ≤ max_diff.

    Instead of a per-pixel gather, test every candidate k of the search
    range with a rolled comparison — nd cheap vector ops.
    """
    nd = cfg.num_disparities
    mind = cfg.min_disparity
    ok = jnp.zeros_like(disp_l, dtype=bool)   # _like: keep vma under shard_map
    dl = jnp.round(disp_l).astype(jnp.int32)

    def body(k, ok):
        d_abs = mind + k
        dr_at = jnp.roll(disp_r, d_abs, axis=1)      # disp_r[x − d_abs]
        hit = (dl == d_abs) & (jnp.abs(dr_at - disp_l) <= max_diff)
        return ok | hit

    return jax.lax.fori_loop(0, nd, body, ok)


def valid_window(cfg: StereoBMConfig, height: int, width: int):
    """Rectangle of potentially-valid disparities — the corrected form of the
    reference's DisparityImage valid_window (the *intent* of
    src/GpuSenderDisparity.cpp:29-39, with its swapped-ctor-args bug fixed,
    SURVEY.md §2.12).

    Returns (x_offset, y_offset, width, height).
    """
    border = cfg.block_radius
    left = cfg.num_disparities + cfg.min_disparity + border - 1
    left = max(left, border)
    right = width - 1 - border
    top = border
    bottom = height - 1 - border
    return (left, top, max(0, right - left + 1), max(0, bottom - top + 1))
