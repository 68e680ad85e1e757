"""Semi-global matching: path-aggregated cost volume (SGM).

Beyond the reference's plain block matcher (its disparity-bilateral-filter
refinement is declared but stubbed out — SURVEY.md §2.8b): SGM aggregates
matching costs along image paths with small/large jump penalties P1/P2,
giving dense disparity that survives low texture (BASELINE.json config 3).

Formulation: each direction's recurrence

    L(p, d) = C(p, d) + min( L(p−r, d),
                             L(p−r, d±1) + P1,
                             min_{d'} L(p−r, d') + P2 ) − min_{d'} L(p−r, d')

is a ``lax.scan`` along the path axis whose carry is the full perpendicular
slice × disparity plane — each scan step is one fused update over
(H × ndisp) (horizontal paths) or (W × ndisp) (vertical paths); the d-mins
are static shifts, no gathers.  Horizontal paths are embarrassingly parallel
across rows (the row-sharded multi-chip layout aggregates them with zero
communication; vertical paths hand a single carry plane across band
boundaries).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ros_gpu_stereo_processor_tpu.config import StereoBMConfig
from ros_gpu_stereo_processor_tpu.ops import stereobm as bm_ops

_BIG = np.float32(1e9)  # np, not jnp: module import must not init a backend


def _step_update(prev: jnp.ndarray, cost_slice: jnp.ndarray,
                 p1: float, p2: float) -> jnp.ndarray:
    """One SGM recurrence step.  prev/cost_slice: (..., nd)."""
    m = jnp.min(prev, axis=-1, keepdims=True)
    up = jnp.concatenate([prev[..., 1:], jnp.full_like(prev[..., :1], _BIG)], -1)
    dn = jnp.concatenate([jnp.full_like(prev[..., :1], _BIG), prev[..., :-1]], -1)
    best = jnp.minimum(
        jnp.minimum(prev, m + p2),
        jnp.minimum(up + p1, dn + p1),
    )
    # − min_d' L(p−r, d') keeps the accumulator bounded (standard SGM).
    # Parenthesised as c + (best − m): best−m ≤ P2 is small, so the sum stays
    # precise — and a uniform restart carry (best=m=F) contributes exactly 0.
    return cost_slice + (best - m)


def _aggregate_axis(cost: jnp.ndarray, axis: int, reverse: bool,
                    p1: float, p2: float) -> jnp.ndarray:
    """Aggregate along one direction.  cost: (H, W, nd); axis 0 or 1."""
    seq = jnp.moveaxis(cost, axis, 0)         # (T, P, nd)

    def step(prev, c):
        out = _step_update(prev, c, p1, p2)
        return out, out

    init = jnp.zeros_like(seq[0])
    # unroll: each scan step is a small update over one perpendicular
    # slice; unrolling amortises the per-step loop overhead
    _, out = jax.lax.scan(step, init, seq, reverse=reverse, unroll=4)
    return jnp.moveaxis(out, 0, axis)


# carry value that makes the recurrence restart a path exactly:
# min(F, F+P1, F+P2) = F and −min = −F cancel ⇒ L = c
_RESTART = np.float32(1e6)


def _aggregate_diagonal(cost: jnp.ndarray, dx: int, reverse: bool,
                        p1: float, p2: float) -> jnp.ndarray:
    """Aggregate along a 45° diagonal: scan rows, shifting the carry by
    ``dx`` columns per row.  Vacated carry columns get the path-restart
    value, so image borders behave exactly like path starts (no wrap)."""

    def shift_cols(a, d):
        if d == 1:
            return jnp.concatenate(
                [jnp.full_like(a[:1], _RESTART), a[:-1]], axis=0
            )
        return jnp.concatenate(
            [a[1:], jnp.full_like(a[:1], _RESTART)], axis=0
        )

    def step(prev, c):
        out = _step_update(shift_cols(prev, dx), c, p1, p2)
        return out, out

    init = jnp.full_like(cost[0], _RESTART)
    _, out = jax.lax.scan(step, init, cost, reverse=reverse, unroll=4)
    return out


@functools.partial(jax.jit, static_argnames=("cfg", "num_paths"))
def compute_disparity_sgm(
    left: jnp.ndarray,
    right: jnp.ndarray,
    cfg: StereoBMConfig = StereoBMConfig(),
    p1: float = 10.0,
    p2: float = 120.0,
    num_paths: int = 4,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """SGM disparity: prefilter → SAD cost volume → 4/8-path aggregation →
    WTA (+ texture/border gating and optional subpixel, as the BM path).

    Same output contract as ops/stereobm.compute_disparity.
    """
    if num_paths not in (2, 4, 8):
        raise ValueError("num_paths must be 2, 4 or 8")
    lf = bm_ops.prefilter(left, cfg)
    rf = bm_ops.prefilter(right, cfg)
    cost = bm_ops.sad_cost_volume(lf, rf, cfg)          # (nd, H, W), BIG=invalid
    nd, H, W = cost.shape
    # invalid candidates would poison the mins along paths: clamp to a large
    # finite penalty, track validity separately
    invalid = cost >= _BIG
    cost_c = jnp.where(invalid, 2.0 * p2 + 255.0 * cfg.block_size**2, cost)
    chw = jnp.moveaxis(cost_c, 0, -1)                   # (H, W, nd)

    agg = _aggregate_axis(chw, 1, False, p1, p2)        # left→right
    agg = agg + _aggregate_axis(chw, 1, True, p1, p2)   # right→left
    if num_paths >= 4:
        agg = agg + _aggregate_axis(chw, 0, False, p1, p2)
        agg = agg + _aggregate_axis(chw, 0, True, p1, p2)
    if num_paths == 8:
        # the four 45° diagonals: row scans with a per-step column shift
        agg = (agg
               + _aggregate_diagonal(chw, 1, False, p1, p2)    # ↘
               + _aggregate_diagonal(chw, -1, False, p1, p2)   # ↙
               + _aggregate_diagonal(chw, 1, True, p1, p2)     # ↗
               + _aggregate_diagonal(chw, -1, True, p1, p2))   # ↖

    agg = jnp.where(jnp.moveaxis(invalid, 0, -1), _BIG, agg)
    cost_agg = jnp.moveaxis(agg, -1, 0)                 # (nd, H, W)
    disp, valid = bm_ops.wta_disparity(cost_agg, lf, cfg)
    if cfg.lr_check:
        # consistency from the same aggregated volume (the left-indexed cost
        # generalises: candidates for right pixel xr live at x = xr + d)
        disp_r = bm_ops.right_disparity_from_cost(cost_agg, cfg)
        valid &= bm_ops.left_right_check(disp, disp_r, cfg, cfg.lr_max_diff)
        disp = jnp.where(valid, disp, jnp.float32(cfg.min_disparity - 1))
    return disp, valid
