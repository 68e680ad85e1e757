"""Disparity bilateral filter — edge-preserving disparity refinement.

The reference declares and fully parameterises a
``cv::cuda::DisparityBilateralFilter`` but never enables it (a stub: members
at include/gpuimageproc/GPUStereoProcessor.h:118 and StereoProcessor.h:95,
the 7-parameter reconfigure group at cfg/GPU.cfg:21-27, and the creation /
apply block commented out at src/StereoProcessor.cpp:324-335).  Per
SURVEY.md §2.8b this implements the *intended* component with the same
parameter surface.

Semantics follow the OpenCV CUDA operator (Yang et al., "Spatial-depth super
resolution for range images" family of refinements): an iterated
checkerboard relaxation where each pixel may replace its disparity with one
of five candidates — its own value or a 4-neighbour's — choosing the
candidate with the lowest bilateral-weighted truncated-L1 cost over a
(2·radius+1)² guidance window:

  * a pixel is only *touched* when a 4-neighbour disparity jump exceeds
    ``edge_disc = max(1, ndisp · edge_threshold)`` (elsewhere the disparity
    is already smooth and is left bit-identical);
  * candidate cost  C_k = Σ_window  w(q) · min(max_disc, |d(q) − dp_k|),
    with ``max_disc = ndisp · max_disc_threshold`` truncating the disparity
    continuity term;
  * bilateral weight w(q) = exp(−ΔI(q)²/(2·sigma_range²)) ·
    exp(−dist(p,q)/(radius+1)) — intensity term over the *guidance image*
    (rectified mono/color: ΔI = max-channel absolute difference) and the
    OpenCV spatial falloff with characteristic length radius+1;
  * updates run on an alternating checkerboard (pixels with
    (x+y+t) even in sub-step t ∈ {0,1}) so each half-step sees the other
    half's freshly relaxed values — the parallel-safe form of sequential
    propagation.

Borders (the outermost 1-pixel frame) are never modified; guidance windows
are clamped to the image, out-of-bounds taps get zero weight.

Compilation notes: ``radius`` and ``iters`` are jit-static so the
candidate/offset loops fully unroll into fused vector ops — there is no
data-dependent control flow, the "touched" predicate becomes a select.  Costs
accumulate in f32; no gathers (window taps are static-offset pads/slices).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _pad_edge(x: jnp.ndarray, r: int) -> jnp.ndarray:
    pad = [(r, r), (r, r)] + [(0, 0)] * (x.ndim - 2)
    return jnp.pad(x, pad, mode="edge")


def _intensity_dist(img: jnp.ndarray, shifted: jnp.ndarray) -> jnp.ndarray:
    """Guidance distance: |ΔI| for mono, max-channel |ΔI| for color (the
    OpenCV DistRgbMax reduction)."""
    d = jnp.abs(shifted.astype(jnp.float32) - img.astype(jnp.float32))
    if d.ndim == 3:
        d = jnp.max(d, axis=-1)
    return d


def _bilateral_core(
    d: jnp.ndarray,
    g: jnp.ndarray,
    valid: jnp.ndarray,
    *,
    ndisp: int,
    radius: int,
    iters: int,
    edge_threshold: float,
    max_disc_threshold: float,
    sigma_range: float,
    row_offset: int | jnp.ndarray = 0,
    total_rows: int | None = None,
) -> jnp.ndarray:
    """Filter body shared by the single-chip entry point and the row-band
    sharded path (parallel/frontend.bilateral_row_sharded).

    ``valid`` (H, W float 1/0) marks real image pixels: taps where it is 0
    get zero bilateral weight (the single-chip out-of-image padding rule).
    ``row_offset``/``total_rows`` express border/parity decisions in *global*
    image coordinates so a halo-extended row band computes exactly what the
    full image would.
    """
    H, W = d.shape

    if total_rows is None:
        total_rows = H
    edge_disc = max(1.0, float(ndisp) * float(edge_threshold))
    max_disc = jnp.float32(float(ndisp) * float(max_disc_threshold))
    inv_2sr2 = 1.0 / (2.0 * float(sigma_range) * float(sigma_range))

    # spatial weight table: exp(-sqrt(dy²+dx²)/(radius+1)), OpenCV's
    # calc_space_weighted_filter with dist_space = radius + 1
    offs = [(dy, dx) for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1)]
    import math

    w_space = {
        (dy, dx): math.exp(-math.sqrt(dy * dy + dx * dx) / (radius + 1.0))
        for (dy, dx) in offs
    }

    yy = jnp.arange(H)[:, None] + row_offset     # global row coordinate
    xx = jnp.arange(W)[None, :]
    interior = (yy > 0) & (yy < total_rows - 1) & (xx > 0) & (xx < W - 1)
    parity = (yy + xx) % 2

    # guidance taps and their weights are iteration-invariant: precompute
    # w(q) per offset once (saves (iters·2−1)×window recomputes).
    # Guide may be padded with anything — invalid taps get weight 0.
    gp = _pad_edge(g, radius)
    valid_pad = jnp.pad(
        valid.astype(jnp.float32), ((radius, radius), (radius, radius))
    )
    weights = []
    for dy, dx in offs:
        g_s = jax.lax.dynamic_slice_in_dim(
            jax.lax.dynamic_slice_in_dim(gp, dy + radius, H, axis=0),
            dx + radius, W, axis=1,
        )
        v_s = jax.lax.dynamic_slice_in_dim(
            jax.lax.dynamic_slice_in_dim(valid_pad, dy + radius, H, axis=0),
            dx + radius, W, axis=1,
        )
        di = _intensity_dist(g, g_s)
        weights.append(v_s * jnp.exp(-di * di * inv_2sr2) * w_space[(dy, dx)])

    def half_step(d, t):
        # 5 candidates: centre + 4-neighbours (OpenCV dp[0..4] order; ties
        # keep the lowest index → centre wins)
        dpad = jnp.pad(d, 1, mode="edge")
        cands = jnp.stack(
            [
                d,
                dpad[0:H, 1 : W + 1],      # up
                dpad[1 : H + 1, 0:W],      # left
                dpad[2 : H + 2, 1 : W + 1],  # down
                dpad[1 : H + 1, 2 : W + 2],  # right
            ],
            axis=0,
        )  # (5, H, W)
        touched = jnp.any(jnp.abs(cands[1:] - cands[0]) >= edge_disc, axis=0)

        dp = jnp.pad(d, radius)  # zero-pad fine: taps weighted 0 out of bounds
        cost = jnp.zeros((5, H, W), jnp.float32)
        for (dy, dx), w in zip(offs, weights):
            d_s = jax.lax.dynamic_slice_in_dim(
                jax.lax.dynamic_slice_in_dim(dp, dy + radius, H, axis=0),
                dx + radius, W, axis=1,
            )
            cost = cost + w * jnp.minimum(
                max_disc, jnp.abs(d_s[None] - cands)
            )
        best = jnp.argmin(cost, axis=0)  # lowest index on ties
        new_d = jnp.take_along_axis(cands, best[None], axis=0)[0]
        active = interior & touched & (((parity + t) % 2) == 0)
        return jnp.where(active, new_d, d)

    for _ in range(int(iters)):
        d = half_step(d, 0)
        d = half_step(d, 1)
    return d


@functools.partial(
    jax.jit,
    static_argnames=(
        "ndisp",
        "radius",
        "iters",
        "edge_threshold",
        "max_disc_threshold",
        "sigma_range",
    ),
)
def disparity_bilateral_filter(
    disp: jnp.ndarray,
    guide: jnp.ndarray,
    *,
    ndisp: int = 64,
    radius: int = 3,
    iters: int = 1,
    edge_threshold: float = 0.1,
    max_disc_threshold: float = 0.2,
    sigma_range: float = 10.0,
) -> jnp.ndarray:
    """Refine ``disp`` (H, W, float32) guided by ``guide`` (H, W[, C]).

    Parameter names/defaults mirror the reference's reconfigure group
    (cfg/GPU.cfg:21-27: filter_ndisp/radius/iters/edge_threshold/
    max_disc_threshold/sigma_range).  Returns the refined disparity, same
    shape/dtype.
    """
    if radius < 1:
        raise ValueError(f"radius={radius} must be >= 1")
    H, W = disp.shape
    out = _bilateral_core(
        disp.astype(jnp.float32),
        guide.astype(jnp.float32),
        jnp.ones((H, W), jnp.float32),
        ndisp=ndisp,
        radius=radius,
        iters=iters,
        edge_threshold=edge_threshold,
        max_disc_threshold=max_disc_threshold,
        sigma_range=sigma_range,
    )
    return out.astype(disp.dtype)
