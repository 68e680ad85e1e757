"""Disparity bilateral filter (ops/bilateral.py) vs a direct numpy oracle.

The reference stubs this component (creation/apply commented out,
src/StereoProcessor.cpp:324-335) — these tests pin down the *intended*
cv::cuda::DisparityBilateralFilter semantics (SURVEY.md §2.8b) against a
literal per-pixel loop implementation.
"""

import math

import numpy as np
import pytest

from ros_gpu_stereo_processor_tpu.ops.bilateral import disparity_bilateral_filter


def oracle(disp, guide, ndisp, radius, iters, edge_threshold,
           max_disc_threshold, sigma_range):
    """Literal checkerboard relaxation, per-pixel loops."""
    d = disp.astype(np.float64).copy()
    g = guide.astype(np.float64)
    if g.ndim == 2:
        g = g[..., None]
    H, W = d.shape
    edge_disc = max(1.0, ndisp * edge_threshold)
    max_disc = ndisp * max_disc_threshold
    inv = 1.0 / (2.0 * sigma_range * sigma_range)

    for _ in range(iters):
        for t in (0, 1):
            new = d.copy()
            for y in range(1, H - 1):
                for x in range(1, W - 1):
                    if (x + y + t) % 2 != 0:
                        continue
                    dp = [d[y, x], d[y - 1, x], d[y, x - 1],
                          d[y + 1, x], d[y, x + 1]]
                    if not any(abs(dp[k] - dp[0]) >= edge_disc
                               for k in range(1, 5)):
                        continue
                    cost = [0.0] * 5
                    for yi in range(max(0, y - radius), min(H, y + radius + 1)):
                        for xi in range(max(0, x - radius), min(W, x + radius + 1)):
                            di = np.max(np.abs(g[yi, xi] - g[y, x]))
                            w = math.exp(-di * di * inv) * math.exp(
                                -math.hypot(y - yi, x - xi) / (radius + 1.0)
                            )
                            for k in range(5):
                                cost[k] += w * min(max_disc, abs(d[yi, xi] - dp[k]))
                    new[y, x] = dp[int(np.argmin(cost))]
            d = new
    return d


def make_scene(rng, H=24, W=32):
    """Step-edge scene: guidance image with a vertical edge, disparity with
    noise that leaks across the edge (the case the filter exists for)."""
    guide = np.full((H, W), 40.0, np.float32)
    guide[:, W // 2:] = 200.0
    disp = np.full((H, W), 10.0, np.float32)
    disp[:, W // 2:] = 40.0
    noise_mask = rng.random((H, W)) < 0.15
    disp = np.where(noise_mask, disp + rng.integers(-30, 30, (H, W)), disp)
    return disp.astype(np.float32), guide


@pytest.mark.parametrize("radius,iters", [(1, 1), (2, 1), (2, 3), (3, 2)])
def test_matches_oracle(radius, iters):
    rng = np.random.default_rng(7 * radius + iters)
    disp, guide = make_scene(rng)
    got = np.asarray(
        disparity_bilateral_filter(
            disp, guide, ndisp=64, radius=radius, iters=iters,
            edge_threshold=0.1, max_disc_threshold=0.2, sigma_range=10.0,
        )
    )
    want = oracle(disp, guide, 64, radius, iters, 0.1, 0.2, 10.0)
    np.testing.assert_allclose(got, want.astype(np.float32), atol=1e-4)


def test_matches_oracle_color_guide():
    rng = np.random.default_rng(3)
    disp, guide = make_scene(rng)
    guide3 = np.stack([guide, guide * 0.5 + 10, np.flip(guide, 1)], -1)
    got = np.asarray(
        disparity_bilateral_filter(
            disp, guide3, ndisp=64, radius=2, iters=1,
            edge_threshold=0.1, max_disc_threshold=0.2, sigma_range=10.0,
        )
    )
    want = oracle(disp, guide3, 64, 2, 1, 0.1, 0.2, 10.0)
    np.testing.assert_allclose(got, want.astype(np.float32), atol=1e-4)


def test_smooth_regions_untouched():
    """Pixels with no ≥edge_disc neighbour jump are bit-identical."""
    rng = np.random.default_rng(0)
    disp = (rng.random((20, 28)) * 2.0).astype(np.float32) + 15.0  # jumps < 6.4
    guide = (rng.random((20, 28)) * 255).astype(np.float32)
    out = np.asarray(
        disparity_bilateral_filter(disp, guide, ndisp=64, radius=3, iters=4)
    )
    np.testing.assert_array_equal(out, disp)


def test_denoises_speckle_preserving_edge():
    """Impulse outliers get replaced by neighbour disparities; the true
    depth edge (aligned with the guidance edge) survives."""
    rng = np.random.default_rng(11)
    H, W = 24, 32
    guide = np.full((H, W), 40.0, np.float32)
    guide[:, W // 2:] = 200.0
    clean = np.full((H, W), 10.0, np.float32)
    clean[:, W // 2:] = 40.0
    disp = clean.copy()
    outliers = rng.random((H, W)) < 0.08
    outliers[0, :] = outliers[-1, :] = False
    outliers[:, 0] = outliers[:, -1] = False
    disp[outliers] = 90.0
    out = np.asarray(
        disparity_bilateral_filter(disp, guide, ndisp=64, radius=3, iters=3)
    )
    err_before = np.abs(disp - clean)[outliers].mean()
    err_after = np.abs(out - clean)[outliers].mean()
    assert err_after < 0.2 * err_before
    # edge columns intact away from outliers
    inner = ~outliers
    np.testing.assert_array_equal(out[1:-1, 1:-1][inner[1:-1, 1:-1]],
                                  clean[1:-1, 1:-1][inner[1:-1, 1:-1]])


def test_pipeline_integration(stereo_model, kitchen_images):
    """bilateral_filter=True flows through the demand-driven pipeline and
    reconfigure() accepts the reference's cfg/GPU.cfg parameter names."""
    from ros_gpu_stereo_processor_tpu.config import Outputs, PipelineConfig
    from ros_gpu_stereo_processor_tpu.models.pipeline import StereoPipeline

    pipe = StereoPipeline(stereo_model, PipelineConfig())
    outs = Outputs.of("disparity")
    base = pipe.process(
        kitchen_images["left"], kitchen_images["right"], outs
    ).fetch()["disparity"]

    pipe.reconfigure(bilateral_filter=True, filter_radius=2, filter_iters=1)
    assert pipe.config.bilateral.enabled and pipe.config.bilateral.radius == 2
    refined = pipe.process(
        kitchen_images["left"], kitchen_images["right"], outs
    ).fetch()["disparity"]
    assert refined.shape == base.shape
    assert not np.array_equal(refined, base)  # it did something
    # it only rewrites pixels with candidate values drawn from the frame
    changed = refined != base
    assert changed.mean() < 0.5  # refinement, not wholesale rewrite
