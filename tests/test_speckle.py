"""Speckle filter tests: behavioural equivalence with cv2.filterSpeckles
(the reference's CPU filter, src/GPUStereoProcessor.cpp:356-385), validated
statistically per SURVEY.md §7 'hard parts'."""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
import jax.numpy as jnp

from ros_gpu_stereo_processor_tpu.ops.speckle import filter_speckles


def cv_filter(disp, max_size, max_diff, invalid=-1.0):
    # cv2.filterSpeckles wants 16SC1: use ×16 fixed point (exactly the
    # reference's 8U→16S convert-filter-convert dance,
    # src/GPUStereoProcessor.cpp:367-385)
    d16 = np.round(disp * 16.0).astype(np.int16)
    cv2.filterSpeckles(d16, int(invalid * 16), max_size, int(max_diff * 16))
    out = d16.astype(np.float32) / 16.0
    return out


def test_removes_small_blob_keeps_large():
    d = np.zeros((64, 96), np.float32)
    d[:] = 10.0
    d[5:8, 5:8] = 30.0          # 9-px speckle, far from background
    d[20:50, 20:60] = 20.0      # 1200-px region, kept
    out, keep = filter_speckles(
        jnp.asarray(d), jnp.ones_like(d, bool), max_speckle_size=100, max_diff=2.0
    )
    out, keep = np.asarray(out), np.asarray(keep)
    assert not keep[6, 6]
    assert keep[30, 30]
    assert keep[0, 0]           # big background kept
    assert out[6, 6] == -1.0


def test_matches_cv2_on_synthetic():
    """Random blobby disparity: per-pixel decisions match cv2.filterSpeckles
    on ≥99% of pixels."""
    rng = np.random.default_rng(0)
    H, W = 96, 128
    d = np.full((H, W), 8.0, np.float32)
    # sprinkle speckles of varied size
    for _ in range(30):
        y, x = rng.integers(0, H - 6), rng.integers(0, W - 6)
        h, w = rng.integers(1, 6, size=2)
        d[y : y + h, x : x + w] = rng.uniform(20, 60)
    ref = cv_filter(d, max_size=24, max_diff=2.0)
    out, keep = filter_speckles(
        jnp.asarray(d), jnp.ones_like(d, bool), max_speckle_size=24, max_diff=2.0
    )
    out = np.asarray(out)
    agree = (out == ref) | (np.abs(out - ref) < 1e-6)
    assert agree.mean() > 0.99, agree.mean()


def test_matches_cv2_on_real_disparity(aloe_images):
    """Aloe disparity through both filters: ≥98% agreement on kept/removed."""
    cfg_size, cfg_diff = 100, 2.0
    d = aloe_images["disp"].astype(np.float32) / 4.0  # GT stored scaled
    d[d <= 0] = -1.0
    valid = d > 0
    ref = cv_filter(d.copy(), cfg_size, cfg_diff)
    out, keep = filter_speckles(
        jnp.asarray(d), jnp.asarray(valid), max_speckle_size=cfg_size,
        max_diff=cfg_diff, iters=24,
    )
    out = np.asarray(out)
    removed_ref = (ref == -1.0) & valid
    removed_ours = (~np.asarray(keep)) & valid
    agree = removed_ref == removed_ours
    assert agree.mean() > 0.98, agree.mean()


def test_disabled_keeps_everything():
    d = np.full((16, 16), 5.0, np.float32)
    out, keep = filter_speckles(
        jnp.asarray(d), jnp.ones_like(d, bool), max_speckle_size=0, max_diff=1.0
    )
    # size>0 components always exceed 0 ⇒ everything kept
    assert np.asarray(keep).all()


def test_invalid_input_stays_invalid():
    d = np.full((32, 32), 7.0, np.float32)
    valid = np.ones_like(d, bool)
    valid[:16] = False
    out, keep = filter_speckles(
        jnp.asarray(d), jnp.asarray(valid), max_speckle_size=10, max_diff=1.0
    )
    assert not np.asarray(keep)[:16].any()
    assert np.asarray(keep)[16:].all()


@pytest.mark.parametrize("T", [0, 1, 7, 40, 4095, 4096])
def test_keep_large_components_matches_bincount(T):
    """The 2-sort windowed run-extent decision equals exact
    ``bincount(lab)[lab] > T`` for ANY label image."""
    from ros_gpu_stereo_processor_tpu.ops.speckle import (
        _keep_large_components,
    )

    rng = np.random.default_rng(13)
    lab = rng.integers(0, 37, (64, 64)).astype(np.int32)
    want = (np.bincount(lab.reshape(-1), minlength=64)[lab] > T)
    got = np.asarray(_keep_large_components(jnp.asarray(lab), T))
    np.testing.assert_array_equal(got, want)


def test_keep_decision_exact_on_nonconverged_labels():
    """Sizing semantics are bincount-of-labels even when the label image is
    NOT converged to true components (fragments of one component still
    carrying different labels) — the former banded reconciliation assumed
    label groups were 4-connected and could undercount there."""
    from ros_gpu_stereo_processor_tpu.ops import speckle as sp

    rng = np.random.default_rng(0)
    H, W = 96, 160
    d = np.full((H, W), 8.0, np.float32)
    for _ in range(60):
        y, x = rng.integers(0, H - 8), rng.integers(0, W - 8)
        h, w = rng.integers(1, 8, size=2)
        d[y:y + h, x:x + w] = rng.uniform(20, 60)
    valid = rng.random((H, W)) > 0.1
    T = 40
    # deliberately under-iterate so labels stay non-converged
    lab = np.asarray(sp._labels_scan(jnp.asarray(d), jnp.asarray(valid),
                                     5.0, 2))
    want = (np.bincount(lab.reshape(-1), minlength=H * W + 1)[lab] > T)
    got = np.asarray(sp._keep_large_components(jnp.asarray(lab), T))
    np.testing.assert_array_equal(got, want)
