"""Color/encoding conversion tests — the reference's exact-pixel conversion
unit tests (GpuColorConversion*, test/UTest.cpp:190-245) plus debayer checks
against the cv2 oracle."""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
import jax.numpy as jnp

from ros_gpu_stereo_processor_tpu.ops import color as C


def test_bgr_to_mono_controlled_exact():
    """BGR8 → mono8 on controlled pixel values, exact (the reference's
    1×1-pixel test pattern, test/UTest.cpp:190-208)."""
    bgr = np.array([[[1, 2, 3]], [[128, 128, 128]], [[255, 0, 0]],
                    [[0, 255, 0]], [[0, 0, 255]], [[255, 255, 255]]], np.uint8)
    ref = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
    ours = np.asarray(C.convert(jnp.asarray(bgr), "bgr8", "mono8"))
    np.testing.assert_array_equal(ours, ref)


def test_bgr_to_mono_random_within_1lsb():
    """Random images: within 1 LSB of cv2 (whose float path rounds in higher
    intermediate precision than an f32 kernel)."""
    rng = np.random.default_rng(0)
    bgr = rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8)
    ref = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
    ours = np.asarray(C.convert(jnp.asarray(bgr), "bgr8", "mono8"))
    diff = np.abs(ours.astype(int) - ref.astype(int))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 0.01


def test_rgb_to_mono_within_1lsb():
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8)
    ref = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)
    ours = np.asarray(C.convert(jnp.asarray(rgb), "rgb8", "mono8"))
    diff = np.abs(ours.astype(int) - ref.astype(int))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 0.01


def test_rgb_bgr_swap_exact():
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 256, size=(8, 8, 3), dtype=np.uint8)
    ours = np.asarray(C.convert(jnp.asarray(rgb), "rgb8", "bgr8"))
    np.testing.assert_array_equal(ours, rgb[..., ::-1])
    back = np.asarray(C.convert(jnp.asarray(ours), "bgr8", "rgb8"))
    np.testing.assert_array_equal(back, rgb)


def test_mono_to_color_exact():
    """mono → 3-channel gray replication (test/UTest.cpp:228-245)."""
    rng = np.random.default_rng(3)
    mono = rng.integers(0, 256, size=(8, 8), dtype=np.uint8)
    ours = np.asarray(C.convert(jnp.asarray(mono), "mono8", "rgb8"))
    assert ours.shape == (8, 8, 3)
    for c in range(3):
        np.testing.assert_array_equal(ours[..., c], mono)


def test_mono8_mono16_roundtrip():
    """8↔16-bit rescale with the reference's 257× factor
    (src/GPUStereoProcessor.cpp:154-158)."""
    mono = np.arange(256, dtype=np.uint8).reshape(16, 16)
    up = np.asarray(C.convert(jnp.asarray(mono), "mono8", "mono16"))
    np.testing.assert_array_equal(up, mono.astype(np.uint16) * 257)
    down = np.asarray(C.convert(jnp.asarray(up), "mono16", "mono8"))
    np.testing.assert_array_equal(down, mono)


@pytest.mark.parametrize(
    "enc,code",
    [
        ("bayer_rggb8", cv2.COLOR_BayerBG2RGB),
        ("bayer_bggr8", cv2.COLOR_BayerRG2RGB),
        ("bayer_grbg8", cv2.COLOR_BayerGB2RGB),
        ("bayer_gbrg8", cv2.COLOR_BayerGR2RGB),
    ],
)
def test_debayer_matches_cv2_interior(enc, code):
    """Bilinear demosaic ≈ cv2 bilinear demosaic on the interior (borders use
    different extrapolation conventions)."""
    rng = np.random.default_rng(4)
    raw = rng.integers(0, 256, size=(32, 48), dtype=np.uint8)
    ref = cv2.cvtColor(raw, code)
    ours = np.asarray(C.convert(jnp.asarray(raw), enc, "rgb8"))
    interior = (slice(2, -2), slice(2, -2))
    diff = np.abs(ours[interior].astype(int) - ref[interior].astype(int))
    # identical bilinear weights ⇒ at most rounding differences
    assert diff.max() <= 1, diff.max()


def test_debayer_mono_consistency():
    """Bayer → mono8 goes through RGB with exact BT.601 (cv2 parity interior)."""
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 256, size=(32, 48), dtype=np.uint8)
    ref = cv2.cvtColor(cv2.cvtColor(raw, cv2.COLOR_BayerBG2RGB), cv2.COLOR_RGB2GRAY)
    ours = np.asarray(C.convert(jnp.asarray(raw), "bayer_rggb8", "mono8"))
    interior = (slice(2, -2), slice(2, -2))
    diff = np.abs(ours[interior].astype(int) - ref[interior].astype(int))
    assert diff.max() <= 2
    assert np.mean(diff) < 0.2


def test_same_encoding_copy():
    img = np.zeros((4, 4), np.uint8)
    out = C.convert(jnp.asarray(img), "mono8", "mono8")
    np.testing.assert_array_equal(np.asarray(out), img)


def test_unknown_encoding_raises():
    with pytest.raises(ValueError):
        C.encoding("yuv422")
