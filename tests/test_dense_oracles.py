"""The dense stages' jnp paths (the one implementation on every device)
against the plain numpy references in numpy_oracles.py: BM and SGM winners
and validity exactly, remap to float tolerance (1 LSB for uint8), speckle
labels and keep decisions against scipy.ndimage.label components."""

import numpy as np
import pytest
import jax.numpy as jnp

import numpy_oracles as ref
from ros_gpu_stereo_processor_tpu.config import StereoBMConfig
from ros_gpu_stereo_processor_tpu.ops import sgm as sgm_ops
from ros_gpu_stereo_processor_tpu.ops import speckle as sp
from ros_gpu_stereo_processor_tpu.ops import stereobm as bm
from ros_gpu_stereo_processor_tpu.ops.remap import remap_bilinear
from ros_gpu_stereo_processor_tpu.utils.io import synthetic_stereo_pair


def _assert_matches(got, want, atol=1e-5):
    d, v = (np.asarray(a) for a in got)
    np.testing.assert_array_equal(v, want[1])
    np.testing.assert_allclose(d, want[0], atol=atol)


# ---------------------------------------------------------------------------
# block matching
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    left, right, _ = synthetic_stereo_pair(96, 200, max_disparity=40, seed=0)
    return left, right


@pytest.mark.parametrize(
    "kw",
    [
        dict(num_disparities=48, block_size=9, texture_threshold=10),
        dict(num_disparities=48, block_size=9, refine_disparity=True),
        dict(num_disparities=64, block_size=15, texture_threshold=0),
        dict(num_disparities=48, block_size=5, min_disparity=4),
        dict(num_disparities=16, block_size=21, texture_threshold=10),
        # the reference's construction default (src/GPUStereoProcessor.cpp:18)
        dict(num_disparities=48, block_size=19, texture_threshold=10),
    ],
)
def test_bm_matches_numpy_oracle(pair, kw):
    cfg = StereoBMConfig(**kw)
    left, right = pair
    _assert_matches(bm.compute_disparity(jnp.asarray(left), jnp.asarray(right),
                                         cfg),
                    ref.block_match(left, right, cfg))


@pytest.mark.parametrize("shape", [(48, 256), (70, 130)],
                         ids=["width_multiple_of_128", "width_not_aligned"])
def test_bm_widths_match_numpy_oracle(shape):
    left, right, _ = synthetic_stereo_pair(*shape, max_disparity=24, seed=5)
    cfg = StereoBMConfig(num_disparities=32, block_size=7, texture_threshold=5)
    _assert_matches(bm.compute_disparity(jnp.asarray(left), jnp.asarray(right),
                                         cfg),
                    ref.block_match(left, right, cfg))


def test_bm_uniqueness_matches_numpy_oracle(pair):
    cfg = StereoBMConfig(num_disparities=48, block_size=9, uniqueness_ratio=10)
    left, right = pair
    got = bm.compute_disparity(jnp.asarray(left), jnp.asarray(right), cfg)
    want = ref.block_match(left, right, cfg)
    _assert_matches(got, want)
    # the ratio must actually bite on this scene
    assert want[1].sum() < ref.block_match(
        left, right, cfg.replace(uniqueness_ratio=0))[1].sum()


def test_bm_lr_check_matches_numpy_oracle(pair):
    cfg = StereoBMConfig(num_disparities=48, block_size=9, texture_threshold=10,
                         lr_check=True)
    left, right = pair
    got = bm.compute_disparity(jnp.asarray(left), jnp.asarray(right), cfg)
    want = ref.block_match(left, right, cfg)
    _assert_matches(got, want)
    assert want[1].sum() < ref.block_match(
        left, right, cfg.replace(lr_check=False))[1].sum()


# ---------------------------------------------------------------------------
# SGM (4 paths)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_pair():
    left, right, _ = synthetic_stereo_pair(48, 160, max_disparity=12, seed=0)
    return left, right


def _check_sgm(left, right, cfg, p1=10.0, p2=120.0):
    got = sgm_ops.compute_disparity_sgm(jnp.asarray(left), jnp.asarray(right),
                                        cfg, p1=p1, p2=p2, num_paths=4)
    _assert_matches(got, ref.sgm(left, right, cfg, p1=p1, p2=p2))


@pytest.mark.parametrize(
    "kw,p1,p2",
    [
        (dict(block_size=5, texture_threshold=5), 10.0, 120.0),
        (dict(block_size=9, texture_threshold=10), 10.0, 120.0),
        (dict(block_size=5, min_disparity=2, texture_threshold=5), 10.0, 120.0),
        (dict(block_size=5, texture_threshold=5, lr_check=True), 10.0, 120.0),
        (dict(block_size=5, texture_threshold=5), 7.5, 93.25),
        (dict(block_size=5, texture_threshold=5), 20.0, 600.0),
    ],
    ids=["basic", "block9", "min_disparity", "lr_check",
         "fractional_penalties", "large_p2"],
)
def test_sgm_matches_numpy_oracle(small_pair, kw, p1, p2):
    _check_sgm(*small_pair, StereoBMConfig(num_disparities=16, **kw), p1, p2)


def test_sgm_32_disparities_matches_numpy_oracle():
    left, right, _ = synthetic_stereo_pair(40, 192, max_disparity=24, seed=3)
    _check_sgm(left, right, StereoBMConfig(num_disparities=32, block_size=5,
                                           texture_threshold=5))


def test_sgm_odd_width_matches_numpy_oracle():
    """Width far from any power of two, noise images, subpixel on."""
    rng = np.random.default_rng(7)
    left = rng.integers(0, 255, (48, 200)).astype(np.uint8)
    right = rng.integers(0, 255, (48, 200)).astype(np.uint8)
    _check_sgm(left, right, StereoBMConfig(num_disparities=16, block_size=5,
                                           texture_threshold=10,
                                           refine_disparity=True))


# ---------------------------------------------------------------------------
# bilinear remap
# ---------------------------------------------------------------------------


def _warp_map(H, W, a=0.01, b=0.01, ox=3.5, oy=-2.25):
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    return np.stack([xx + ox + a * yy, yy + oy + b * xx], -1).astype(np.float32)


def test_remap_float_matches_numpy_oracle():
    rng = np.random.default_rng(0)
    img = rng.random((64, 256)).astype(np.float32)
    m = _warp_map(64, 256)
    got = np.asarray(remap_bilinear(jnp.asarray(img), jnp.asarray(m)))
    np.testing.assert_allclose(got, ref.remap_bilinear(img, m), atol=1e-5)


def test_remap_out_of_range_is_zero():
    img = np.full((32, 128), 7.0, np.float32)
    yy, xx = np.mgrid[0:32, 0:128].astype(np.float32)
    m = np.stack([xx - 20.0, yy], -1).astype(np.float32)   # left cols OOB
    got = np.asarray(remap_bilinear(jnp.asarray(img), jnp.asarray(m)))
    np.testing.assert_allclose(got, ref.remap_bilinear(img, m), atol=1e-6)
    assert (got[:, :20] == 0).all() and (got[:, 21:] == 7.0).all()


def test_remap_color_channels_match_numpy_oracle():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (60, 100, 3), np.uint8)
    m = _warp_map(60, 100, a=0.02, b=-0.015, ox=1.3, oy=0.7)
    got = np.asarray(remap_bilinear(jnp.asarray(img), jnp.asarray(m)))
    diff = np.abs(got.astype(int) - ref.remap_bilinear(img, m).astype(int))
    # f32 vs f64 interpolation may round a .5 case the other way
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


def test_remap_row_sharded_matches_numpy_oracle():
    """The mesh pipeline's rectify stage (remap under a row-band sharding
    constraint) against the numpy reference on a distorted calibration."""
    from ros_gpu_stereo_processor_tpu.config import Outputs, PipelineConfig
    from ros_gpu_stereo_processor_tpu.models.pipeline import StereoPipeline
    from ros_gpu_stereo_processor_tpu.parallel.mesh import make_mesh
    from ros_gpu_stereo_processor_tpu.utils.synth import euroc_rig_frame

    model, left, right, _ = euroc_rig_frame(width=192, height=96,
                                            max_disparity=16)
    pipe = StereoPipeline(model, PipelineConfig(), mesh=make_mesh(4, ("rows",)))
    out = pipe.process(left, right, Outputs.of("rect_mono_left",
                                               "rect_mono_right"))
    assert "rows" in str(out.outputs["rect_mono_left"].sharding.spec)
    out = out.fetch()
    for side, img in (("left", left), ("right", right)):
        want = ref.remap_bilinear(img, getattr(model, side).rect_map)
        diff = np.abs(out[f"rect_mono_{side}"].astype(int) - want.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, side


# ---------------------------------------------------------------------------
# speckle: labels and keep decisions vs scipy.ndimage.label components
# ---------------------------------------------------------------------------


def _quantized_case(H, W, seed):
    """Disparities 10 apart (max_diff 5 ⇒ neighbours join iff equal), with
    flat patches and invalid holes."""
    rng = np.random.default_rng(seed)
    disp = (rng.integers(0, 4, (H, W)) * 10).astype(np.float32)
    disp[4:12, 10:40] = 50.0                  # one large component
    disp[1:3, 1:3] = 60.0                     # one 4-pixel speckle
    valid = rng.random((H, W)) > 0.3
    return disp, valid


@pytest.mark.parametrize("shape", [(48, 130), (40, 128), (37, 257), (64, 752)])
def test_speckle_labels_match_ndimage_label(shape):
    disp, valid = _quantized_case(*shape, seed=7)
    got = np.asarray(sp._labels_scan(jnp.asarray(disp), jnp.asarray(valid),
                                     5.0, 32))
    want = ref.min_index_labels(ref.component_labels(disp, valid))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(48, 130), (64, 752)])
def test_speckle_filter_matches_ndimage_bincount(shape):
    disp, valid = _quantized_case(*shape, seed=11)
    T = 6
    labels = ref.component_labels(disp, valid)
    keep = valid & (np.bincount(labels.ravel())[labels] > T)
    out, k = sp.filter_speckles(jnp.asarray(disp), jnp.asarray(valid),
                                max_speckle_size=T, max_diff=5.0, iters=32)
    np.testing.assert_array_equal(np.asarray(k), keep)
    np.testing.assert_array_equal(np.asarray(out), np.where(keep, disp, -1.0))


def test_max_propagate_matches_component_max():
    from scipy import ndimage

    disp, valid = _quantized_case(48, 160, seed=3)
    field = np.random.default_rng(5).integers(0, 900, disp.shape).astype(np.int32)
    cx, cy = sp._connectivity(jnp.asarray(disp), jnp.asarray(valid), 5.0)
    got = np.asarray(sp._max_propagate(jnp.asarray(field), cx, cy, 64))
    labels = ref.component_labels(disp, valid)
    comp_max = np.concatenate([[0], ndimage.maximum(
        field, labels, np.arange(1, labels.max() + 1))])
    np.testing.assert_array_equal(got, np.where(labels > 0, comp_max[labels],
                                                field))
