"""End-to-end pipeline tests — the reference's integration tests
(DisparityGpu, PointCloud, test/UTest.cpp:290-399) recast: golden 752×480 pair
through upload→rectify→disparity→cloud, headless NULL-publisher senders, and
demand-driven variant selection."""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from ros_gpu_stereo_processor_tpu.config import Outputs, PipelineConfig, StereoBMConfig, SpeckleConfig
from ros_gpu_stereo_processor_tpu.models.pipeline import StereoPipeline
from tests.conftest import mean_abs_error


@pytest.fixture(scope="module")
def pipeline(stereo_model):
    cfg = PipelineConfig(
        stereobm=StereoBMConfig(num_disparities=64, block_size=15, texture_threshold=10),
        speckle=SpeckleConfig(max_speckle_size=800, max_diff=5.0, propagation_iters=16),
    )
    return StereoPipeline(stereo_model, cfg)


def test_full_pipeline_all_outputs(pipeline, kitchen_images):
    res = pipeline.process(
        kitchen_images["left"], kitchen_images["right"], Outputs.all()
    )
    out = res.fetch()
    H, W = 480, 752
    assert out["mono_left"].shape == (H, W)
    assert out["color_left"].shape == (H, W, 3)
    assert out["rect_mono_left"].shape == (H, W)
    assert out["rect_color_left"].shape == (H, W, 3)
    assert out["disparity"].shape == (H, W)
    assert out["disparity_vis"].shape == (H, W, 3)
    assert out["pointcloud_xyz"].shape == (H, W, 3)
    assert out["pointcloud_rgb"].shape == (H, W)

    # rectified output matches the reference's golden within its GPU gate
    assert mean_abs_error(out["rect_mono_left"], kitchen_images["left_rect"]) <= 0.1

    # some valid disparity was produced
    valid = out["disparity_valid"]
    assert valid.mean() > 0.05

    # point cloud: valid disparity pixels → finite points with plausible depth
    xyz = out["pointcloud_xyz"]
    finite = np.isfinite(xyz).all(axis=-1)
    # finite ⇔ valid with positive disparity (d=0 ⇒ Z=∞ ⇒ NaN, the
    # reference's MISSING_Z convention)
    expect = valid & (out["disparity"] > 0)
    assert (finite == expect).all()
    z = xyz[finite][:, 2]
    assert (z > 0).all()
    assert np.median(z) < 20.0  # indoor kitchen scene


def test_disparity_parity_with_cv2_full_path(pipeline, stereo_model, kitchen_images):
    """Rectify+match with cv2 end-to-end as oracle; ≥85% joint-valid agreement
    within 1 disparity (the reference compares its GPU path to cv::StereoBM
    the same way, test/UTest.cpp:290-331)."""
    bm = pipeline.config.stereobm
    m = stereo_model
    rect = {}
    for side in ("left", "right"):
        mp = getattr(m, side).rect_map
        rect[side] = cv2.remap(
            kitchen_images[side], mp[..., 0], mp[..., 1], cv2.INTER_LINEAR
        )
    sbm = cv2.StereoBM_create(bm.num_disparities, bm.block_size)
    sbm.setPreFilterType(cv2.STEREO_BM_PREFILTER_XSOBEL)
    sbm.setPreFilterCap(bm.prefilter_cap)
    sbm.setTextureThreshold(bm.texture_threshold)
    sbm.setUniquenessRatio(0)
    sbm.setSpeckleWindowSize(0)
    d16 = sbm.compute(rect["left"], rect["right"])
    ref_disp = d16.astype(np.float32) / 16.0
    ref_valid = d16 > -16

    res = pipeline.process(
        kitchen_images["left"], kitchen_images["right"], Outputs.of("disparity")
    )
    out = res.fetch()
    both = ref_valid & out["disparity_valid"]
    assert both.mean() > 0.05
    agree = np.abs(out["disparity"][both] - ref_disp[both]) <= 1.0
    assert agree.mean() > 0.85, agree.mean()


def test_demand_driven_outputs(pipeline, kitchen_images):
    """Only requested outputs are computed/returned (the reference's lazy
    topic gating, src/StereoProcessor.cpp:104-142)."""
    res = pipeline.process(
        kitchen_images["left"], kitchen_images["right"], Outputs.of("mono_left")
    )
    assert set(res.outputs) == {"mono_left"}

    res = pipeline.process(
        kitchen_images["left"], kitchen_images["right"], Outputs.of("disparity")
    )
    assert set(res.outputs) == {"disparity", "disparity_valid"}


def test_variant_cache(pipeline, kitchen_images):
    n0 = len(pipeline._variants)
    for _ in range(3):
        pipeline.process(
            kitchen_images["left"], kitchen_images["right"], Outputs.of("mono_left")
        )
    assert len(pipeline._variants) == max(n0, 1)
    # already-used flag set from other tests doesn't grow the cache further
    pipeline.process(
        kitchen_images["left"], kitchen_images["right"], Outputs.of("mono_left")
    )
    assert len(pipeline._variants) == max(n0, 1)


def test_reconfigure_recompiles(pipeline, kitchen_images):
    """Live-tunable config: new StereoBM params produce a new jit variant and
    visibly different output (the dynamic_reconfigure role, SURVEY.md §2.19)."""
    res1 = pipeline.process(
        kitchen_images["left"], kitchen_images["right"], Outputs.of("disparity")
    ).fetch()
    old_cfg = pipeline.config.stereobm
    pipeline.reconfigure(num_disparities=32, texture_threshold=20)
    assert pipeline.config.stereobm.num_disparities == 32
    res2 = pipeline.process(
        kitchen_images["left"], kitchen_images["right"], Outputs.of("disparity")
    ).fetch()
    assert np.nanmax(res2["disparity"]) <= 32.0
    # restore
    pipeline.config = pipeline.config.replace(stereobm=old_cfg)


def test_senders_null_publisher(pipeline, kitchen_images):
    """Headless senders: enqueue with no publisher registered still builds the
    message and flips wasDataSent (the NULL-publisher trick,
    test/UTest.cpp:304,323)."""
    out_flags = Outputs.of("disparity", "pointcloud", "rect_mono_left")
    res = pipeline.process(kitchen_images["left"], kitchen_images["right"], out_flags)
    pipeline.enqueue_send(res, out_flags)
    pipeline.wait_all()
    for name in out_flags.flags:
        assert pipeline.senders.was_data_sent(name), name


def test_senders_publish_callback(pipeline, kitchen_images):
    """Registered publishers receive built messages with correct metadata."""
    got = {}
    pipeline.senders.register("disparity", lambda m: got.__setitem__("disp", m))
    out_flags = Outputs.of("disparity")
    res = pipeline.process(kitchen_images["left"], kitchen_images["right"], out_flags)
    pipeline.enqueue_send(res, out_flags)
    pipeline.wait_all()
    msg = got["disp"]
    assert msg.f == pytest.approx(441.238411)
    assert msg.T == pytest.approx(0.1000284, abs=1e-4)
    assert msg.image.dtype == np.float32
    # corrected valid window (SURVEY.md §2.12 bug fixed)
    x0, y0, w, h = msg.valid_window
    assert x0 == 64 + 7 - 1 and y0 == 7


def test_timed_process(pipeline, kitchen_images):
    res, ms = pipeline.timed_process(
        kitchen_images["left"], kitchen_images["right"], Outputs.of("disparity")
    )
    assert ms > 0


def test_sgm_algorithm_variant(pipeline, kitchen_images):
    """algorithm='sgm' routes the disparity stage through path aggregation."""
    old = pipeline.config.stereobm
    pipeline.reconfigure(algorithm="sgm", num_disparities=32)
    try:
        res = pipeline.process(
            kitchen_images["left"], kitchen_images["right"], Outputs.of("disparity")
        ).fetch()
        assert res["disparity_valid"].mean() > 0.05
        assert np.nanmax(res["disparity"]) <= 32.0
    finally:
        pipeline.config = pipeline.config.replace(stereobm=old)


def test_pointcloud_message_pack(pipeline, kitchen_images):
    from ros_gpu_stereo_processor_tpu.utils.msgs import PointCloud2Message, Header

    out_flags = Outputs.of("pointcloud")
    res = pipeline.process(kitchen_images["left"], kitchen_images["right"], out_flags)
    out = res.fetch()
    msg = PointCloud2Message(
        Header(), 480, 752, out["pointcloud_xyz"], out["pointcloud_rgb"]
    )
    data = msg.packed_data()
    assert data.shape == (480, 752 * 16)
    # x field of pixel (240, 376) round-trips
    px = data[240, 376 * 16 : 376 * 16 + 12].view(np.float32)
    np.testing.assert_allclose(px, out["pointcloud_xyz"][240, 376], equal_nan=True)


def test_bayer_encoding_end_to_end(stereo_model):
    """Raw Bayer input drives the full pipeline: debayer → mono/color →
    rectify → disparity (reference: encoding-driven conversion chain,
    src/GPUStereoProcessor.cpp:119-172)."""
    import cv2

    rng = np.random.default_rng(0)
    # a *smooth* gray scene mosaics to near-equal channels after demosaic
    # (per-pixel noise would alias into false color, as on a real sensor)
    base_l = cv2.GaussianBlur(
        rng.integers(0, 255, (480, 752), np.uint8), (5, 5), 1.2
    )
    base_r = np.roll(base_l, -8, axis=1)
    pipe = StereoPipeline(stereo_model, PipelineConfig(
        stereobm=StereoBMConfig(num_disparities=16, block_size=9,
                                texture_threshold=5),
        speckle=SpeckleConfig(max_speckle_size=0),
    ))
    res = pipe.process(
        base_l, base_r,
        Outputs.of("mono_left", "color_left", "rect_mono_left", "disparity"),
        encoding="bayer_rggb8",
    ).fetch()
    assert res["color_left"].shape == (480, 752, 3)
    # gray scene: all channels nearly equal after demosaic
    c = res["color_left"].astype(int)
    assert np.abs(c[..., 0] - c[..., 1]).mean() < 5.0
    assert res["disparity_valid"].mean() > 0.01


def test_max_in_flight_bounds_dispatch_depth(stereo_model, kitchen_images):
    """config.max_in_flight caps outstanding dispatched frames: the oldest
    result is joined before a new dispatch is admitted (bounded pipelining;
    the reference instead syncs every frame, src/StereoProcessor.cpp:284)."""
    cfg = PipelineConfig(
        max_in_flight=2,
        stereobm=StereoBMConfig(num_disparities=32, block_size=9),
        speckle=SpeckleConfig(max_speckle_size=0),
    )
    pipe = StereoPipeline(stereo_model, cfg)
    outs = Outputs.of("disparity")
    results = []
    for _ in range(6):
        results.append(
            pipe.process(kitchen_images["left"], kitchen_images["right"], outs)
        )
        assert len(pipe._in_flight) <= 2
    # all results remain fetchable after eviction from the in-flight window
    for r in results:
        assert np.isfinite(r.fetch()["disparity"]).all()


def test_disparity_wire_formats():
    """fixed16 is exact at 1/16 px; fixed8 (the reference's 8-bit wire,
    SURVEY.md §2.12, + 2 subpixel bits) carries the offset from
    min_disparity at 1/4 px with 255 as the invalid sentinel — any
    non-negative 64-candidate range fits the wire."""
    import jax.numpy as jnp

    from ros_gpu_stereo_processor_tpu.utils.msgs import (
        disparity_fixed8, disparity_fixed8_decode, disparity_fixed16,
    )

    d = jnp.asarray(
        np.array([[-1.0, -0.5, 0.0, 0.25, 17.5625, 63.0, 63.5]], np.float32)
    )
    w16 = np.asarray(disparity_fixed16(d))
    assert w16.dtype == np.int16
    np.testing.assert_array_equal(w16, [[-16, -8, 0, 4, 281, 1008, 1016]])
    w8 = np.asarray(disparity_fixed8(d))
    assert w8.dtype == np.uint8
    # -1 (invalid fill) -> 255 sentinel; code = (d + 0.5) * 4; the top
    # subpixel excursion (63.0, 63.5] saturates to 254 instead of silently
    # invalidating
    np.testing.assert_array_equal(w8, [[255, 0, 2, 3, 72, 254, 254]])
    # decode: 1/4-px grid (17.5625 quantizes to 17.5); top excursion clamps
    dec = disparity_fixed8_decode(w8, fill_value=-1.0)
    np.testing.assert_allclose(
        dec, [[-1.0, -0.5, 0.0, 0.25, 17.5, 63.0, 63.0]])
    # positive min_disparity: the invalid fill is min_disparity-1 (>= 0) and
    # must still map to the sentinel; valid values THROUGH the top of the
    # range survive (the advisor's min_disparity=10 case: d up to 73.0 was
    # previously lost to the sentinel)
    d2 = jnp.asarray(np.array([[9.0, 9.75, 10.0, 12.25, 73.0]], np.float32))
    w82 = np.asarray(disparity_fixed8(d2, min_disparity=10))
    np.testing.assert_array_equal(w82, [[255, 1, 2, 11, 254]])
    dec2 = disparity_fixed8_decode(w82, min_disparity=10, fill_value=-1.0)
    np.testing.assert_allclose(dec2, [[-1.0, 9.75, 10.0, 12.25, 73.0]])
    # exact roundtrip over the whole representable range
    grid = jnp.asarray(np.arange(-0.5, 63.01, 0.25, np.float32)[None])
    rt = disparity_fixed8_decode(np.asarray(disparity_fixed8(grid)))
    np.testing.assert_allclose(rt, np.asarray(grid))
    import pytest as _pytest

    with _pytest.raises(ValueError):
        disparity_fixed8(d2, min_disparity=-2)


def test_disparity_wire_config_publish_path():
    """config.disparity_wire quantizes the published disparity device-side;
    the message builder decodes back to float32 with the wire's granularity
    and delta_d reflects it (VERDICT r04 item 2: the narrow wire on the
    publish path is a config flag, not a bench-only trick)."""
    import pytest as _pytest

    from ros_gpu_stereo_processor_tpu.config import (
        Outputs, PipelineConfig, SpeckleConfig, StereoBMConfig,
    )
    from ros_gpu_stereo_processor_tpu.models.pipeline import StereoPipeline
    from ros_gpu_stereo_processor_tpu.utils.io import synthetic_stereo_pair

    from tests.test_slam import toy_model

    model = toy_model(width=128, height=96, fx=120.0)
    left, right, _ = synthetic_stereo_pair(96, 128, max_disparity=12, seed=1)
    bm = StereoBMConfig(num_disparities=16, block_size=9, texture_threshold=5,
                        refine_disparity=True)
    got = {}
    for wirename in ("float32", "fixed16", "fixed8"):
        pipe = StereoPipeline(
            model,
            PipelineConfig(disparity_wire=wirename, stereobm=bm,
                           speckle=SpeckleConfig(max_speckle_size=0)),
        )
        msgs_out = []
        pipe.senders.register("disparity", msgs_out.append)
        res = pipe.process(left, right, Outputs.of("disparity"))
        pipe.enqueue_send(res, Outputs.of("disparity"))
        pipe.wait_all()
        (m,) = msgs_out
        assert m.image.dtype == np.float32
        got[wirename] = m

    f32, f16, f8 = got["float32"], got["fixed16"], got["fixed8"]
    assert f32.delta_d == 1.0 / 16.0 and f16.delta_d == 1.0 / 16.0
    assert f8.delta_d == 0.25   # wire granularity dominates the refine step
    v = f32.image >= 0
    np.testing.assert_allclose(f16.image[v], f32.image[v], atol=1 / 32)
    np.testing.assert_allclose(f8.image[v], f32.image[v], atol=1 / 8 + 1e-6)
    # invalid pixels stay invalid on every wire
    np.testing.assert_array_equal(f8.image < 0, f32.image < 0)

    # fixed8 + negative search range is rejected at config construction
    with _pytest.raises(ValueError):
        PipelineConfig(disparity_wire="fixed8",
                       stereobm=StereoBMConfig(min_disparity=-8))
