"""Sharded-frontend tests on the virtual 8-device CPU mesh: row-band halo
exchange must be bit-identical to single-chip; slab argmin-reduce must agree
everywhere."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from ros_gpu_stereo_processor_tpu.config import StereoBMConfig
from ros_gpu_stereo_processor_tpu.ops import stereobm as bm
from ros_gpu_stereo_processor_tpu.parallel.mesh import make_mesh
from ros_gpu_stereo_processor_tpu.parallel.frontend import (
    disparity_row_sharded,
    disparity_slab_sharded,
)
from ros_gpu_stereo_processor_tpu.utils.io import synthetic_stereo_pair


@pytest.fixture(scope="module")
def pair():
    left, right, disp = synthetic_stereo_pair(96, 256, max_disparity=40, seed=0)
    return jnp.asarray(left), jnp.asarray(right)


@pytest.fixture(scope="module")
def cfg():
    return StereoBMConfig(num_disparities=48, block_size=9, texture_threshold=10)


def test_devices_available():
    assert len(jax.devices()) >= 8, "conftest must provide the virtual CPU mesh"


@pytest.mark.parametrize("n", [2, 4, 8])
def test_row_sharded_identical(pair, cfg, n):
    left, right = pair
    ref_d, ref_v = bm.compute_disparity(left, right, cfg)
    mesh = make_mesh(n, ("rows",))
    d, v = disparity_row_sharded(left, right, cfg, mesh)
    np.testing.assert_array_equal(np.asarray(v), np.asarray(ref_v))
    np.testing.assert_allclose(np.asarray(d), np.asarray(ref_d), atol=1e-5)


def test_row_sharded_with_refine(pair):
    cfg = StereoBMConfig(num_disparities=48, block_size=9, refine_disparity=True)
    left, right = pair
    ref_d, ref_v = bm.compute_disparity(left, right, cfg)
    mesh = make_mesh(4, ("rows",))
    d, v = disparity_row_sharded(left, right, cfg, mesh)
    np.testing.assert_array_equal(np.asarray(v), np.asarray(ref_v))
    np.testing.assert_allclose(np.asarray(d), np.asarray(ref_d), atol=1e-5)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_slab_sharded_identical(pair, cfg, n):
    left, right = pair
    ref_d, ref_v = bm.compute_disparity(left, right, cfg)
    mesh = make_mesh(n, ("disp",))
    d, v = disparity_slab_sharded(left, right, cfg, mesh, axis="disp")
    np.testing.assert_array_equal(np.asarray(v), np.asarray(ref_v))
    np.testing.assert_array_equal(np.asarray(d), np.asarray(ref_d))


@pytest.mark.parametrize("n", [2, 4])
def test_slab_sharded_subpixel_uniqueness(pair, n):
    """Slab sharding with refine + uniqueness matches the single-chip result
    (neighbour cost planes exchanged across slab boundaries)."""
    cfg = StereoBMConfig(num_disparities=48, block_size=9,
                         texture_threshold=10, refine_disparity=True,
                         uniqueness_ratio=10)
    left, right = pair
    ref_d, ref_v = bm.compute_disparity(left, right, cfg)
    mesh = make_mesh(n, ("disp",))
    d, v = disparity_slab_sharded(left, right, cfg, mesh)
    np.testing.assert_array_equal(np.asarray(v), np.asarray(ref_v))
    np.testing.assert_allclose(np.asarray(d), np.asarray(ref_d), atol=1e-4)


def test_row_sharded_indivisible_raises(pair, cfg):
    mesh = make_mesh(5, ("rows",))
    with pytest.raises(ValueError):
        disparity_row_sharded(*pair, cfg, mesh)  # 96 % 5 != 0


@pytest.mark.parametrize("n", [2, 4])
def test_sgm_row_sharded_close_to_single(pair, n):
    """Sharded SGM: horizontal paths exact; vertical warmup-halo approximation
    must agree with single-chip SGM on ≥99% of valid pixels."""
    from ros_gpu_stereo_processor_tpu.ops.sgm import compute_disparity_sgm
    from ros_gpu_stereo_processor_tpu.parallel.frontend import (
        disparity_sgm_row_sharded,
    )

    cfg = StereoBMConfig(num_disparities=48, block_size=9, texture_threshold=10)
    left, right = pair
    ref_d, ref_v = compute_disparity_sgm(left, right, cfg, p1=8.0, p2=90.0)
    mesh = make_mesh(n, ("rows",))
    d, v = disparity_sgm_row_sharded(
        left, right, cfg, mesh, p1=8.0, p2=90.0, warmup_rows=24
    )
    ref_d, ref_v = np.asarray(ref_d), np.asarray(ref_v)
    d, v = np.asarray(d), np.asarray(v)
    assert (v == ref_v).mean() > 0.99
    both = v & ref_v
    assert (d[both] == ref_d[both]).mean() > 0.99


def test_scaling_harness_runs():
    """Scaling harness produces well-formed results on the CPU mesh (numbers
    not hardware-representative there — this validates the machinery)."""
    from ros_gpu_stereo_processor_tpu.parallel.scaling import measure_scaling

    out = measure_scaling(
        height=64, width=256,
        cfg=StereoBMConfig(num_disparities=16, block_size=5),
        device_counts=[1, 2, 4], batch=2, iters=1,
    )
    ns = [r["n_devices"] for r in out["results"]]
    assert ns == [1, 2, 4]
    assert all(r["fps"] > 0 for r in out["results"])
    assert out["efficiency"][1] == 1.0


def test_slab_sharded_128_disparities(pair):
    """BASELINE config 3 geometry: 128-candidate search sharded in slabs."""
    left, right = pair
    cfg = StereoBMConfig(num_disparities=128, block_size=9, texture_threshold=10)
    ref_d, ref_v = bm.compute_disparity(left, right, cfg)
    mesh = make_mesh(8, ("disp",))
    d, v = disparity_slab_sharded(left, right, cfg, mesh)
    np.testing.assert_array_equal(np.asarray(v), np.asarray(ref_v))
    np.testing.assert_array_equal(np.asarray(d), np.asarray(ref_d))


# ---------------------------------------------------------------------------
# Sharded post-filters + the mesh-integrated pipeline (round-2: the engine's
# multi-chip path, VERDICT item 1)
# ---------------------------------------------------------------------------

from ros_gpu_stereo_processor_tpu.ops import speckle as speckle_ops
from ros_gpu_stereo_processor_tpu.ops import bilateral as bilateral_ops
from ros_gpu_stereo_processor_tpu.parallel.frontend import (
    bilateral_row_sharded,
    filter_speckles_row_sharded,
)


def _speckle_scene(H=64, W=96, seed=3):
    """Disparity field with planted speckles of known sizes, some spanning
    row-band boundaries."""
    rng = np.random.default_rng(seed)
    disp = np.full((H, W), 20.0, np.float32)
    valid = np.ones((H, W), bool)
    # small speckle fully inside band 1
    disp[10:13, 10:13] = 50.0
    # speckle straddling the band boundary at row 16 (8-band mesh of 8 rows)
    disp[14:19, 40:44] = 55.0
    # large component (kept) crossing several boundaries
    disp[20:52, 60:66] = 60.0
    # isolated invalid region
    valid[30:33, 10:12] = False
    disp += rng.normal(0, 0.1, disp.shape).astype(np.float32)
    return jnp.asarray(disp), jnp.asarray(valid)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_speckle_row_sharded_matches_single(n):
    disp, valid = _speckle_scene()
    ref_d, ref_v = speckle_ops.filter_speckles(
        disp, valid, max_speckle_size=30, max_diff=2.0, iters=16,
        fill_value=-1.0,
    )
    mesh = make_mesh(n, ("rows",))
    d, v = filter_speckles_row_sharded(
        disp, valid, mesh,
        max_speckle_size=30, max_diff=2.0, iters=16,
        fill_value=-1.0,
    )
    np.testing.assert_array_equal(np.asarray(v), np.asarray(ref_v))
    np.testing.assert_allclose(np.asarray(d), np.asarray(ref_d), atol=1e-6)


def test_speckle_row_sharded_random_statistical():
    """Random disparity field: ≥99.9% agreement with the single-chip filter
    (both are bounded-iteration approximations of flood fill)."""
    rng = np.random.default_rng(11)
    disp = jnp.asarray(rng.integers(0, 32, (96, 128)).astype(np.float32))
    valid = jnp.asarray(rng.random((96, 128)) > 0.2)
    ref_d, ref_v = speckle_ops.filter_speckles(
        disp, valid, max_speckle_size=20, max_diff=1.0, iters=16)
    mesh = make_mesh(8, ("rows",))
    d, v = filter_speckles_row_sharded(
        disp, valid, mesh, max_speckle_size=20, max_diff=1.0,
        iters=16)
    agree = float(np.mean(np.asarray(v) == np.asarray(ref_v)))
    assert agree >= 0.999, agree


@pytest.mark.parametrize("n", [2, 4, 8])
def test_bilateral_row_sharded_identical(n):
    rng = np.random.default_rng(5)
    H, W = 64, 96
    disp = jnp.asarray(rng.integers(0, 48, (H, W)).astype(np.float32))
    guide = jnp.asarray(rng.integers(0, 255, (H, W), np.uint8))
    ref = bilateral_ops.disparity_bilateral_filter(
        disp, guide, ndisp=48, radius=3, iters=2)
    mesh = make_mesh(n, ("rows",))
    out = bilateral_row_sharded(disp, guide, mesh, ndisp=48, radius=3, iters=2)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5)


def test_row_sharded_lr_check(pair):
    cfg = StereoBMConfig(num_disparities=48, block_size=9, lr_check=True)
    left, right = pair
    ref_d, ref_v = bm.compute_disparity(left, right, cfg)
    mesh = make_mesh(4, ("rows",))
    d, v = disparity_row_sharded(left, right, cfg, mesh)
    np.testing.assert_array_equal(np.asarray(v), np.asarray(ref_v))
    np.testing.assert_allclose(np.asarray(d), np.asarray(ref_d), atol=1e-5)


def _mesh_pipeline_pair():
    from ros_gpu_stereo_processor_tpu.utils.calib import (
        CameraCalib, StereoCameraModel,
    )

    H, W = 64, 96
    K = np.array([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1.0]])
    P = np.hstack([K, np.zeros((3, 1))])
    Pr = P.copy()
    Pr[0, 3] = -8.0
    mk = lambda PP, nm: CameraCalib(
        W, H, K, np.zeros(5), np.eye(3), PP, nm)
    model = StereoCameraModel.from_calibs(mk(P, "left"), mk(Pr, "right"))
    left, right, _ = synthetic_stereo_pair(H, W, max_disparity=14, seed=2)
    return model, left, right


@pytest.mark.parametrize("shard_mode", ["rows", "disp"])
def test_pipeline_mesh_parity(shard_mode):
    """The full demand-driven pipeline with mesh= matches single-chip
    (speckle off ⇒ bit-exact; every other stage is exact under sharding)."""
    from ros_gpu_stereo_processor_tpu.config import (
        BilateralConfig, Outputs, PipelineConfig, SpeckleConfig,
    )
    from ros_gpu_stereo_processor_tpu.models.pipeline import StereoPipeline

    model, left, right = _mesh_pipeline_pair()
    cfg = PipelineConfig(
        stereobm=StereoBMConfig(num_disparities=16, block_size=5,
                                texture_threshold=5, refine_disparity=True),
        speckle=SpeckleConfig(max_speckle_size=0),
        bilateral=BilateralConfig(enabled=True, radius=2, iters=1, ndisp=16),
    )
    outputs = Outputs.of("disparity", "disparity_vis", "pointcloud",
                         "rect_mono_left", "mono_right")
    mesh = make_mesh(8, ("rows",))
    ref = StereoPipeline(model, cfg).process(
        left, right, outputs).fetch()
    got = StereoPipeline(model, cfg, mesh=mesh, shard_mode=shard_mode).process(
        left, right, outputs).fetch()
    assert sorted(ref) == sorted(got)
    for k in ref:
        np.testing.assert_allclose(
            np.nan_to_num(got[k].astype(np.float64)),
            np.nan_to_num(ref[k].astype(np.float64)),
            atol=1e-5, err_msg=k,
        )


def test_pipeline_mesh_speckle_agreement():
    """With speckle ON the sharded pipeline agrees ≥99.9% (bounded
    cross-band label merge is the one approximate stage)."""
    from ros_gpu_stereo_processor_tpu.config import (
        Outputs, PipelineConfig, SpeckleConfig,
    )
    from ros_gpu_stereo_processor_tpu.models.pipeline import StereoPipeline

    model, left, right = _mesh_pipeline_pair()
    cfg = PipelineConfig(
        stereobm=StereoBMConfig(num_disparities=16, block_size=5,
                                texture_threshold=5),
        speckle=SpeckleConfig(max_speckle_size=30, max_diff=2.0,
                              propagation_iters=16),
    )
    outputs = Outputs.of("disparity")
    mesh = make_mesh(8, ("rows",))
    ref = StereoPipeline(model, cfg).process(
        left, right, outputs).fetch()
    got = StereoPipeline(model, cfg, mesh=mesh).process(
        left, right, outputs).fetch()
    agree = float(np.mean(got["disparity_valid"] == ref["disparity_valid"]))
    assert agree >= 0.999, agree


def test_pipeline_mesh_sgm_agreement():
    from ros_gpu_stereo_processor_tpu.config import (
        Outputs, PipelineConfig, SpeckleConfig,
    )
    from ros_gpu_stereo_processor_tpu.models.pipeline import StereoPipeline

    model, left, right = _mesh_pipeline_pair()
    cfg = PipelineConfig(
        stereobm=StereoBMConfig(num_disparities=16, block_size=5,
                                texture_threshold=5, algorithm="sgm"),
        speckle=SpeckleConfig(max_speckle_size=0),
    )
    outputs = Outputs.of("disparity")
    mesh = make_mesh(4, ("rows",))
    ref = StereoPipeline(model, cfg).process(
        left, right, outputs).fetch()
    got = StereoPipeline(model, cfg, mesh=mesh).process(
        left, right, outputs).fetch()
    both = ref["disparity_valid"] & got["disparity_valid"]
    agree = float(np.mean(
        np.abs(got["disparity"][both] - ref["disparity"][both]) <= 1.0))
    assert agree >= 0.99, agree


def test_pipeline_mesh_process_batch():
    """The batched streaming fast path (lax.scan of the sharded step) also
    works under a mesh and matches per-frame processing."""
    from ros_gpu_stereo_processor_tpu.config import (
        Outputs, PipelineConfig, SpeckleConfig,
    )
    from ros_gpu_stereo_processor_tpu.models.pipeline import StereoPipeline

    model, left, right = _mesh_pipeline_pair()
    cfg = PipelineConfig(
        stereobm=StereoBMConfig(num_disparities=16, block_size=5,
                                texture_threshold=5),
        speckle=SpeckleConfig(max_speckle_size=0),
    )
    outputs = Outputs.of("disparity")
    mesh = make_mesh(4, ("rows",))
    pipe = StereoPipeline(model, cfg, mesh=mesh)
    lefts = np.stack([left, np.roll(left, 3, axis=1)])
    rights = np.stack([right, np.roll(right, 3, axis=1)])
    batched = pipe.process_batch(lefts, rights, outputs)
    for i in range(2):
        one = pipe.process(lefts[i], rights[i], outputs).fetch()
        np.testing.assert_allclose(
            np.asarray(batched["disparity"][i]), one["disparity"], atol=1e-5)


# ---------------------------------------------------------------------------
# Row-sharded matchers against the plain numpy references (numpy_oracles.py)
# ---------------------------------------------------------------------------

import numpy_oracles as oracle


@pytest.fixture(scope="module")
def host_pair():
    left, right, _ = synthetic_stereo_pair(96, 256, max_disparity=40, seed=0)
    return left, right


@pytest.mark.parametrize("n", [2, 4])
def test_row_sharded_matches_numpy_oracle(host_pair, cfg, n):
    left, right = host_pair
    want_d, want_v = oracle.block_match(left, right, cfg)
    d, v = disparity_row_sharded(jnp.asarray(left), jnp.asarray(right), cfg,
                                 make_mesh(n, ("rows",)))
    np.testing.assert_array_equal(np.asarray(v), want_v)
    np.testing.assert_allclose(np.asarray(d), want_d, atol=1e-5)


@pytest.mark.parametrize("extra", [
    dict(refine_disparity=True, uniqueness_ratio=10),
    dict(lr_check=True),
], ids=["refine_uniqueness", "lr_check"])
def test_row_sharded_options_match_numpy_oracle(host_pair, extra):
    left, right = host_pair
    c = StereoBMConfig(num_disparities=48, block_size=9, texture_threshold=10,
                       **extra)
    want_d, want_v = oracle.block_match(left, right, c)
    d, v = disparity_row_sharded(jnp.asarray(left), jnp.asarray(right), c,
                                 make_mesh(4, ("rows",)))
    np.testing.assert_array_equal(np.asarray(v), want_v)
    np.testing.assert_allclose(np.asarray(d), want_d, atol=1e-5)


@pytest.mark.parametrize("extra", [
    dict(refine_disparity=True),
    dict(lr_check=True),
], ids=["refine", "lr_check"])
def test_sgm_row_sharded_agrees_with_numpy_oracle(extra):
    """Sharded SGM: horizontal paths exact, vertical paths restarted in each
    band's warm-up halo — ≥99% agreement with the whole-image reference."""
    from ros_gpu_stereo_processor_tpu.parallel.frontend import (
        disparity_sgm_row_sharded,
    )

    left, right, _ = synthetic_stereo_pair(96, 256, max_disparity=40, seed=3)
    c = StereoBMConfig(num_disparities=48, block_size=9, texture_threshold=10,
                       **extra)
    want_d, want_v = oracle.sgm(left, right, c, p1=8.0, p2=90.0)
    d, v = disparity_sgm_row_sharded(
        jnp.asarray(left), jnp.asarray(right), c, make_mesh(4, ("rows",)),
        p1=8.0, p2=90.0, warmup_rows=24)
    d, v = np.asarray(d), np.asarray(v)
    assert (v == want_v).mean() > 0.99
    both = v & want_v
    assert (np.abs(d[both] - want_d[both]) <= 1e-5).mean() > 0.99


def test_pipeline_mesh_rectify_matches_numpy_oracle():
    """StereoPipeline(mesh=…) rectifies with the jnp gather under a row-band
    sharding constraint; both sides match the numpy bilinear reference."""
    from ros_gpu_stereo_processor_tpu.config import (
        Outputs, PipelineConfig, SpeckleConfig,
    )
    from ros_gpu_stereo_processor_tpu.models.pipeline import StereoPipeline

    model, left, right = _mesh_pipeline_pair()
    cfg = PipelineConfig(
        stereobm=StereoBMConfig(num_disparities=16, block_size=5),
        speckle=SpeckleConfig(max_speckle_size=0),
    )
    got = StereoPipeline(model, cfg, mesh=make_mesh(4, ("rows",))).process(
        left, right, Outputs.of("rect_mono_left", "rect_mono_right")).fetch()
    for side, img in (("left", left), ("right", right)):
        want = oracle.remap_bilinear(img, getattr(model, side).rect_map)
        diff = np.abs(got[f"rect_mono_{side}"].astype(int) - want.astype(int))
        assert diff.max() <= 1, side
