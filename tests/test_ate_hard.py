"""Hard-scene trajectory gates (VERDICT round-2 missing item 1 / item 5).

Unlike test_ate.py's single textured plane, these sequences come from
utils/synth.make_layered_euroc: multi-depth planes with occlusion
boundaries, vignetting, per-frame gain/bias jitter, sensor noise, and
(where used) degraded frames that break feature tracking.

Gates asserted here (CI-sized sequence):
  * ≥1 geometrically-verified loop closure is DETECTED on the loop, and
    pose-graph optimisation does not worsen (typically improves) the ATE;
  * a blurred/darkened frame pair loses tracking and the engine RECOVERS by
    relocalizing against the persistent track store;
  * final ATE < 0.1 m (the BASELINE.md bar) on the hard scene.

The full-scale 200-frame 752×480 artifact is recorded by
scripts/record_ate_hard.py → ATE_HARD.json (too slow for CI on a 2-core
host); set RUN_SLOW_ATE=1 to run it as a test.
"""

import json
import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")


def _run_slam(root, cl, cr, ndisp=32, max_speckle=100):
    from ros_gpu_stereo_processor_tpu.config import (
        PipelineConfig, SpeckleConfig, StereoBMConfig,
    )
    from ros_gpu_stereo_processor_tpu.models.slam import SlamConfig, StereoSlam
    from ros_gpu_stereo_processor_tpu.utils.calib import StereoCameraModel
    from ros_gpu_stereo_processor_tpu.utils.io import EurocReader

    model = StereoCameraModel.from_files(cl, cr)
    slam = StereoSlam(
        model,
        SlamConfig(num_features=384, keyframe_every=3, window_size=5),
        PipelineConfig(
            stereobm=StereoBMConfig(num_disparities=ndisp, block_size=11,
                                    texture_threshold=10),
            speckle=SpeckleConfig(max_speckle_size=max_speckle),
        ),
    )
    n_lost = n_reloc = 0
    for fr in EurocReader(root):
        info = slam.step(fr.left, fr.right, stamp=fr.stamp,
                         encoding=fr.encoding)
        n_lost += bool(info.get("lost"))
        n_reloc += bool(info.get("relocalized"))
    return slam, n_lost, n_reloc


@pytest.fixture(scope="module")
def layered_seq(tmp_path_factory):
    from ros_gpu_stereo_processor_tpu.utils.synth import make_layered_euroc

    root = str(tmp_path_factory.mktemp("layered_euroc"))
    cl, cr = make_layered_euroc(
        root, n_frames=80, width=376, height=240, fx=260.0,
        radius=0.3, depths=(6.0, 4.0, 2.8, 2.1), seed=2,
        degraded_frames=(40, 41),
        # r05 hardening: an independently-moving foreground object +
        # rolling-shutter-style exposure banding — the gates below must hold
        # through outlier observations and row-varying photometry.  (At this
        # reduced scale each occluder covers ~4x the relative area of the
        # full-scale artifact run, which carries 3 of them.)
        dynamic_occluders=1, occluder_speed=0.5, exposure_banding=0.08,
    )
    return root, cl, cr


def test_hard_scene_loop_closure_and_ate(layered_seq):
    from ros_gpu_stereo_processor_tpu.utils.evaluate import (
        ate_rmse, load_euroc_groundtruth,
    )

    root, cl, cr = layered_seq
    slam, n_lost, n_reloc = _run_slam(root, cl, cr)
    gt = load_euroc_groundtruth(root)

    # the degraded frames must actually break tracking, and the engine must
    # recover by relocalizing against the persistent track store
    assert n_lost >= 1, "degraded frames did not break tracking"
    assert n_reloc >= 1, "no relocalization happened"

    ate_before = float(ate_rmse(slam.trajectory(), gt))
    closures = slam.detect_loop_closures()
    assert len(closures) >= 1, "no loop closure detected on a closed loop"
    n_used = slam.optimize_global()
    assert n_used >= 1
    ate_after = float(ate_rmse(slam.trajectory(), gt))

    # pose-graph optimisation must not meaningfully degrade an already-good
    # trajectory (closure measurement noise can add ~mm on a near-perfect
    # VO run), and the final accuracy must clear the BASELINE bar on the
    # HARD scene.  The "closures REDUCE error" property is asserted on a
    # drifted trajectory below, where it is actually observable.
    assert ate_after <= max(ate_before * 1.5, 0.02), (ate_before, ate_after)
    assert ate_after < 0.1, (ate_before, ate_after)

    # --- loop closures must CORRECT drift: inject a smooth synthetic drift
    # into every pose (keyframes, trajectory, tracks ride along), then
    # re-optimise — the closure edges are pose-independent relative
    # measurements, so the graph must pull the loop back together ---
    K = len(slam.store)
    drift = np.array([0.30, -0.20, 0.12])
    for k, kf in enumerate(slam.store.frames):
        kf.t_wc = kf.t_wc + drift * (k / K)
    kf_stamps = [kf.stamp for kf in slam.store.frames]
    for fi, stamp in enumerate(slam.traj_stamps):
        ki = max(0, int(np.searchsorted(kf_stamps, stamp, side="right")) - 1)
        slam.traj_t[fi] = slam.traj_t[fi] + drift * (ki / K)
    ate_drifted = float(ate_rmse(slam.trajectory(), gt))
    assert ate_drifted > max(0.06, 1.3 * ate_after), ate_drifted
    n_used2 = slam.optimize_global()
    assert n_used2 >= 1
    ate_fixed = float(ate_rmse(slam.trajectory(), gt))
    # correction must remove the injected drift: back DOWN to the
    # trajectory's own noise floor (ate_after), not merely improved — the
    # closure edges are pose-independent relative measurements, so the
    # graph recovers the pre-drift solution up to solver noise
    assert ate_fixed < ate_drifted, (ate_drifted, ate_fixed)
    assert ate_fixed < 1.15 * ate_after + 0.005, (ate_after, ate_fixed)


@pytest.mark.skipif(not os.environ.get("RUN_SLOW_ATE"),
                    reason="full-scale 752x480 x200 run: use "
                           "scripts/record_ate_hard.py (artifact in "
                           "ATE_HARD.json); set RUN_SLOW_ATE=1 to run here")
def test_hard_scene_full_scale(tmp_path):
    from ros_gpu_stereo_processor_tpu.utils.evaluate import (
        ate_rmse, load_euroc_groundtruth,
    )
    from ros_gpu_stereo_processor_tpu.utils.synth import make_layered_euroc

    root = str(tmp_path / "layered_full")
    cl, cr = make_layered_euroc(root, n_frames=200, width=752, height=480,
                                degraded_frames=(100, 101))
    slam, n_lost, n_reloc = _run_slam(root, cl, cr, ndisp=48,
                                      max_speckle=200)
    gt = load_euroc_groundtruth(root)
    assert n_reloc >= 1
    assert len(slam.detect_loop_closures()) >= 1
    slam.optimize_global()
    assert float(ate_rmse(slam.trajectory(), gt)) < 0.1
