"""End-to-end trajectory-accuracy gate: the full SLAM engine over a synthetic
EuRoC-layout sequence with ground truth, ATE < 0.1 m (BASELINE.md north star;
MH_01 itself is unavailable in a zero-egress environment — utils/synth.py
renders a pixel-exact substitute in the same directory layout)."""

import json
import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def synth_euroc(tmp_path_factory):
    from ros_gpu_stereo_processor_tpu.utils.synth import make_planar_euroc

    root = str(tmp_path_factory.mktemp("synth_euroc"))
    cl, cr = make_planar_euroc(root, n_frames=45, width=320, height=240,
                               fx=300.0, Z0=3.0, radius=0.25, seed=1)
    return root, cl, cr


def test_slam_ate_under_10cm(synth_euroc, tmp_path, capsys):
    """cmd_slam over the synthetic sequence reports ATE < 0.1 m."""
    from ros_gpu_stereo_processor_tpu import cli

    root, cl, cr = synth_euroc
    rc = cli.main([
        "slam", "--calib-left", cl, "--calib-right", cr,
        "--euroc", root, "--out-dir", str(tmp_path / "slam_out"),
        "--ndisp", "16", "--block", "9", "--features", "256",
        "--keyframe-every", "3", "--window", "5",
        "--texture-threshold", "5",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    line = [l for l in out.splitlines() if '"ate_rmse_m"' in l][-1]
    report = json.loads(line)
    assert report["frames"] == 45
    assert report["ate_rmse_m"] < 0.1, report
    # trajectory file written (TUM-ish format)
    traj = np.loadtxt(tmp_path / "slam_out" / "trajectory.txt")
    assert traj.shape == (45, 4)


def test_tracks_shared_across_windows(synth_euroc):
    """Persistent landmark tracks: the same track id is observed by keyframes
    from DIFFERENT BA windows (round-1 re-created landmarks per window)."""
    from ros_gpu_stereo_processor_tpu.models.slam import SlamConfig, StereoSlam
    from ros_gpu_stereo_processor_tpu.config import (
        PipelineConfig, SpeckleConfig, StereoBMConfig,
    )
    from ros_gpu_stereo_processor_tpu.utils.calib import StereoCameraModel
    from ros_gpu_stereo_processor_tpu.utils.io import EurocReader

    root, cl, cr = synth_euroc
    model = StereoCameraModel.from_files(cl, cr)
    slam = StereoSlam(
        model,
        SlamConfig(num_features=256, keyframe_every=2, window_size=3),
        PipelineConfig(
            stereobm=StereoBMConfig(num_disparities=16, block_size=9,
                                    texture_threshold=5),
            speckle=SpeckleConfig(max_speckle_size=0),
        ),
    )
    for i, fr in enumerate(EurocReader(root)):
        slam.step(fr.left, fr.right, stamp=fr.stamp, encoding=fr.encoding)
        if i >= 14:
            break
    kfs = slam.store.frames
    assert len(kfs) >= 6
    # a window is 3 keyframes: find tracks observed by keyframes ≥4 apart
    # (guaranteed different windows)
    seen = {}
    for k, kf in enumerate(kfs):
        for tid in kf.track_ids[kf.track_ids >= 0]:
            seen.setdefault(int(tid), []).append(k)
    spans = [max(v) - min(v) for v in seen.values() if len(v) >= 2]
    assert spans and max(spans) >= 4, "no track survives across windows"
    # table bookkeeping is consistent
    tr = slam.tracks
    multi = tr.n_obs[tr.alive] >= 2
    assert multi.sum() >= 20


def test_checkpoint_roundtrips_tracks(synth_euroc, tmp_path):
    from ros_gpu_stereo_processor_tpu.models.slam import SlamConfig, StereoSlam
    from ros_gpu_stereo_processor_tpu.config import (
        PipelineConfig, SpeckleConfig, StereoBMConfig,
    )
    from ros_gpu_stereo_processor_tpu.utils.calib import StereoCameraModel
    from ros_gpu_stereo_processor_tpu.utils.io import EurocReader

    root, cl, cr = synth_euroc
    model = StereoCameraModel.from_files(cl, cr)
    cfgs = dict(
        config=SlamConfig(num_features=256, keyframe_every=2, window_size=3),
        pipeline_config=PipelineConfig(
            stereobm=StereoBMConfig(num_disparities=16, block_size=9,
                                    texture_threshold=5),
            speckle=SpeckleConfig(max_speckle_size=0),
        ),
    )
    slam = StereoSlam(model, **cfgs)
    for i, fr in enumerate(EurocReader(root)):
        slam.step(fr.left, fr.right, stamp=fr.stamp, encoding=fr.encoding)
        if i >= 6:
            break
    ck = str(tmp_path / "ck")
    slam.save_checkpoint(ck)

    slam2 = StereoSlam(model, **cfgs)
    slam2.load_checkpoint(ck)
    np.testing.assert_array_equal(slam2.tracks.alive, slam.tracks.alive)
    np.testing.assert_allclose(slam2.tracks.pos_w, slam.tracks.pos_w)
    np.testing.assert_array_equal(
        slam2.store.frames[-1].track_ids, slam.store.frames[-1].track_ids
    )
