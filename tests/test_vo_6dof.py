"""Six-dof VO stress test on a homography-rendered planar scene.

For a fronto-parallel textured plane at depth Z, the image under camera
motion (R, t) is an exact homography warp — so full 6-dof sequences with
rotation have pixel-exact ground truth without a renderer.  The stereo pair
of a plane at constant depth is a pure horizontal shift by fx·B/Z.
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
import jax.numpy as jnp

from ros_gpu_stereo_processor_tpu.models.vo import StereoVisualOdometry
from ros_gpu_stereo_processor_tpu.utils import lie
from ros_gpu_stereo_processor_tpu.utils.calib import CameraCalib, StereoCameraModel
from ros_gpu_stereo_processor_tpu.utils.evaluate import Trajectory, ate_rmse


def toy_model(width=400, height=300, fx=350.0, baseline=0.1):
    K = np.array([[fx, 0, width / 2], [0, fx, height / 2], [0, 0, 1.0]])
    P = np.hstack([K, np.zeros((3, 1))])
    Pr = P.copy()
    Pr[0, 3] = -fx * baseline
    mk = lambda PP, nm: CameraCalib(width, height, K, np.zeros(5), np.eye(3), PP, nm)
    return StereoCameraModel.from_calibs(mk(P, "left"), mk(Pr, "right"))


def plane_homography(K, R_cw, t_cw, Z0):
    """Homography mapping reference-camera pixels of the plane z=Z0 (in the
    reference camera frame) into the camera at world→cam pose (R_cw, t_cw).
    Reference camera = identity at origin; plane normal n=[0,0,1], d=Z0."""
    n = np.array([0.0, 0.0, 1.0])
    H = R_cw + np.outer(t_cw, n) / Z0
    return K @ H @ np.linalg.inv(K)


def render_sequence(model, n_frames=6, seed=0):
    """Camera poses with translation + yaw/pitch wobble, imaged onto a
    textured plane at Z0=2.5 m."""
    rng = np.random.default_rng(seed)
    W, H = model.left.calib.width, model.left.calib.height
    K = np.array([[model.fx, 0, model.left.calib.cx],
                  [0, model.fx, model.left.calib.cy], [0, 0, 1.0]])
    Z0 = 2.5
    # high-texture base image (the plane as seen from the reference pose)
    tex = rng.integers(0, 255, (H, W), np.uint8)
    tex = cv2.GaussianBlur(tex, (3, 3), 0.6)

    disp = model.fx * model.baseline / Z0
    Hlr = plane_homography(K, np.eye(3), np.array([-model.baseline, 0, 0]), Z0)

    poses, lefts, rights = [], [], []
    for i in range(n_frames):
        xi = np.array([
            0.02 * i, 0.004 * i, 0.006 * i,        # translation (m)
            0.0, 0.004 * i, 0.002 * i,             # rotation (rad)
        ])
        R_wc, t_wc = (np.asarray(a) for a in lie.se3_exp(jnp.asarray(xi)))
        # world→camera
        R_cw, t_cw = R_wc.T, -R_wc.T @ t_wc
        Hl = plane_homography(K, R_cw, t_cw, Z0)
        left = cv2.warpPerspective(tex, Hl, (W, H), flags=cv2.INTER_LINEAR)
        right = cv2.warpPerspective(tex, Hlr @ Hl, (W, H), flags=cv2.INTER_LINEAR)
        poses.append((R_wc, t_wc))
        lefts.append(left)
        rights.append(right)
    return lefts, rights, poses, Z0


def test_vo_6dof_sequence():
    model = toy_model()
    lefts, rights, poses, Z0 = render_sequence(model)
    disp_val = model.fx * model.baseline / Z0
    disp = np.full((model.left.calib.height, model.left.calib.width),
                   disp_val, np.float32)

    odo = StereoVisualOdometry(model, num_features=512, min_matches=10)
    est = []
    for i, (l, r) in enumerate(zip(lefts, rights)):
        # depth map: planar scene ⇒ constant disparity is exact enough for
        # the small rotations here (cos error < 0.1%)
        info = odo.step(jnp.asarray(l), jnp.asarray(disp))
        est.append(info["t_wc"].copy())
        if i > 0:
            assert info["tracked"], f"frame {i} lost"
    est = np.asarray(est)
    gt = np.asarray([t for (_, t) in poses])
    stamps = np.arange(len(gt)) * 0.1
    ate = ate_rmse(Trajectory(stamps, est), Trajectory(stamps, gt))
    assert ate < 0.02, f"6-dof ATE {ate:.4f} m"
    # rotation recovered too
    R_err = odo.state.R_wc.T @ poses[-1][0]
    ang = np.arccos(np.clip((np.trace(R_err) - 1) / 2, -1, 1))
    assert ang < 0.02, f"final rotation error {ang:.4f} rad"


def test_slam_6dof_sequence():
    """Full StereoSlam (keyframes + windowed BA) on the 6-dof homography
    sequence: ATE must stay small after BA refinement."""
    from ros_gpu_stereo_processor_tpu.config import (
        PipelineConfig, SpeckleConfig, StereoBMConfig,
    )
    from ros_gpu_stereo_processor_tpu.models.slam import SlamConfig, StereoSlam

    model = toy_model()
    lefts, rights, poses, Z0 = render_sequence(model, n_frames=8)
    slam = StereoSlam(
        model,
        SlamConfig(num_features=384, keyframe_every=2, window_size=3,
                   ba_landmarks=96),
        PipelineConfig(
            stereobm=StereoBMConfig(num_disparities=16, block_size=9,
                                    texture_threshold=5),
            speckle=SpeckleConfig(max_speckle_size=0),
        ),
    )
    for i, (l, r) in enumerate(zip(lefts, rights)):
        info = slam.step(l, r, stamp=0.1 * i)
        if i > 0:
            assert info["tracked"], f"frame {i} lost"
    slam.optimize_global(iters=5)
    traj = slam.trajectory()
    gt = np.asarray([t for (_, t) in poses])
    from ros_gpu_stereo_processor_tpu.utils.evaluate import Trajectory, ate_rmse

    ate = ate_rmse(Trajectory(traj.stamps, traj.t),
                   Trajectory(np.arange(len(gt)) * 0.1, gt))
    assert ate < 0.03, f"SLAM 6-dof ATE {ate:.4f} m"
    assert len(slam.store) >= 3
