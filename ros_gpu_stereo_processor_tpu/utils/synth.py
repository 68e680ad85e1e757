"""Synthetic EuRoC-layout dataset generation (validation sequences).

The north-star accuracy gate is ATE < 0.1 m on an EuRoC sequence
(BASELINE.md); the real MH_01 bag cannot be fetched in a zero-egress
environment, so this renders a *pixel-exact* substitute: a textured plane
imaged under a full 6-dof loop trajectory is an exact homography warp of one
texture (no renderer, no interpolation error in the geometry), and the
matching right-camera view is the plane homography of the stereo baseline.
The output directory follows the EuRoC MAV layout exactly
(mav0/cam{0,1}/data(.csv), mav0/state_groundtruth_estimate0/data.csv), so the
whole toolchain — EurocReader, cmd_slam, load_euroc_groundtruth, ate_rmse —
runs unmodified on it.

Geometry convention matches models/vo.py: poses are world←camera (T_wc),
reference camera at the origin looking down +z at the plane z = Z0.

The planar sequence and the distorted single frame are rendered in memory
with numpy and ``scipy.ndimage`` (no OpenCV, no image files), so a run on
any machine can make its own data from a seed; :func:`make_planar_euroc`
writes the planar sequence out in the EuRoC layout.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Tuple

import numpy as np


def rot_to_quat(R: np.ndarray) -> np.ndarray:
    """(3, 3) rotation → quaternion (w, x, y, z)."""
    w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2.0
    if w > 1e-8:
        x = (R[2, 1] - R[1, 2]) / (4 * w)
        y = (R[0, 2] - R[2, 0]) / (4 * w)
        z = (R[1, 0] - R[0, 1]) / (4 * w)
    else:  # w≈0: pick the dominant axis
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(0.0, 1.0 + R[i, i] - R[j, j] - R[k, k])) * 2.0
        q = np.zeros(4)
        q[1 + i] = s / 4
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
        q[0] = (R[k, j] - R[j, k]) / s
        return q
    return np.array([w, x, y, z])


def _plane_homography(K: np.ndarray, R_cw: np.ndarray, t_cw: np.ndarray,
                      Z0: float) -> np.ndarray:
    """Homography mapping reference-camera pixels of the plane z=Z0 into the
    camera at world→cam (R_cw, t_cw); plane normal [0,0,1], distance Z0."""
    n = np.array([0.0, 0.0, 1.0])
    H = R_cw + np.outer(t_cw, n) / Z0
    return K @ H @ np.linalg.inv(K)


def _se3_exp_np(xi: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy SE(3) exponential (Rodrigues + left Jacobian) — keeps dataset
    generation off the accelerator entirely."""
    rho, omega = xi[:3], xi[3:]
    th = np.linalg.norm(omega)
    wx = np.array([[0, -omega[2], omega[1]],
                   [omega[2], 0, -omega[0]],
                   [-omega[1], omega[0], 0]])
    if th < 1e-10:
        return np.eye(3) + wx, rho
    A = np.sin(th) / th
    B = (1 - np.cos(th)) / th**2
    C = (1 - A) / th**2
    R = np.eye(3) + A * wx + B * (wx @ wx)
    V = np.eye(3) + B * wx + C * (wx @ wx)
    return R, V @ rho


def loop_trajectory(n_frames: int, radius: float = 0.3,
                    yaw_amp: float = 0.08) -> list:
    """A closed loop: lateral circle + yaw wobble, ending where it began
    (a loop-closure opportunity for the pose graph).  Returns [(R_wc, t_wc)]."""
    poses = []
    for i in range(n_frames):
        a = 2.0 * np.pi * i / n_frames
        xi = np.array([
            radius * np.sin(a),                 # x
            0.5 * radius * (1 - np.cos(a)),     # y
            0.1 * radius * np.sin(2 * a),       # z
            0.02 * np.sin(a),                   # roll
            0.02 * np.cos(a) - 0.02,            # pitch
            yaw_amp * np.sin(a),                # yaw
        ])
        poses.append(_se3_exp_np(xi))
    return poses


def _calib_yaml(path: str, name: str, W: int, H: int, fx: float,
                tx: float) -> None:
    doc = f"""image_width: {W}
image_height: {H}
camera_name: {name}
camera_matrix:
  rows: 3
  cols: 3
  data: [{fx}, 0, {W / 2}, 0, {fx}, {H / 2}, 0, 0, 1]
distortion_model: plumb_bob
distortion_coefficients:
  rows: 1
  cols: 5
  data: [0, 0, 0, 0, 0]
rectification_matrix:
  rows: 3
  cols: 3
  data: [1, 0, 0, 0, 1, 0, 0, 0, 1]
projection_matrix:
  rows: 3
  cols: 4
  data: [{fx}, 0, {W / 2}, {tx}, 0, {fx}, {H / 2}, 0, 0, 0, 1, 0]
"""
    with open(path, "w") as f:
        f.write(doc)


def _sample_bilinear(img: np.ndarray, sx: np.ndarray,
                     sy: np.ndarray) -> np.ndarray:
    """uint8 image sampled at real (x, y) source positions: bilinear, zero
    outside the image per tap (OpenCV's INTER_LINEAR + BORDER_CONSTANT)."""
    from scipy import ndimage

    out = ndimage.map_coordinates(img.astype(np.float64), [sy, sx], order=1,
                                  mode="grid-constant", cval=0.0)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _warp_perspective(img: np.ndarray, H: np.ndarray) -> np.ndarray:
    """dst(x) = img(H⁻¹ x), same size — cv2.warpPerspective semantics."""
    h, w = img.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    src = np.linalg.inv(H) @ np.stack([xx.ravel(), yy.ravel(),
                                       np.ones(h * w)])
    return _sample_bilinear(img, (src[0] / src[2]).reshape(h, w),
                            (src[1] / src[2]).reshape(h, w))


def _blurred_texture(rng, shape, sigma: float) -> np.ndarray:
    """Random uint8 texture under a 3×3 Gaussian blur (reflect-101 border)."""
    from scipy import ndimage

    tex = rng.integers(0, 255, shape, np.uint8).astype(np.float64)
    tex = ndimage.gaussian_filter(tex, sigma, mode="mirror",
                                  truncate=1.0 / sigma)
    return np.clip(np.rint(tex), 0, 255).astype(np.uint8)


def _pinhole_calib(name: str, W: int, H: int, fx: float, tx: float):
    from ros_gpu_stereo_processor_tpu.utils.calib import CameraCalib

    K = np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1.0]])
    P = np.hstack([K, np.array([[tx], [0.0], [0.0]])])
    return CameraCalib(W, H, K, np.zeros(5), np.eye(3), P, name)


@dataclasses.dataclass
class PlanarSequence:
    """An in-memory stereo sequence with exact ground truth."""

    lefts: np.ndarray           # (N, H, W) uint8
    rights: np.ndarray          # (N, H, W) uint8
    stamps: np.ndarray          # (N,) seconds
    poses: List[Tuple[np.ndarray, np.ndarray]]   # world←camera (R_wc, t_wc)
    calib_left: object          # utils.calib.CameraCalib
    calib_right: object

    def model(self):
        from ros_gpu_stereo_processor_tpu.utils.calib import StereoCameraModel

        return StereoCameraModel.from_calibs(self.calib_left, self.calib_right)

    def frames(self):
        """(left, right, stamp) triples — the input of StereoSlam.run_stream."""
        return [(l, r, float(t))
                for l, r, t in zip(self.lefts, self.rights, self.stamps)]


def render_planar_sequence(
    n_frames: int = 80,
    width: int = 400,
    height: int = 300,
    fx: float = 350.0,
    baseline: float = 0.1,
    Z0: float = 3.0,
    fps: float = 10.0,
    seed: int = 0,
    radius: float = 0.3,
) -> PlanarSequence:
    """Render a textured plane z=Z0 seen by a rectified stereo rig moving on
    :func:`loop_trajectory`.  Every view is an exact homography warp of one
    texture, so the ground-truth trajectory is exact."""
    K = np.array([[fx, 0, width / 2], [0, fx, height / 2], [0, 0, 1.0]])
    rng = np.random.default_rng(seed)
    tex = _blurred_texture(rng, (height, width), 0.6)
    Hlr = _plane_homography(
        K, np.eye(3), np.array([-baseline, 0.0, 0.0]), Z0)
    poses = loop_trajectory(n_frames, radius=radius)
    lefts = np.empty((n_frames, height, width), np.uint8)
    rights = np.empty_like(lefts)
    for i, (R_wc, t_wc) in enumerate(poses):
        Hl = _plane_homography(K, R_wc.T, -(R_wc.T @ t_wc), Z0)
        lefts[i] = _warp_perspective(tex, Hl)
        rights[i] = _warp_perspective(tex, Hlr @ Hl)
    return PlanarSequence(
        lefts=lefts, rights=rights,
        stamps=1.0 + np.arange(n_frames) / fps,
        poses=poses,
        calib_left=_pinhole_calib("left", width, height, fx, 0.0),
        calib_right=_pinhole_calib("right", width, height, fx,
                                   -fx * baseline),
    )


def _write_euroc(root: str, lefts, rights, stamps, poses) -> None:
    """EuRoC MAV layout: mav0/cam{0,1}/data/*.png + data.csv and the
    ground-truth state csv."""
    import imageio.v3 as iio

    for cam in ("cam0", "cam1"):
        os.makedirs(os.path.join(root, "mav0", cam, "data"), exist_ok=True)
    gt_dir = os.path.join(root, "mav0", "state_groundtruth_estimate0")
    os.makedirs(gt_dir, exist_ok=True)
    rows = {"cam0": [], "cam1": []}
    gt_rows = []
    for left, right, stamp, (R_wc, t_wc) in zip(lefts, rights, stamps, poses):
        ts = int(round(stamp * 1e9))
        for cam, img in (("cam0", left), ("cam1", right)):
            iio.imwrite(
                os.path.join(root, "mav0", cam, "data", f"{ts}.png"), img)
            rows[cam].append(f"{ts},{ts}.png")
        q = rot_to_quat(R_wc)
        gt_rows.append(
            f"{ts},{t_wc[0]:.9f},{t_wc[1]:.9f},{t_wc[2]:.9f},"
            f"{q[0]:.9f},{q[1]:.9f},{q[2]:.9f},{q[3]:.9f},0,0,0,0,0,0,0,0,0"
        )
    for cam in ("cam0", "cam1"):
        with open(os.path.join(root, "mav0", cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n" + "\n".join(rows[cam]) + "\n")
    with open(os.path.join(gt_dir, "data.csv"), "w") as f:
        f.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], "
                "q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z [], ...\n"
                + "\n".join(gt_rows) + "\n")


def make_planar_euroc(
    root: str,
    n_frames: int = 80,
    width: int = 400,
    height: int = 300,
    fx: float = 350.0,
    baseline: float = 0.1,
    Z0: float = 3.0,
    fps: float = 10.0,
    seed: int = 0,
    radius: float = 0.3,
) -> Tuple[str, str]:
    """Write :func:`render_planar_sequence` as an EuRoC-layout dataset with
    ground truth.  Returns (calib_left_yaml, calib_right_yaml) paths
    (written under root)."""
    seq = render_planar_sequence(n_frames, width, height, fx, baseline, Z0,
                                 fps, seed, radius)
    _write_euroc(root, seq.lefts, seq.rights, seq.stamps, seq.poses)
    cl = os.path.join(root, "calib_left.yaml")
    cr = os.path.join(root, "calib_right.yaml")
    _calib_yaml(cl, "left", width, height, fx, 0.0)
    _calib_yaml(cr, "right", width, height, fx, -fx * baseline)
    return cl, cr


def euroc_rig_frame(seed: int = 0, max_disparity: int = 48,
                    width: int = 752, height: int = 480):
    """One raw mono8 frame of a EuRoC-class rig (752×480 by default) with
    real lens distortion, and the disparity its rectified view should give.

    The calibration has plumb_bob distortion (k1=−0.37, k2=0.11) and a
    rectified projection different from the raw intrinsics, so the
    rectification maps do real work; other sizes scale the intrinsics.  The
    scene is :func:`utils.io.synthetic_stereo_pair` (exact integer
    disparity) placed in the RECTIFIED frame; each raw image samples it at
    the rectified position of every raw pixel (iterative undistortion), so
    rectifying the raw pair gives the scene back up to interpolation blur.

    Returns (StereoCameraModel, left_raw, right_raw, gt_disparity), the
    last in rectified pixels.
    """
    from ros_gpu_stereo_processor_tpu.utils.calib import (
        CameraCalib, StereoCameraModel,
    )
    from ros_gpu_stereo_processor_tpu.utils.io import synthetic_stereo_pair

    W, H = width, height
    s = W / 752.0
    K = np.array([[460.0 * s, 0, W / 2], [0, 460.0 * s, H / 2], [0, 0, 1.0]])
    D = np.array([-0.37, 0.11, 0.0, 0.0, 0.0])
    P = np.array([[441.0 * s, 0, W / 2 - 54 * s, 0.0],
                  [0, 441.0 * s, H / 2 - 10 * s, 0.0], [0, 0, 1.0, 0.0]])
    Pr = P.copy()
    Pr[0, 3] = -441.0 * s * 0.1           # 10 cm baseline
    model = StereoCameraModel.from_calibs(
        CameraCalib(W, H, K, D, np.eye(3), P, "left"),
        CameraCalib(W, H, K, D, np.eye(3), Pr, "right"))
    left_r, right_r, disp = synthetic_stereo_pair(H, W, max_disparity, seed)
    sx, sy = _rectified_coords(K, D, np.eye(3), P, W, H)
    return (model, _sample_bilinear(left_r, sx, sy),
            _sample_bilinear(right_r, sx, sy), disp)


def _rectified_coords(K, D, R, P, W: int, H: int, iters: int = 20):
    """Rectified-image position of every raw pixel: the inverse of
    utils.calib.undistort_rectify_map (undistortion by fixed-point
    iteration, as OpenCV's undistortPoints)."""
    k1, k2, p1, p2, k3 = (list(D) + [0.0] * 5)[:5]
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    yd = (v - K[1, 2]) / K[1, 1]
    xd = (u - K[0, 2] - K[0, 1] * yd) / K[0, 0]
    x, y = xd.copy(), yd.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 ** 3
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    ray = np.tensordot(np.asarray(R, np.float64),
                       np.stack([x, y, np.ones_like(x)]), axes=1)
    return (P[0, 0] * ray[0] / ray[2] + P[0, 2],
            P[1, 1] * ray[1] / ray[2] + P[1, 2])


def make_layered_euroc(
    root: str,
    n_frames: int = 200,
    width: int = 752,
    height: int = 480,
    fx: float = 441.0,
    baseline: float = 0.1,
    fps: float = 10.0,
    seed: int = 0,
    radius: float = 0.35,
    depths: Tuple[float, ...] = (7.0, 4.5, 3.0, 2.2),
    photometric: bool = True,
    degraded_frames: Tuple[int, ...] = (),
    dynamic_occluders: int = 0,
    occluder_speed: float = 1.0,
    exposure_banding: float = 0.0,
) -> Tuple[str, str]:
    """Render a MULTI-DEPTH EuRoC-layout loop sequence with ground truth.

    The honest substitute for a real sequence (VERDICT round-2 missing
    item 1): unlike :func:`make_planar_euroc`'s single plane, the scene is a
    stack of fronto-parallel textured planes at different depths composited
    far→near (painter's algorithm), which produces

      * real depth variation (disparity spans fx·B/Z over ``depths``),
      * occlusion boundaries that appear/disappear with parallax,
      * photometric nuisance: radial vignetting, per-frame gain/bias jitter
        and Gaussian sensor noise (both cameras, independent),
      * optional ``degraded_frames``: heavily blurred + darkened frames that
        break feature tracking (the relocalization test hook),
      * optional ``dynamic_occluders``: independently-moving textured
        foreground objects (stereo-consistent at their own depth, but
        violating the static-scene assumption — the VO outlier-robustness
        hook; ground truth remains the exact camera trajectory);
        ``occluder_speed`` scales their angular rates (1.0 ≈ up to
        ~30 px/frame peak at 752 width — beyond plausible ego-visual
        conditions; ~0.3 ≈ walking-pace foreground objects),
      * optional ``exposure_banding``: a per-frame rolling-shutter-style
        row-wise exposure ramp (photometric only — geometry and ground
        truth stay exact).

    Per-plane geometry is still an exact homography (no renderer error), so
    ground truth is exact.  Layout matches EuRoC MAV; returns the calib YAML
    paths.
    """
    import cv2

    K = np.array([[fx, 0, width / 2], [0, fx, height / 2], [0, 0, 1.0]])
    rng = np.random.default_rng(seed)

    # canvases are 2× the frame so the view stays covered under the loop
    # motion; canvas pixel (u, v) ↔ reference pixel (u − W/2, v − H/2)
    cw, ch = 2 * width, 2 * height
    T_canvas = np.array([[1.0, 0, -width / 2], [0, 1.0, -height / 2],
                         [0, 0, 1.0]])

    def make_canvas(fill_rect=None, base=None):
        tex = rng.integers(0, 255, (ch, cw), np.uint8)
        tex = cv2.GaussianBlur(tex, (5, 5), 1.0)
        # low-frequency structure so matching has distinctive corners
        blobs = cv2.resize(
            rng.integers(0, 255, (ch // 40, cw // 40), np.uint8), (cw, ch),
            interpolation=cv2.INTER_CUBIC)
        tex = (0.55 * tex + 0.45 * blobs).astype(np.uint8)
        mask = np.zeros((ch, cw), np.uint8)
        if fill_rect is None:
            mask[:] = 255
        else:
            x0, y0, x1, y1 = fill_rect
            mask[y0:y1, x0:x1] = 255
        return tex, mask

    planes = []
    bg_tex, bg_mask = make_canvas()
    planes.append((depths[0], bg_tex, bg_mask))
    rects = [
        (int(cw * 0.10), int(ch * 0.15), int(cw * 0.42), int(ch * 0.55)),
        (int(cw * 0.55), int(ch * 0.35), int(cw * 0.88), int(ch * 0.80)),
        (int(cw * 0.33), int(ch * 0.58), int(cw * 0.62), int(ch * 0.92)),
    ]
    for Zk, rect in zip(depths[1:], rects):
        tex, mask = make_canvas(fill_rect=rect)
        planes.append((Zk, tex, mask))

    poses = loop_trajectory(n_frames, radius=radius)

    # independently-moving occluders: small textured patches at a NEAR depth
    # following their own sinusoidal image-space paths (stereo-consistent:
    # the right view sees each patch shifted by its disparity fx·B/Z_occ)
    occluders = []
    for k in range(dynamic_occluders):
        ow = int(width * rng.uniform(0.06, 0.12))
        oh = int(height * rng.uniform(0.08, 0.16))
        otex = cv2.GaussianBlur(
            rng.integers(0, 255, (oh, ow), np.uint8), (3, 3), 0.8)
        occluders.append(dict(
            tex=otex, z=float(rng.uniform(1.2, 1.8)),
            cx=rng.uniform(0.2, 0.8) * width,
            cy=rng.uniform(0.2, 0.8) * height,
            ax=rng.uniform(0.15, 0.35) * width,
            ay=rng.uniform(0.10, 0.25) * height,
            wx=occluder_speed * rng.uniform(0.05, 0.12),
            wy=occluder_speed * rng.uniform(0.05, 0.12),
            ph=rng.uniform(0, 2 * np.pi),
        ))

    # vignetting field (shared; real lenses don't change per frame)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    r2 = ((xx - width / 2) ** 2 + (yy - height / 2) ** 2) / (
        (width / 2) ** 2 + (height / 2) ** 2)
    vignette = 1.0 - 0.28 * r2

    def render(R_cw, t_cw, right: bool, i: int) -> np.ndarray:
        img = np.zeros((height, width), np.uint8)
        # rectified right camera: same orientation, centre offset b·e_x along
        # the left camera's x-axis ⇒ world→right is (R_cw, t_cw − b·e_x);
        # its plane homography comes straight from that extrinsic (composing
        # a fixed reference-frame baseline homography would wrongly assume
        # the plane stays fronto-parallel at depth Zk in the MOVED frame)
        t_cam = t_cw - (np.array([baseline, 0.0, 0.0]) if right else 0.0)
        for Zk, tex, mask in sorted(planes, key=lambda p: -p[0]):
            Hk = _plane_homography(K, R_cw, t_cam, Zk)
            Hc = Hk @ T_canvas
            warped = cv2.warpPerspective(tex, Hc, (width, height),
                                         flags=cv2.INTER_LINEAR)
            wmask = cv2.warpPerspective(mask, Hc, (width, height),
                                        flags=cv2.INTER_NEAREST)
            img = np.where(wmask > 127, warped, img)
        for oc in occluders:
            # image-space path + per-view disparity shift at the occluder's
            # own depth (independent motion: NOT explained by ego-motion)
            px = oc["cx"] + oc["ax"] * np.sin(oc["wx"] * i + oc["ph"])
            py = oc["cy"] + oc["ay"] * np.sin(oc["wy"] * i + 2 * oc["ph"])
            if right:
                px -= fx * baseline / oc["z"]
            oh, ow = oc["tex"].shape
            x0, y0 = int(px - ow / 2), int(py - oh / 2)
            sx0, sy0 = max(0, -x0), max(0, -y0)
            dx0, dy0 = max(0, x0), max(0, y0)
            dx1 = min(width, x0 + ow)
            dy1 = min(height, y0 + oh)
            if dx1 > dx0 and dy1 > dy0:
                img[dy0:dy1, dx0:dx1] = oc["tex"][
                    sy0 : sy0 + dy1 - dy0, sx0 : sx0 + dx1 - dx0]
        if photometric:
            gain = 1.0 + 0.06 * np.sin(0.37 * i + (1.1 if right else 0.0))
            bias = 3.0 * np.sin(0.23 * i + (0.7 if right else 0.0))
            f = img.astype(np.float64) * vignette * gain + bias
            if exposure_banding > 0.0:
                # rolling-shutter-style exposure ramp across rows, drifting
                # per frame (photometric only; geometry stays exact)
                rows_n = np.arange(height, dtype=np.float64)[:, None]
                band = 1.0 + exposure_banding * np.sin(
                    2 * np.pi * rows_n / height + 0.9 * i
                    + (0.5 if right else 0.0))
                f *= band
            f += rng.normal(0.0, 2.0, f.shape)
            img = np.clip(f, 0, 255).astype(np.uint8)
        if i in degraded_frames:
            img = cv2.GaussianBlur(img, (51, 51), 12.0)
            img = (img * 0.25).astype(np.uint8)
        return img

    def views(right: bool):
        for i, (R_wc, t_wc) in enumerate(poses):
            yield render(R_wc.T, -(R_wc.T @ t_wc), right=right, i=i)

    # both generators advance together (zip), so rendering order — and the
    # shared rng's noise draws — interleave left/right per frame as before
    _write_euroc(root, views(False), views(True),
                 1.0 + np.arange(n_frames) / fps, poses)

    cl = os.path.join(root, "calib_left.yaml")
    cr = os.path.join(root, "calib_right.yaml")
    _calib_yaml(cl, "left", width, height, fx, 0.0)
    _calib_yaml(cr, "right", width, height, fx, -fx * baseline)
    return cl, cr
