"""Smoke run of the stereo pipeline and SLAM on one GPU.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four-cards  # four GPUs: the mesh path only

Every phase drives the public API (``StereoPipeline.process`` /
``process_batch`` / the ``senders`` publish path, ``StereoSlam.run_stream``)
at the EuRoC geometry (752×480 mono8, a distorted calibration), and checks
what comes out against the plain reference: the SAME jnp program jitted on
the CPU backend of this process, which the CPU tests validate against cv2
and numpy oracles.  The synthetic scene's ground-truth disparity and the
synthetic trajectory's ground-truth poses are an independent second check.

Tolerances, and why:

  * BM and SGM costs are sums of integer-valued f32 below 2^24, so on the
    same rectified input the integer disparities and valid masks agree
    EXACTLY with the CPU; so do speckle labels (integer min-propagation and
    sorts).
  * Bilinear rectification rounds a float to uint8: the GPU may contract
    multiply-adds differently, so a pixel may differ by 1 LSB
    (``REMAP_MAX_LSB``), on at most ``REMAP_MAX_FRACTION`` of pixels.
    Through the whole pipeline such flips can move a few disparities, so
    full-frame disparity agrees on ``FRAME_MIN_AGREEMENT`` of pixels.
  * Subpixel, point-cloud and bilateral values are float: relative error
    ``FLOAT_RTOL`` (last-ulps differences of exp/div and summation order).
  * Against ground truth, ``GT_MIN_WITHIN_1PX`` of valid disparities are
    within 1 px of the true (integer) disparity; SLAM's ATE after alignment
    stays below ``ATE_MAX_M``.

On earlier lines it prints the card's name and power limit, the devices,
the compile-cache directory, each phase's result, the dense step's
``memory_analysis()`` and the device time of each jnp stage that replaced a
hand-written kernel.  Its last line is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Without a GPU it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

REMAP_MAX_LSB = 1
REMAP_MAX_FRACTION = 1e-3
FRAME_MIN_AGREEMENT = 0.99
FLOAT_RTOL = 1e-5
GT_MIN_WITHIN_1PX = 0.95
ATE_MAX_M = 0.05
# sync vs async mapping: BA corrections land a keyframe later under async
# mapping, so the two trajectories differ by BA-correction noise
SYNC_ASYNC_MAX_M = 0.05
SGM_SHARDED_MIN_AGREEMENT = 0.99
SPECKLE_SHARDED_MIN_AGREEMENT = 0.999


class SmokeFailure(AssertionError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


@dataclasses.dataclass(frozen=True)
class Size:
    """Geometry of a smoke run.  ``FULL`` is the EuRoC rig; the CPU tests
    run the same phases at ``TINY``."""

    width: int = 752
    height: int = 480
    ndisp: int = 64
    block: int = 15
    scene_max_disp: int = 48
    slam_frames: int = 24
    slam_features: int = 512
    sgm_ndisps: tuple = (64, 128)
    timing_iters: int = 10


FULL = Size()
TINY = Size(width=192, height=96, ndisp=32, block=9, scene_max_disp=16,
            slam_frames=8, slam_features=128, sgm_ndisps=(32, 48),
            timing_iters=2)


def log(msg: str) -> None:
    print(msg, flush=True)


def _on(dev):
    import jax

    return jax.default_device(dev)


def dense_config(size: Size, **bm):
    from ros_gpu_stereo_processor_tpu.config import (
        PipelineConfig, SpeckleConfig, StereoBMConfig,
    )

    return PipelineConfig(
        stereobm=StereoBMConfig(num_disparities=size.ndisp,
                                block_size=size.block, texture_threshold=10,
                                **bm),
        speckle=SpeckleConfig(max_speckle_size=800, max_diff=5.0,
                              propagation_iters=16),
    )


def _agreement(a: dict, b: dict) -> float:
    """Fraction of pixels where validity and disparity both agree."""
    same = (a["disparity_valid"] == b["disparity_valid"]) & (
        a["disparity"] == b["disparity"])
    return float(same.mean())


def _lsb_diff(a: np.ndarray, b: np.ndarray):
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return int(d.max()), float((d > 0).mean())


def _close(a, b, rtol=FLOAT_RTOL, atol=1e-6) -> bool:
    return bool(np.allclose(a, b, rtol=rtol, atol=atol, equal_nan=True))


def _bit_equal(a: np.ndarray, b: np.ndarray) -> bool:
    if a.dtype.kind == "f":
        a, b = a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}")
    return a.shape == b.shape and bool(np.array_equal(a, b))


def frame_parity(a: dict, b: dict, what: str) -> dict:
    """Two results of one frame that may differ only through 1-LSB
    rectification flips: rectified images within ``REMAP_MAX_LSB``,
    disparity/valid agreement ≥ ``FRAME_MIN_AGREEMENT``, and every float
    output within ``FLOAT_RTOL`` where the disparities agree."""
    out = {}
    for k in ("rect_mono_left", "rect_color_left"):
        if k in a:
            lsb, frac = _lsb_diff(a[k], b[k])
            check(lsb <= REMAP_MAX_LSB and frac <= REMAP_MAX_FRACTION,
                  f"{what}: {k} max {lsb} LSB on {frac:.2e} of pixels")
            out[f"{k}_max_lsb"], out[f"{k}_frac_differ"] = lsb, frac
    agree = _agreement(a, b)
    check(agree >= FRAME_MIN_AGREEMENT, f"{what}: disparity agreement {agree}")
    out["disparity_agreement"] = agree
    same = (a["disparity"] == b["disparity"]) & a["disparity_valid"]
    if "pointcloud_xyz" in a:
        check(_close(a["pointcloud_xyz"][same], b["pointcloud_xyz"][same]),
              f"{what}: point cloud")
    if "disparity_vis" in a:
        lsb, _ = _lsb_diff(a["disparity_vis"][same], b["disparity_vis"][same])
        check(lsb <= 1, f"{what}: disparity_vis {lsb} LSB")
    return out


def _gt_within_1px(out: dict, model, gt: np.ndarray) -> float:
    """Fraction of valid disparities within 1 px of ground truth, over
    rectified pixels whose source lies inside the raw image."""
    m = model.left.rect_map
    H, W = gt.shape
    inb = ((m[..., 0] >= 0) & (m[..., 0] <= W - 1)
           & (m[..., 1] >= 0) & (m[..., 1] <= H - 1))
    sel = out["disparity_valid"] & inb
    check(sel.mean() > 0.3, f"only {sel.mean():.3f} of pixels valid")
    return float((np.abs(out["disparity"] - gt)[sel] <= 1.0).mean())


def time_ms(fn, *args, iters: int = 10) -> dict:
    """Device time of ``fn(*args)``: two warm-up calls (compilation), then
    ``iters`` calls each joined with ``block_until_ready``."""
    import jax

    jax.block_until_ready(fn(*args))
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return {"median_ms": float(np.median(ts)), "min_ms": float(min(ts)),
            "max_ms": float(max(ts)), "iters": iters}


# ---------------------------------------------------------------------------
# phases: each runs on ``dev`` and compares with the same program on ``ref``
# ---------------------------------------------------------------------------


def phase_dense(dev, ref, size: Size = FULL) -> dict:
    """BM 64d / block 15 / texture 10 + speckle 800/5/16 at 752×480 through
    ``StereoPipeline``: a few frames with per-frame dispatch and the
    ``senders`` publish path, one micro-batch of 8, one frame with
    bilateral refinement; stage-level parity on identical inputs."""
    import jax

    from ros_gpu_stereo_processor_tpu.config import Outputs
    from ros_gpu_stereo_processor_tpu.ops import bilateral as bilateral_ops
    from ros_gpu_stereo_processor_tpu.ops import speckle as speckle_ops
    from ros_gpu_stereo_processor_tpu.ops import stereobm as bm_ops
    from ros_gpu_stereo_processor_tpu.models.pipeline import StereoPipeline
    from ros_gpu_stereo_processor_tpu.utils.msgs import Header
    from ros_gpu_stereo_processor_tpu.utils.synth import euroc_rig_frame

    res: dict = {}
    model, left, right, gt = euroc_rig_frame(
        max_disparity=size.scene_max_disp, width=size.width,
        height=size.height)
    cfg = dense_config(size)
    outputs = Outputs.of("disparity", "disparity_vis", "pointcloud",
                         "rect_mono_left")
    with _on(dev):
        pipe = StereoPipeline(model, cfg)
    with _on(ref):
        ref_pipe = StereoPipeline(model, cfg)

    # -- per-frame dispatch + async publish (the serve path's device work)
    import collections
    import threading

    n_frames = 4
    frames = [(np.roll(left, 3 * k, axis=1), np.roll(right, 3 * k, axis=1))
              for k in range(8)]
    published = collections.Counter()
    lock = threading.Lock()

    def on_publish(name):
        def cb(msg):
            with lock:
                published[name] += 1
        return cb

    for name in outputs.flags:
        pipe.senders.register(name, on_publish(name))
    per_frame = []
    with _on(dev):
        for k in range(n_frames):
            r = pipe.process(*frames[k], outputs,
                             header=Header(stamp=0.05 * k, seq=k))
            pipe.enqueue_send(r, outputs)
            per_frame.append(r)
        pipe.wait_all()
    per_frame = [r.fetch() for r in per_frame]
    check(all(published[n] == n_frames for n in outputs.flags),
          f"publish path: {dict(published)}")
    H, W = size.height, size.width
    out0 = per_frame[0]
    check(out0["disparity"].shape == (H, W)
          and out0["pointcloud_xyz"].shape == (H, W, 3)
          and out0["disparity_vis"].shape == (H, W, 3), "output shapes")
    check(np.isfinite(out0["disparity"]).all(), "non-finite disparity")

    # -- whole frame vs the CPU pipeline, and vs ground truth
    with _on(ref):
        ref0 = ref_pipe.process(*frames[0], outputs).fetch()
    res["vs_cpu"] = frame_parity(out0, ref0, "frame vs CPU")
    gt1 = _gt_within_1px(out0, model, gt)
    check(gt1 >= GT_MIN_WITHIN_1PX, f"BM vs ground truth: {gt1}")
    res["gt_within_1px"] = gt1

    # -- stage parity on identical inputs (the device's rectified pair)
    with _on(dev):
        rect = pipe.process(*frames[0], Outputs.of(
            "rect_mono_left", "rect_mono_right")).fetch()
    rl, rr = rect["rect_mono_left"], rect["rect_mono_right"]
    bm = cfg.stereobm
    d_dev = [np.asarray(a) for a in bm_ops.compute_disparity(
        jax.device_put(rl, dev), jax.device_put(rr, dev), bm)]
    d_ref = [np.asarray(a) for a in bm_ops.compute_disparity(
        jax.device_put(rl, ref), jax.device_put(rr, ref), bm)]
    check(np.array_equal(d_dev[1], d_ref[1])
          and np.array_equal(d_dev[0], d_ref[0]), "BM vs CPU (exact)")
    sp = cfg.speckle

    def speckle(d, v, device):
        return [np.asarray(a) for a in speckle_ops.filter_speckles(
            jax.device_put(d, device), jax.device_put(v, device),
            max_speckle_size=sp.max_speckle_size, max_diff=sp.max_diff,
            iters=sp.propagation_iters, fill_value=float(bm.min_disparity - 1))]

    s_dev, s_ref = speckle(*d_dev, dev), speckle(*d_dev, ref)
    check(np.array_equal(s_dev[0], s_ref[0])
          and np.array_equal(s_dev[1], s_ref[1]), "speckle vs CPU (exact)")
    res["stagewise_vs_pipeline"] = frame_parity(
        {"disparity": s_dev[0], "disparity_valid": s_dev[1]}, out0,
        "stage-wise BM+speckle vs the pipeline frame")

    # -- one micro-batch of 8 vs per-frame dispatch on the same device
    ls = np.stack([f[0] for f in frames])
    rs = np.stack([f[1] for f in frames])
    with _on(dev):
        batch = {k: np.asarray(v) for k, v in
                 pipe.process_batch(ls, rs, outputs).items()}
        singles = [pipe.process(*f, outputs).fetch() for f in frames]
    for k, one in enumerate(singles):
        frame_parity({n: v[k] for n, v in batch.items()}, one,
                     f"micro-batch frame {k} vs per-frame dispatch")
    res["batch_frames"] = len(frames)

    # -- bilateral refinement: op parity on identical input + a frame
    bcfg = cfg.replace(bilateral=cfg.bilateral.replace(
        enabled=True, ndisp=size.ndisp))
    bl = bcfg.bilateral
    kw = dict(ndisp=bl.ndisp, radius=bl.radius, iters=bl.iters,
              edge_threshold=bl.edge_threshold,
              max_disc_threshold=bl.max_disc_threshold,
              sigma_range=bl.sigma_range)
    b_dev, b_ref = (np.asarray(bilateral_ops.disparity_bilateral_filter(
        jax.device_put(s_dev[0], d), jax.device_put(rl, d), **kw))
        for d in (dev, ref))
    bdiff = float(np.max(np.abs(b_dev - b_ref)))
    check(_close(b_dev, b_ref, atol=1e-4), f"bilateral vs CPU: {bdiff}")
    res["bilateral_max_abs_diff"] = bdiff
    outs = []
    for d in (dev, ref):
        with _on(d):
            outs.append(StereoPipeline(model, bcfg).process(
                *frames[0], Outputs.of("disparity")).fetch())
    check(np.isfinite(outs[0]["disparity"]).all(), "bilateral: non-finite")
    near = np.abs(outs[0]["disparity"] - outs[1]["disparity"]) <= 1e-3
    check(near.mean() >= FRAME_MIN_AGREEMENT,
          f"bilateral frame vs CPU: {near.mean()} within 1e-3 px")
    res["bilateral_frame_agreement"] = float(near.mean())

    # -- the dense step's device memory
    fn = pipe._get_variant(outputs, "mono8")
    with _on(dev):
        ma = fn.lower(jax.device_put(left, dev), jax.device_put(right, dev),
                      pipe._rect_maps, pipe._Q).compile().memory_analysis()
    if ma is not None:
        res["memory_analysis"] = {
            k: int(getattr(ma, k)) for k in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "generated_code_size_in_bytes")
            if hasattr(ma, k)}
    return res


def phase_sgm(dev, ref, size: Size = FULL) -> dict:
    """SGM (4 paths) at 64 and 128 disparities through
    ``StereoPipeline(algorithm="sgm")``, one frame each; exact parity of the
    SGM op on identical inputs, ground truth on the frame."""
    import jax

    from ros_gpu_stereo_processor_tpu.config import Outputs
    from ros_gpu_stereo_processor_tpu.models.pipeline import StereoPipeline
    from ros_gpu_stereo_processor_tpu.ops import sgm as sgm_ops
    from ros_gpu_stereo_processor_tpu.utils.synth import euroc_rig_frame

    res: dict = {}
    model, left, right, gt = euroc_rig_frame(
        max_disparity=size.scene_max_disp, width=size.width,
        height=size.height)
    for nd in size.sgm_ndisps:
        cfg = dense_config(size, algorithm="sgm", sgm_paths=4)
        cfg = cfg.replace(stereobm=cfg.stereobm.replace(num_disparities=nd))
        with _on(dev):
            pipe = StereoPipeline(model, cfg)
            out = pipe.process(left, right, Outputs.of(
                "disparity", "rect_mono_left", "rect_mono_right")).fetch()
        check(np.isfinite(out["disparity"]).all(), f"sgm {nd}: non-finite")
        bm = cfg.stereobm
        rl, rr = out["rect_mono_left"], out["rect_mono_right"]
        got = [[np.asarray(a) for a in sgm_ops.compute_disparity_sgm(
            jax.device_put(rl, d), jax.device_put(rr, d), bm,
            p1=bm.sgm_p1, p2=bm.sgm_p2, num_paths=4)] for d in (dev, ref)]
        check(np.array_equal(got[0][0], got[1][0])
              and np.array_equal(got[0][1], got[1][1]),
              f"sgm {nd} vs CPU (exact)")
        gt1 = _gt_within_1px(out, model, gt)
        check(gt1 >= GT_MIN_WITHIN_1PX, f"sgm {nd} vs ground truth: {gt1}")
        res[f"sgm_{nd}d_gt_within_1px"] = gt1
    return res


def phase_color(dev, ref, size: Size = FULL) -> dict:
    """A bgr8 frame: rect_color_left and the coloured point cloud."""
    from ros_gpu_stereo_processor_tpu.config import Outputs
    from ros_gpu_stereo_processor_tpu.models.pipeline import StereoPipeline
    from ros_gpu_stereo_processor_tpu.utils.synth import euroc_rig_frame

    model, left, right, gt = euroc_rig_frame(
        max_disparity=size.scene_max_disp, width=size.width,
        height=size.height)

    def bgr(g):   # three channels, each a function of the same intensity
        g16 = g.astype(np.uint16)
        return np.stack([g, (g16 // 2 + 64).astype(np.uint8), 255 - g], -1)

    outputs = Outputs.of("disparity", "rect_color_left", "pointcloud")
    cfg = dense_config(size)
    outs = []
    for d in (dev, ref):
        with _on(d):
            outs.append(StereoPipeline(model, cfg).process(
                bgr(left), bgr(right), outputs, encoding="bgr8").fetch())
    o, r = outs
    H, W = size.height, size.width
    check(o["rect_color_left"].shape == (H, W, 3)
          and o["pointcloud_rgb"].shape == (H, W), "colour output shapes")
    res = frame_parity(o, r, "colour frame vs CPU")
    same = (np.all(o["rect_color_left"] == r["rect_color_left"], -1)
            & (o["disparity"] == r["disparity"]) & o["disparity_valid"])
    check(np.array_equal(o["pointcloud_rgb"][same].view(np.uint32),
                         r["pointcloud_rgb"][same].view(np.uint32)),
          "packed point-cloud colour vs CPU")
    gt1 = _gt_within_1px(o, model, gt)
    check(gt1 >= GT_MIN_WITHIN_1PX, f"colour frame vs ground truth: {gt1}")
    res["gt_within_1px"] = gt1
    return res


def slam_config(size: Size):
    from ros_gpu_stereo_processor_tpu.models.slam import SlamConfig

    return SlamConfig(num_features=size.slam_features, keyframe_every=2)


def _planar(size: Size):
    from ros_gpu_stereo_processor_tpu.utils.synth import render_planar_sequence

    fx = 441.0 * size.width / 752.0
    return render_planar_sequence(n_frames=size.slam_frames, width=size.width,
                                  height=size.height, fx=fx, radius=0.25)


def _ate(slam, seq) -> float:
    from ros_gpu_stereo_processor_tpu.utils.evaluate import Trajectory, ate_rmse

    gt = Trajectory(stamps=np.asarray(seq.stamps, np.float64),
                    t=np.stack([t for _, t in seq.poses]))
    return ate_rmse(slam.trajectory(), gt)


def phase_slam(dev, ref, size: Size = FULL) -> dict:
    """StereoSlam over the planar synthetic sequence (512 features,
    keyframe every 2nd frame, windowed BA) through ``run_stream`` with
    async mapping off and then on; ATE against ground truth, and one VO
    step compared with the CPU on identical dense inputs."""
    import jax

    from ros_gpu_stereo_processor_tpu.config import Outputs
    from ros_gpu_stereo_processor_tpu.models.slam import StereoSlam
    from ros_gpu_stereo_processor_tpu.models.vo import _vo_core, _vo_first

    seq = _planar(size)
    model = seq.model()
    pcfg = dense_config(size)
    res: dict = {}
    trajs = {}
    for async_mapping in (False, True):
        with _on(dev):
            slam = StereoSlam(model, slam_config(size), pcfg)
            infos = list(slam.run_stream(iter(seq.frames()),
                                         async_mapping=async_mapping))
        check(len(infos) == size.slam_frames, "run_stream frame count")
        check(len(slam.store) == slam._kf_count >= 2, "keyframes mapped")
        tracked = sum(bool(i["tracked"]) for i in infos)
        ate = _ate(slam, seq)
        tag = "async" if async_mapping else "sync"
        check(ate <= ATE_MAX_M, f"SLAM {tag} ATE {ate}")
        res[f"{tag}_ate_m"] = ate
        res[f"{tag}_keyframes"] = len(slam.store)
        res[f"{tag}_tracked_frames"] = tracked
        trajs[tag] = np.stack(slam.traj_t)
    gap = float(np.max(np.linalg.norm(trajs["sync"] - trajs["async"], axis=1)))
    check(gap <= SYNC_ASYNC_MAX_M, f"sync vs async trajectories: {gap} m")
    res["sync_async_gap_m"] = gap

    # one VO step on identical dense inputs, device vs CPU
    with _on(dev):
        dense = [slam.pipeline.process(l, r, Outputs.of(
            "disparity", "rect_mono_left")).fetch()
            for l, r, _ in seq.frames()[:2]]
    m = model
    cam = dict(k=size.slam_features, threshold=20.0, fx=m.fx,
               cx=m.left.calib.cx, cy=m.left.calib.cy, baseline=m.baseline,
               disparity_offset=m.disparity_offset)
    vo = []
    for d in (dev, ref):
        put = lambda a: jax.device_put(a, d)
        kp, pts, pv = _vo_first(put(dense[0]["rect_mono_left"]),
                                put(dense[0]["disparity"]), **cam)
        out = _vo_core(kp, pts, pv, put(dense[1]["rect_mono_left"]),
                       put(dense[1]["disparity"]), **cam)
        vo.append([np.asarray(a) for a in out[3:6]])     # n, R, t
    check(int(vo[0][0]) == int(vo[1][0]),
          f"VO matches {int(vo[0][0])} vs CPU {int(vo[1][0])}")
    dR = float(np.max(np.abs(vo[0][1] - vo[1][1])))
    dt = float(np.max(np.abs(vo[0][2] - vo[1][2])))
    check(dR <= 1e-4 and dt <= 1e-4, f"VO pose vs CPU: dR {dR} dt {dt}")
    res.update(vo_matches=int(vo[0][0]), vo_rot_diff=dR, vo_trans_diff=dt)
    return res


def stage_times(dev, size: Size = FULL) -> dict:
    """Device time of each jnp stage that replaced a hand-written kernel:
    remap (both sides), BM, speckle, SGM at each disparity range."""
    import jax

    from ros_gpu_stereo_processor_tpu.ops import remap as remap_ops
    from ros_gpu_stereo_processor_tpu.ops import sgm as sgm_ops
    from ros_gpu_stereo_processor_tpu.ops import speckle as speckle_ops
    from ros_gpu_stereo_processor_tpu.ops import stereobm as bm_ops
    from ros_gpu_stereo_processor_tpu.utils.synth import euroc_rig_frame

    model, left, right, _ = euroc_rig_frame(
        max_disparity=size.scene_max_disp, width=size.width,
        height=size.height)
    cfg = dense_config(size)
    bm, sp = cfg.stereobm, cfg.speckle
    put = lambda a: jax.device_put(a, dev)
    l, r = put(left), put(right)
    maps = put(model.rect_maps_stacked())
    rectify = jax.jit(lambda a, b, m: (remap_ops.remap_bilinear(a, m[0]),
                                       remap_ops.remap_bilinear(b, m[1])))
    rl, rr = rectify(l, r, maps)
    d, v = bm_ops.compute_disparity(rl, rr, bm)
    speckle = jax.jit(lambda d, v: speckle_ops.filter_speckles(
        d, v, max_speckle_size=sp.max_speckle_size, max_diff=sp.max_diff,
        iters=sp.propagation_iters))
    it = size.timing_iters
    out = {
        "remap": time_ms(rectify, l, r, maps, iters=it),
        "bm": time_ms(lambda a, b: bm_ops.compute_disparity(a, b, bm),
                      rl, rr, iters=it),
        "speckle": time_ms(speckle, d, v, iters=it),
    }
    for nd in size.sgm_ndisps:
        c = bm.replace(num_disparities=nd)
        out[f"sgm_{nd}d"] = time_ms(
            lambda a, b, c=c: sgm_ops.compute_disparity_sgm(
                a, b, c, p1=c.sgm_p1, p2=c.sgm_p2, num_paths=4),
            rl, rr, iters=it)
    return out


def phase_four_cards(devs, size: Size = FULL) -> dict:
    """The multi-card path on a 4-device mesh, each against the same input
    on one device: the dense pipeline row-sharded in 120-row bands
    (bit for bit), sharded SGM (≥99% agreement), disparity-slab sharding,
    and StereoSlam on a (2, 2) ("kf", "rows") mesh."""
    from ros_gpu_stereo_processor_tpu.config import Outputs
    from ros_gpu_stereo_processor_tpu.models.pipeline import StereoPipeline
    from ros_gpu_stereo_processor_tpu.models.slam import StereoSlam
    from ros_gpu_stereo_processor_tpu.parallel.mesh import make_mesh
    from ros_gpu_stereo_processor_tpu.utils.synth import euroc_rig_frame

    check(len(devs) >= 4, f"need 4 devices, have {len(devs)}")
    one = devs[0]
    res: dict = {}
    model, left, right, _ = euroc_rig_frame(
        max_disparity=size.scene_max_disp, width=size.width,
        height=size.height)
    outputs = Outputs.of("disparity", "pointcloud", "rect_mono_left")
    rows = make_mesh(4, ("rows",))

    def run(cfg, mesh=None, shard_mode="rows"):
        with _on(one):
            pipe = StereoPipeline(model, cfg, mesh=mesh, shard_mode=shard_mode)
            return pipe.process(left, right, outputs).fetch()

    # bit-identical by design: row-banded BM, remap, bilateral, reproject
    cfg = dense_config(size).replace(speckle=dense_config(size).speckle
                                     .replace(max_speckle_size=0))
    cfg = cfg.replace(bilateral=cfg.bilateral.replace(enabled=True,
                                                      ndisp=size.ndisp))
    single, sharded = run(cfg), run(cfg, rows)
    for k in single:
        if not _bit_equal(single[k], sharded[k]):
            diff = np.mean(single[k] != sharded[k])
            raise SmokeFailure(f"row-sharded {k} differs from one device on "
                               f"{diff:.2e} of elements")
    res["rows_bit_identical"] = sorted(single)
    # speckle on: the bounded cross-band label merge is the approximate stage
    cfg = dense_config(size)
    single, sharded = run(cfg), run(cfg, rows)
    agree = _agreement(single, sharded)
    check(agree >= SPECKLE_SHARDED_MIN_AGREEMENT,
          f"row-sharded with speckle: agreement {agree}")
    res["rows_speckle_agreement"] = agree
    # disparity slabs: winners combine by pmin over exact integer keys
    cfg = dense_config(size).replace(speckle=dense_config(size).speckle
                                     .replace(max_speckle_size=0))
    single, slabs = run(cfg), run(cfg, rows, shard_mode="disp")
    check(np.array_equal(single["disparity"], slabs["disparity"])
          and np.array_equal(single["disparity_valid"],
                             slabs["disparity_valid"]),
          "disparity-slab sharding not identical to one device")
    res["disp_slabs_identical"] = True
    # SGM: vertical paths restart in each band's warm-up halo
    cfg = dense_config(size, algorithm="sgm", sgm_paths=4)
    single, sharded = run(cfg), run(cfg, rows)
    both = single["disparity_valid"] & sharded["disparity_valid"]
    agree = float((np.abs(single["disparity"] - sharded["disparity"])[both]
                   <= 1.0).mean())
    check(agree >= SGM_SHARDED_MIN_AGREEMENT, f"sharded SGM agreement {agree}")
    res["sgm_sharded_agreement"] = agree

    # SLAM: frontend row-sharded over "rows", BA landmark-sharded over "kf"
    seq = _planar(size)
    smodel = seq.model()
    trajs = []
    for mesh in (None, make_mesh(4, ("kf", "rows"), shape=(2, 2))):
        with _on(one):
            slam = StereoSlam(smodel, slam_config(size), dense_config(size),
                              mesh=mesh)
            list(slam.run_stream(iter(seq.frames())))
        check(mesh is None or slam.pipeline.mesh is mesh,
              "SLAM frontend not sharded")
        trajs.append(np.stack(slam.traj_t))
        ate = _ate(slam, seq)
        check(ate <= ATE_MAX_M, f"SLAM ATE {ate}")
    gap = float(np.max(np.abs(trajs[0] - trajs[1])))
    check(gap <= 1e-3, f"SLAM on the mesh vs one device: {gap} m")
    res.update(slam_mesh_ate_m=ate, slam_mesh_max_diff_m=gap)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-device mesh path and its 1-device "
                         "comparison")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU — JAX's first device is {devs[0]} on "
              f"platform {devs[0].platform!r}", file=sys.stderr)
        return 2

    from ros_gpu_stereo_processor_tpu.utils import device as device_env

    log("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader:")
    log(device_env.gpu_name_and_power_limit())
    log(f"jax.devices(): {devs}")
    log(f"compile cache: {device_env.enable_compile_cache()}")
    dev, ref = devs[0], jax.devices("cpu")[0]
    t_all = time.perf_counter()

    def run(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        log(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s "
            f"{json.dumps(out)}")

    if args.four_cards:
        run("four_cards", phase_four_cards, devs)
    else:
        run("dense", phase_dense, dev, ref)
        run("sgm", phase_sgm, dev, ref)
        run("color", phase_color, dev, ref)
        run("slam", phase_slam, dev, ref)
        run("stage_times", stage_times, dev)
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": device_env.device_record(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
