"""Command-line interface — the engine's process entry points.

Replaces the reference's L4/L5 deployment surface (SURVEY.md §2.17/§2.21):
the node executable (src/StereoProcessorNode.cpp:4-34) and the launch-file
recipes become subcommands:

  * ``run``      — process a stereo pair or an EuRoC sequence through the
                   pipeline, dumping image/cloud artifacts
                   (≙ gpu_image_processor.launch);
  * ``compare``  — A/B the engine's pipeline against the OpenCV CPU oracle on the
                   same input and report agreement statistics
                   (≙ the side-by-side CPU-vs-GPU test_node.launch);
  * ``bench``    — the streaming throughput benchmark (≙ DisparityTiming);
  * ``info``     — calibration / model summary (the reference's FOV log at
                   model init, src/GPUStereoProcessor.cpp:47-51).

Static startup options mirror §2.20's rosparams; block-matcher flags mirror
the dynamic_reconfigure schema (§2.19) with the same validation.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _add_bm_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--ndisp", type=int, default=64, help="disparity range (mult of 16)")
    p.add_argument("--block", type=int, default=15, help="correlation window (odd)")
    p.add_argument("--min-disparity", type=int, default=0)
    p.add_argument("--texture-threshold", type=int, default=10)
    p.add_argument("--uniqueness", type=int, default=0)
    p.add_argument("--no-xsobel", action="store_true")
    p.add_argument("--refine", action="store_true", help="subpixel refinement")
    p.add_argument("--speckle-size", type=int, default=800)
    p.add_argument("--speckle-diff", type=float, default=5.0)
    p.add_argument("--algorithm", choices=["bm", "sgm"], default="bm")
    p.add_argument("--sgm-p1", type=float, default=10.0)
    p.add_argument("--sgm-p2", type=float, default=120.0)
    p.add_argument("--sgm-paths", type=int, default=4, choices=[2, 4, 8])
    p.add_argument("--wire", choices=["float32", "fixed16", "fixed8"],
                   default="float32",
                   help="disparity publish wire (fixed8: 1 B/px offset "
                        "encoding — the narrow wire for link-bound "
                        "deployments; needs min-disparity >= 0)")
    p.add_argument("--lr-check", action="store_true",
                   help="left-right consistency check")


def _bm_config(args):
    from ros_gpu_stereo_processor_tpu.config import (
        PipelineConfig, SpeckleConfig, StereoBMConfig,
    )

    return PipelineConfig(
        queue_size=getattr(args, "queue_size", 5),
        max_in_flight=getattr(args, "max_in_flight", 2),
        disparity_wire=getattr(args, "wire", "float32"),
        stereobm=StereoBMConfig(
            num_disparities=args.ndisp,
            block_size=args.block,
            min_disparity=args.min_disparity,
            texture_threshold=args.texture_threshold,
            uniqueness_ratio=args.uniqueness,
            xsobel=not args.no_xsobel,
            refine_disparity=args.refine,
            algorithm=args.algorithm,
            sgm_p1=args.sgm_p1,
            sgm_p2=args.sgm_p2,
            sgm_paths=args.sgm_paths,
            lr_check=args.lr_check,
        ),
        speckle=SpeckleConfig(
            max_speckle_size=args.speckle_size, max_diff=args.speckle_diff
        ),
    )


def _load_model(args):
    from ros_gpu_stereo_processor_tpu.utils.calib import StereoCameraModel

    return StereoCameraModel.from_files(args.calib_left, args.calib_right)


def _mesh_from_args(args):
    """Optional device mesh for the multi-chip engine path
    (StereoPipeline(mesh=…)): --devices N shards the frame over the first N
    local devices; --shard-mode picks row bands vs disparity slabs."""
    n = getattr(args, "devices", 0)
    if not n:
        return None
    from ros_gpu_stereo_processor_tpu.parallel.mesh import make_mesh

    return make_mesh(n, ("rows",))


def _load_pair(args):
    from ros_gpu_stereo_processor_tpu.utils.io import load_image

    left = load_image(args.left)
    right = load_image(args.right)
    if left.ndim == 3 and args.encoding.startswith("mono"):
        left, right = left[..., 0], right[..., 0]
    return left, right


def cmd_info(args) -> int:
    m = _load_model(args)
    print(f"left : {m.left.calib.name}  {m.left.calib.width}x{m.left.calib.height}")
    print(f"right: {m.right.calib.name}")
    print(f"fx={m.fx:.3f} px  baseline={m.baseline:.4f} m  "
          f"disparity_offset={m.disparity_offset:.3f} px")
    print(f"FOV: {np.degrees(m.left.fov_x):.1f} x {np.degrees(m.left.fov_y):.1f} deg")
    print("Q =")
    print(np.array_str(m.Q, precision=4, suppress_small=True))
    return 0


def _write_ply(path: str, xyz: np.ndarray, rgb_packed: np.ndarray | None) -> int:
    """Dump an organized cloud's finite points as ASCII PLY."""
    ok = np.isfinite(xyz).all(axis=-1)
    pts = xyz[ok]
    lines = [
        "ply", "format ascii 1.0", f"element vertex {len(pts)}",
        "property float x", "property float y", "property float z",
    ]
    cols = None
    if rgb_packed is not None:
        packed = rgb_packed[ok].view(np.uint32)
        cols = np.stack(
            [(packed >> 16) & 0xFF, (packed >> 8) & 0xFF, packed & 0xFF], -1
        ).astype(np.uint8)
        lines += ["property uchar red", "property uchar green", "property uchar blue"]
    lines += ["end_header"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
        for i, p in enumerate(pts):
            if cols is None:
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")
            else:
                c = cols[i]
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {c[0]} {c[1]} {c[2]}\n")
    return len(pts)


def cmd_run(args) -> int:
    import imageio.v3 as iio

    from ros_gpu_stereo_processor_tpu.config import Outputs
    from ros_gpu_stereo_processor_tpu.models.pipeline import StereoPipeline

    model = _load_model(args)
    pipe = StereoPipeline(model, _bm_config(args),
                          mesh=_mesh_from_args(args),
                          shard_mode=getattr(args, "shard_mode", "rows"))
    outputs = Outputs.of(*args.outputs.split(","))
    os.makedirs(args.out_dir, exist_ok=True)

    if args.euroc:
        import threading

        from ros_gpu_stereo_processor_tpu.runtime import FrameRing
        from ros_gpu_stereo_processor_tpu.utils.io import EurocReader, StereoFrame

        reader = EurocReader(args.euroc, approximate_sync=args.approximate_sync)
        # prefetch PNG decode on a producer thread through the native staging
        # ring, depth = --queue-size (the reference's input-queue rosparam,
        # src/StereoProcessor.cpp:33) — blocking push, nothing is dropped
        shape = None
        ring = None
        done = threading.Event()

        def _produce():
            nonlocal ring, shape
            for fr in reader:
                if ring is None:
                    shape = fr.left.shape
                    ring = FrameRing(max(2, args.queue_size), shape,
                                     drop_on_full=False)
                    ready.set()
                ring.push(fr.left, fr.right, fr.stamp, timeout=-1.0)
            done.set()
            ready.set()

        ready = threading.Event()
        t = threading.Thread(target=_produce, daemon=True)
        t.start()
        ready.wait()

        def _frames():
            enc = args.encoding
            while True:
                if ring is None:
                    return
                got = ring.pop(timeout=0.25)
                if got is None:
                    if done.is_set() and len(ring) == 0:
                        return
                    continue
                l, r, stamp, _ = got
                yield StereoFrame(stamp=stamp, left=l, right=r, encoding=enc)

        frames = _frames()
    else:
        from ros_gpu_stereo_processor_tpu.utils.io import StereoFrame

        left, right = _load_pair(args)
        frames = [StereoFrame(stamp=0.0, left=left, right=right, encoding=args.encoding)]

    n = 0
    t0 = time.perf_counter()
    for fr in frames:
        res = pipe.process(fr.left, fr.right, outputs, encoding=fr.encoding)
        out = res.fetch()
        if n < args.save_frames:
            for name in ("disparity_vis", "rect_mono_left", "rect_color_left"):
                if name in out:
                    iio.imwrite(
                        os.path.join(args.out_dir, f"{name}_{n:04d}.png"), out[name]
                    )
            if "disparity" in out:
                np.save(os.path.join(args.out_dir, f"disparity_{n:04d}.npy"),
                        out["disparity"])
            if "pointcloud_xyz" in out:
                npts = _write_ply(
                    os.path.join(args.out_dir, f"cloud_{n:04d}.ply"),
                    out["pointcloud_xyz"], out.get("pointcloud_rgb"),
                )
                print(f"frame {n}: wrote {npts} points")
        n += 1
        if args.max_frames and n >= args.max_frames:
            break
    dt = time.perf_counter() - t0
    print(f"processed {n} frames in {dt:.2f}s ({n/dt:.1f} fps incl. host IO)")
    return 0


def _cv_oracle_disparity(model, cfg, left, right):
    """OpenCV CPU StereoBM with mirrored settings — the reference's own
    parity oracle (src/GPUStereoProcessor.cpp:20,319).  Returns
    (cv_disp float32, cv_valid bool, rect dict)."""
    import cv2

    bm = cfg.stereobm
    rect = {}
    for side, img in (("left", left), ("right", right)):
        if img.ndim == 3:
            img = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
        mp = getattr(model, side).rect_map
        rect[side] = cv2.remap(img, mp[..., 0], mp[..., 1], cv2.INTER_LINEAR)
    sbm = cv2.StereoBM_create(bm.num_disparities, bm.block_size)
    sbm.setPreFilterType(
        cv2.STEREO_BM_PREFILTER_XSOBEL if bm.xsobel
        else cv2.STEREO_BM_PREFILTER_NORMALIZED_RESPONSE
    )
    sbm.setPreFilterCap(bm.prefilter_cap)
    sbm.setTextureThreshold(bm.texture_threshold)
    sbm.setUniquenessRatio(bm.uniqueness_ratio)
    sbm.setMinDisparity(bm.min_disparity)
    # mirror the speckle setting so both sides are filtered alike
    sp = cfg.speckle
    sbm.setSpeckleWindowSize(sp.max_speckle_size if sp.enabled else 0)
    sbm.setSpeckleRange(int(sp.max_diff * 16) if sp.enabled else 0)
    d16 = sbm.compute(rect["left"], rect["right"])
    cv_disp = d16.astype(np.float32) / 16.0
    cv_valid = d16 > (bm.min_disparity - 1) * 16
    return cv_disp, cv_valid, rect


def _compare_frame(pipe, model, cfg, left, right, encoding):
    """One engine-vs-oracle frame comparison; returns (report, ours, cv,
    rect)."""
    from ros_gpu_stereo_processor_tpu.config import Outputs

    res = pipe.process(
        left, right, Outputs.of("disparity"), encoding=encoding
    ).fetch()
    cv_disp, cv_valid, rect = _cv_oracle_disparity(model, cfg, left, right)
    both = cv_valid & res["disparity_valid"]
    diff = np.abs(res["disparity"][both] - cv_disp[both])
    report = {
        "joint_valid_fraction": float(both.mean()),
        "valid_mask_agreement": float((cv_valid == res["disparity_valid"]).mean()),
        "within_1px": float((diff <= 1.0).mean()) if both.any() else None,
        "mean_abs_diff": float(diff.mean()) if both.any() else None,
    }
    return report, res, cv_disp, rect


def cmd_compare(args) -> int:
    """A/B the engine's pipeline against the OpenCV CPU oracle — the reference's
    side-by-side CPU stereo_image_proc comparison (launch/test_node.launch).

    Single pair (--left/--right) or a whole sequence (--euroc): the sequence
    mode aggregates per-frame agreement into one JSON report and dumps
    artifacts for the WORST frame (lowest within-1px agreement)."""
    from ros_gpu_stereo_processor_tpu.models.pipeline import StereoPipeline

    model = _load_model(args)
    cfg = _bm_config(args)
    pipe = StereoPipeline(model, cfg)

    if args.euroc:
        from ros_gpu_stereo_processor_tpu.utils.io import EurocReader

        reader = EurocReader(args.euroc, approximate_sync=args.approximate_sync)
        frames = []
        worst = None
        t0 = time.perf_counter()
        for i, fr in enumerate(reader):
            if args.max_frames and i >= args.max_frames:
                break
            rep, res, cv_disp, rect = _compare_frame(
                pipe, model, cfg, fr.left, fr.right, fr.encoding
            )
            rep["stamp"] = fr.stamp
            frames.append(rep)
            w1 = rep["within_1px"] if rep["within_1px"] is not None else 0.0
            if worst is None or w1 < worst[0]:
                worst = (w1, fr.stamp, res, cv_disp, rect)
        dt = time.perf_counter() - t0
        w1s = [r["within_1px"] for r in frames if r["within_1px"] is not None]
        report = {
            "frames": len(frames),
            "seconds": round(dt, 2),
            "within_1px_mean": float(np.mean(w1s)) if w1s else None,
            "within_1px_min": float(np.min(w1s)) if w1s else None,
            "within_1px_p10": float(np.percentile(w1s, 10)) if w1s else None,
            "valid_mask_agreement_mean": float(
                np.mean([r["valid_mask_agreement"] for r in frames])
            ) if frames else None,
            "mean_abs_diff_mean": float(np.mean(
                [r["mean_abs_diff"] for r in frames
                 if r["mean_abs_diff"] is not None]
            )) if w1s else None,
            "worst_frame_stamp": worst[1] if worst else None,
        }
        print(json.dumps(report, indent=2))
        if args.dump_dir and worst is not None:
            os.makedirs(args.dump_dir, exist_ok=True)
            with open(os.path.join(args.dump_dir, "compare_report.json"), "w") as f:
                json.dump({"summary": report, "per_frame": frames}, f, indent=2)
            from ros_gpu_stereo_processor_tpu.utils.debug import dump_comparison

            dump_comparison(args.dump_dir, worst[2]["disparity"], worst[3])
            print(f"worst-frame artifacts -> {args.dump_dir}")
        ok = report["within_1px_mean"] is not None and report["within_1px_mean"] > 0.85
        print("PASS" if ok else "FAIL")
        return 0 if ok else 1

    left, right = _load_pair(args)
    report, res, cv_disp, rect = _compare_frame(
        pipe, model, cfg, left, right, args.encoding
    )
    print(json.dumps(report, indent=2))
    if args.dump_dir:
        # artifact set for offline analysis (the reference's
        # ExportDisparitiesToCSV / epipolar-overlay diagnostics)
        import imageio.v3 as iio

        from ros_gpu_stereo_processor_tpu.utils.debug import (
            dump_comparison, stereo_with_epipolar,
        )

        dump_comparison(args.dump_dir, res["disparity"], cv_disp)
        iio.imwrite(
            os.path.join(args.dump_dir, "epipolar.png"),
            stereo_with_epipolar(rect["left"], rect["right"]),
        )
        print(f"artifacts -> {args.dump_dir}")
    ok = report["within_1px"] is not None and report["within_1px"] > 0.85
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


def cmd_slam(args) -> int:
    """Run the full SLAM engine over an EuRoC sequence; write the trajectory
    (TUM format: t x y z qw qx qy qz placeholderless) and report ATE when
    ground truth is available."""
    from ros_gpu_stereo_processor_tpu.models.slam import SlamConfig, StereoSlam
    from ros_gpu_stereo_processor_tpu.utils.io import EurocReader
    from ros_gpu_stereo_processor_tpu.utils import evaluate as ev

    model = _load_model(args)
    slam = StereoSlam(
        model,
        SlamConfig(
            num_features=args.features,
            keyframe_every=args.keyframe_every,
            window_size=args.window,
        ),
        _bm_config(args),
    )
    reader = EurocReader(args.euroc, approximate_sync=args.approximate_sync)
    n = 0
    t0 = time.perf_counter()
    # pipelined stepping: frame t's host work overlaps frame t+1's device
    # compute (StereoSlam.run_stream); --async-mapping additionally moves
    # TrackStore/BA onto a mapping worker
    stream = slam.run_stream(
        ((fr.left, fr.right, fr.stamp) for fr in reader),
        async_mapping=getattr(args, "async_mapping", False),
    )
    for info in stream:
        n += 1
        if n % 50 == 0:
            print(f"frame {n}: t={info['t_wc'].round(3)} "
                  f"matches={info['n_matches']} kf={len(slam.store)}")
        if args.max_frames and n >= args.max_frames:
            break
    dt = time.perf_counter() - t0
    slam.optimize_global()
    traj = slam.trajectory()
    os.makedirs(args.out_dir, exist_ok=True)
    out = os.path.join(args.out_dir, "trajectory.txt")
    with open(out, "w") as f:
        for i in range(len(traj)):
            p = traj.t[i]
            f.write(f"{traj.stamps[i]:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
    print(f"{n} frames in {dt:.1f}s ({n/dt:.1f} fps incl. IO); "
          f"{len(slam.store)} keyframes; trajectory -> {out}")
    if args.checkpoint:
        slam.save_checkpoint(args.checkpoint)
        print(f"checkpoint -> {args.checkpoint}")

    gt_path = os.path.join(args.euroc, "mav0", "state_groundtruth_estimate0", "data.csv")
    if os.path.exists(gt_path):
        gt = ev.load_euroc_groundtruth(args.euroc)
        ate = ev.ate_rmse(traj, gt)
        print(json.dumps({"ate_rmse_m": round(ate, 4), "frames": n}))
    return 0


def cmd_serve(args) -> int:
    """Live mode: watch <dir>/left and <dir>/right for '<stamp>.png' frames,
    pair them through the native ingest runtime, process, and publish results
    to <out-dir> — the engine's long-running-node deployment (the role of the
    reference's ros::spin() loop + topic I/O, src/StereoProcessorNode.cpp).

    Live control surface (runtime/serve.py): calibration may arrive *after*
    startup as camera_info_{left,right}.yaml drops (imageAndInfoCb parity),
    and <watch-dir>/reconfigure.json retunes the matcher while serving
    (dynamic_reconfigure parity, reference parameter names honoured)."""
    from ros_gpu_stereo_processor_tpu.config import Outputs
    from ros_gpu_stereo_processor_tpu.runtime.serve import ServeDaemon

    daemon = ServeDaemon(
        watch_dir=args.watch_dir,
        out_dir=args.out_dir,
        outputs=Outputs.of(*args.outputs.split(",")),
        encoding=args.encoding,
        config=_bm_config(args),
        calib_left=args.calib_left or "",
        calib_right=args.calib_right or "",
        queue_size=args.queue_size,
        approximate_sync=args.approximate_sync,
        idle_timeout=args.idle_timeout,
    )
    daemon.run()
    return 0


def cmd_bench(args) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import bench

    bench.main()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu-stereo", description="stereo vision / SLAM engine in JAX"
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--calib-left", required=True)
    common.add_argument("--calib-right", required=True)

    p = sub.add_parser("info", parents=[common])
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("run", parents=[common])
    p.add_argument("--left")
    p.add_argument("--right")
    p.add_argument("--euroc", help="EuRoC dataset root (mav0/...)")
    p.add_argument("--encoding", default="mono8")
    p.add_argument("--outputs", default="disparity,disparity_vis,pointcloud")
    p.add_argument("--out-dir", default="./tpu_stereo_out")
    p.add_argument("--save-frames", type=int, default=1)
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--approximate-sync", action="store_true")
    p.add_argument("--queue-size", type=int, default=5)  # §2.20 parity
    p.add_argument("--max-in-flight", type=int, default=2,
                   help="dispatched frames kept outstanding before joining")
    p.add_argument("--devices", type=int, default=0,
                   help="shard each frame over the first N local devices "
                        "(0 = single chip)")
    p.add_argument("--shard-mode", choices=["rows", "disp"], default="rows")
    _add_bm_flags(p)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("compare", parents=[common])
    p.add_argument("--left")
    p.add_argument("--right")
    p.add_argument("--euroc", help="aggregate A/B over an EuRoC sequence")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--approximate-sync", action="store_true")
    p.add_argument("--encoding", default="mono8")
    p.add_argument("--dump-dir", default="",
                   help="write CSV/MAT/diff/epipolar artifacts here")
    _add_bm_flags(p)
    p.set_defaults(fn=cmd_compare)

    p = sub.add_parser("slam", parents=[common])
    p.add_argument("--euroc", required=True)
    p.add_argument("--out-dir", default="./tpu_slam_out")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--features", type=int, default=512)
    p.add_argument("--keyframe-every", type=int, default=5)
    p.add_argument("--window", type=int, default=5)
    p.add_argument("--checkpoint", default="")
    p.add_argument("--approximate-sync", action="store_true")
    p.add_argument("--async-mapping", action="store_true",
                   help="tracking/mapping split: TrackStore + windowed BA "
                        "on a worker thread (throughput mode)")
    _add_bm_flags(p)
    p.set_defaults(fn=cmd_slam)

    # serve takes calib optionally: without it, the daemon waits for live
    # camera_info_{left,right}.yaml drops (the reference's CameraInfo-synced
    # init path, src/StereoProcessor.cpp:51-77,144-155)
    p = sub.add_parser("serve")
    p.add_argument("--calib-left", default="")
    p.add_argument("--calib-right", default="")
    p.add_argument("--watch-dir", required=True,
                   help="directory containing left/ and right/ frame drops")
    p.add_argument("--out-dir", default="./tpu_serve_out")
    p.add_argument("--outputs", default="disparity,disparity_vis")
    p.add_argument("--encoding", default="mono8")
    p.add_argument("--queue-size", type=int, default=5)
    p.add_argument("--approximate-sync", action="store_true")
    p.add_argument("--idle-timeout", type=float, default=0.0,
                   help="exit after this many idle seconds (0 = run forever)")
    _add_bm_flags(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("bench")
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    if args.cmd in ("run", "compare") and not args.euroc and not (
        args.left and args.right
    ):
        ap.error(f"{args.cmd} requires --euroc or --left/--right")
    if argv is None:
        # a process entry point (not a library call with explicit argv):
        # keep compiled programs across runs
        from ros_gpu_stereo_processor_tpu.utils.device import (
            enable_compile_cache,
        )

        enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
