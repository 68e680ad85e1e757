"""Headline benchmark: dense 752×480 disparity throughput on one GPU.

Prints ONE JSON line.  Primary fields {"metric", "value", "unit"} report the
streaming *compute* throughput (frames resident on device, outputs
checksummed on device); "device" names the platform, device kind and device
count as JAX reports them, and "gpu" the card's name and power limit.
Additional recorded fields:

  * "e2e_fps"      — honest end-to-end streaming: fresh frames pushed through
                     the native ingest ring → device_put → pipeline →
                     SenderPool publish (device→host fetch) each iteration;
  * "e2e_fps_per_frame_dispatch" — same boundaries, one jit call per frame
                     (the reference's deployment shape, one imageCb per pair,
                     src/StereoProcessor.cpp:157);
  * "stage_ms"     — per-stage latency breakdown (upload, rectify, disparity,
                     disparity_vis, pointcloud, full step), the reference's
                     7-stage TIMING line (src/StereoProcessor.cpp:288-297);
  * "sgm_ms_64d" / "sgm_ms_128d" — SGM per-frame ms at both disparity
                     ranges (cfg/GPU.cfg caps disparity_range at 128).

Measurement rules:

  * every metric is the MEDIAN of ``BENCH_REPEATS`` (default 3) independent
    timed runs; the spread (min/max) is recorded next to it — a single-shot
    number cannot distinguish regression from noise;
  * every timing window ends in ``jax.block_until_ready`` on the results it
    queued, and every warm-up (compilation) runs before the window;
  * it runs on a GPU or not at all: any other platform exits non-zero, and
    a failing section fails the run.
"""

import json
import os
import time

import numpy as np

REPEATS = int(os.environ.get("BENCH_REPEATS", "3"))


def _med_spread(vals):
    s = sorted(vals)
    return s[len(s) // 2], {"min": round(s[0], 3), "max": round(s[-1], 3)}


def _compute_metric(model, left, right, cfg, outputs):
    """Streaming compute throughput: batch-of-frames dispatches kept in
    flight, outputs reduced to on-device checksums (host I/O off the clock)."""
    import jax
    import jax.numpy as jnp

    from ros_gpu_stereo_processor_tpu.models.pipeline import _pipeline_step

    B = int(os.environ.get("BENCH_BATCH", "8"))
    lefts = jnp.asarray(np.stack([left] * B))
    rights = jnp.asarray(np.stack([right] * B))
    maps = jnp.asarray(model.rect_maps_stacked())
    Q = jnp.asarray(model.Q.astype(np.float32))

    @jax.jit
    def run_batch(ls, rs):
        def step(carry, lr):
            out = _pipeline_step(
                lr[0], lr[1], maps, Q,
                encoding="mono8", outputs=outputs,
                bm=cfg.stereobm, speckle=cfg.speckle,
            )
            sums = sum(
                jnp.sum(jnp.nan_to_num(v.astype(jnp.float32))) for v in out.values()
            )
            return carry, sums

        _, sums = jax.lax.scan(step, 0, jnp.stack([ls, rs], axis=1))
        return jnp.sum(sums)

    # warmup / compile — compile+first-exec are off the clock
    jax.block_until_ready(run_batch(lefts, rights))
    jax.block_until_ready(run_batch(lefts, rights))

    iters = int(os.environ.get("BENCH_ITERS", "10"))
    fps_runs = []
    for _ in range(REPEATS):
        # Streaming throughput: dispatches are queued asynchronously (the
        # engine keeps batches in flight — the form here of the reference's
        # compute/publish overlap via stream host callbacks,
        # src/GpuSenderIfc.cpp:13-26) and joined once at the end;
        # per-dispatch blocking would serialize the host↔device round trip
        # into the number.
        t0 = time.perf_counter()
        results = [run_batch(lefts, rights) for _ in range(iters)]
        jax.block_until_ready(results)
        dt = time.perf_counter() - t0
        fps_runs.append(iters * B / dt)
    return _med_spread(fps_runs)


def _e2e_metric(model, left, right, cfg):
    """End-to-end streaming: host ring → device_put → pipeline → async
    publish (fetch to host) — every boundary the reference's TIMING line
    crosses (upload ①, senders ③④, SURVEY.md §3.1).

    Streams in micro-batches of B frames per dispatch (``process_batch`` —
    the engine's streaming fast path).  Fetches run on sender worker
    threads; ≤ 2 batches in flight.  Returns
    (batched_fps+spread, per_frame_fps+spread, d2h, latency, pc_bytes)."""
    import jax

    from ros_gpu_stereo_processor_tpu.config import Outputs
    from ros_gpu_stereo_processor_tpu.models.pipeline import StereoPipeline
    from ros_gpu_stereo_processor_tpu.runtime import StreamingIngest
    from ros_gpu_stereo_processor_tpu.utils.msgs import (
        SenderPool, disparity_fixed8,
    )

    # full stage set computed on device (disparity + reprojection); the
    # PUBLISHED output is the disparity image — the reference's primary topic
    # (its TIMING budget for a disparity subscriber, StereoProcessor.cpp:267).
    # The point cloud stays device-resident for downstream device consumers;
    # host-publishing it too is a link-bandwidth question, not an engine one
    # (link throughput is measured and reported alongside).
    outputs = Outputs.of("disparity", "pointcloud")
    cfg = cfg.replace(max_in_flight=4)
    pipe = StereoPipeline(model, cfg)
    # both paths publish the reference-wire fixed8 (the reference's own
    # published buffer is 8-bit fixed-point, SURVEY.md §2.12; ours carries
    # the offset from min_disparity at 1/4 px): the fetch is
    # link-bytes-bound on both, so wire width IS the fps/latency.  fixed16
    # (disparity_fixed16) remains the wire for min_disparity<0 configs.
    wire8 = jax.jit(disparity_fixed8)
    shape = left.shape
    B = int(os.environ.get("BENCH_E2E_BATCH", "8"))
    n_frames = int(os.environ.get("BENCH_E2E_FRAMES", "64"))
    n_frames = (n_frames // B) * B
    pool = SenderPool(max_workers=3)

    def run(n, base_stamp):
        """Feeder thread fills the ring, the ingest uploader stages
        stacked-pair device_puts, the consumer assembles device-side
        micro-batches (jnp.stack of B staged pairs — a device op, no link
        traffic) and dispatches ONE process_batch per B frames; sender
        workers fetch + publish.  Upload, compute and publish all overlap."""
        import threading

        import jax.numpy as jnp

        ing = StreamingIngest(shape, capacity=2 * B, drop_on_full=False)

        def feeder():
            stamp = base_stamp
            for _ in range(n):
                ing.feed("left", left, stamp)
                ing.feed("right", right, stamp)
                stamp += 0.05

        ft = threading.Thread(target=feeder, daemon=True)
        ft.start()
        done = 0
        got_l, got_r = [], []
        inflight = []
        for l_d, r_d, stamp, seq in ing.frames_prefetch(
            timeout=2.0, depth=B + 2, stacked=True
        ):
            got_l.append(l_d)
            got_r.append(r_d)
            if len(got_l) == B:
                out = pipe.process_batch(
                    jnp.stack(got_l), jnp.stack(got_r), outputs
                )
                got_l, got_r = [], []
                # async per-frame "publish": a worker fetches the batch and
                # splits it into frames (message builds host-side)
                fut = pool.enqueue(
                    "disparity", wire8(out["disparity"]),
                    lambda d: [d[i] for i in range(d.shape[0])],
                )
                inflight.append(fut)
                if len(inflight) > 3:
                    inflight.pop(0).result()
                done += B
            if done >= n:
                break
        pool.wait_all()
        ft.join()

    run(2 * B, 0.0)  # warmup/compile (the pool's fetches join it)
    e2e_runs = []
    for rep in range(REPEATS):
        t0 = time.perf_counter()
        run(n_frames, 1000.0 * (rep + 1))
        e2e_runs.append(n_frames / (time.perf_counter() - t0))
    batched = _med_spread(e2e_runs)

    # per-frame dispatch mode (latency path): every frame is its own jit
    # call — the reference's deployment shape (one imageCb per pair,
    # src/StereoProcessor.cpp:157).  Upload, compute and publish overlap:
    # a feeder thread fills the ingest ring, an uploader thread stages
    # stacked-pair device_puts (frames_prefetch), the consumer dispatches,
    # and sender workers fetch + publish (with enqueue-time
    # copy_to_host_async prefetch) — so steady-state fps ≈ the slowest
    # stage, not their sum.  Per-frame latency (ring push → publish done) is
    # recorded and summarized as p50/p95.
    n_pf = min(int(os.environ.get("BENCH_PF_FRAMES", "24")), n_frames)
    fn = pipe._get_variant(outputs, "mono8")
    args_tail = (pipe._rect_maps, pipe._Q)

    def run_per_frame(n, pace_s=0.0):
        """``pace_s`` > 0 feeds at a fixed rate (latency measurement below
        saturation); 0 feeds as fast as the ring accepts (throughput
        measurement — latencies then include queueing backpressure).
        Publishes the fixed8 wire (¼ the float bytes — VERDICT r04 item 2:
        the latency-critical path gets the narrow wire; fixed16 remains for
        min_disparity<0 configs)."""
        ing = StreamingIngest(shape, capacity=6, drop_on_full=False)
        snd = SenderPool(max_workers=3)
        push_t = {}
        yield_t = {}
        done_t = {}

        def feeder():
            stamp = 0.0
            next_t = time.perf_counter()
            for i in range(n):
                if pace_s:
                    now = time.perf_counter()
                    if now < next_t:
                        time.sleep(next_t - now)
                    next_t += pace_s
                push_t[i] = time.perf_counter()
                ing.feed("left", left, stamp)
                ing.feed("right", right, stamp)
                stamp += 0.05

        ft = __import__("threading").Thread(target=feeder, daemon=True)
        t0 = time.perf_counter()
        ft.start()
        futs = []
        for l_d, r_d, stamp, seq in ing.frames_prefetch(
            timeout=2.0, depth=3, stacked=True
        ):
            yield_t[seq] = time.perf_counter()
            out = fn(l_d, r_d, *args_tail)
            fut = snd.enqueue("disparity", wire8(out["disparity"]),
                              lambda d: d)
            fut.add_done_callback(
                lambda f, s=seq: done_t.__setitem__(s, time.perf_counter())
            )
            futs.append(fut)
            if len(futs) > 4:
                futs.pop(0).result()
            if seq == n - 1:
                break
        snd.wait_all()
        ft.join()
        t_end = max(done_t.values())
        lats = sorted((done_t[s] - push_t[s]) * 1e3 for s in done_t)
        fps = len(done_t) / (t_end - t0)
        # per-frame budget decomposition: ring push → device item yielded
        # (staging upload + queue) vs dispatch → publish-done (compute +
        # wire fetch + build); medians over the run
        up = sorted((yield_t[s] - push_t[s]) * 1e3 for s in yield_t)
        pub = sorted((done_t[s] - yield_t[s]) * 1e3
                     for s in done_t if s in yield_t)
        budget = {"upload_ms_p50": round(up[len(up) // 2], 1),
                  "dispatch_to_publish_ms_p50": round(pub[len(pub) // 2], 1)}
        return fps, lats, budget

    run_per_frame(4)  # warmup (jit variants already compiled above)
    pf_runs = [run_per_frame(n_pf)[0] for _ in range(REPEATS)]
    pf = _med_spread(pf_runs)
    # latency at a paced input rate BELOW capacity (~70%), so percentiles
    # measure the pipeline (upload → compute → publish), not ring queueing
    pace = 1.0 / max(1.0, 0.7 * pf[0])
    _, lats, budget = run_per_frame(n_pf, pace_s=pace)
    lat_p50 = lats[len(lats) // 2]
    lat_p95 = lats[min(len(lats) - 1, int(len(lats) * 0.95))]
    budget["wire"] = "fixed8_u8"
    budget["wire_bytes_frame"] = int(np.prod(shape))

    # device→host link throughput (context for the e2e number).  A fresh
    # array each time — repeated np.asarray of the SAME array reads the
    # runtime's host cache and would report nonsense.
    d2h_runs = []
    for i in range(REPEATS):
        x = pipe.process(left, right, outputs).outputs["disparity"] + float(i)
        x.block_until_ready()
        t0 = time.perf_counter()
        np.asarray(x)
        d2h_runs.append(x.nbytes / (time.perf_counter() - t0) / 1e6)
    d2h, _ = _med_spread(d2h_runs)

    # point-cloud publish budget: the e2e number publishes fixed16 disparity;
    # the cloud's wire cost is reported so the engine-vs-link split is
    # auditable.  Bytes from a real frame's valid mask: organized H×W
    # xyz+rgb (the reference's PointCloud2 layout, src/GpuSenderPc2.cpp:15-42)
    # vs valid-only packed points.
    res = pipe.process(left, right, outputs)
    xyz = np.asarray(res.outputs["pointcloud_xyz"])
    n_valid = int(np.isfinite(xyz[..., 2]).sum())
    pc2_organized = xyz.shape[0] * xyz.shape[1] * 16
    pc2_packed = n_valid * 16
    pc_bytes = {"organized": pc2_organized, "packed_valid": pc2_packed}
    return batched, pf, d2h, (lat_p50, lat_p95), pc_bytes, budget


def _sgm_metric(left, right, ndisp=64):
    """Per-frame ms of the SGM matcher (4 paths) — the
    quality tier the reference's stubbed bilateral refinement aimed at
    (SURVEY.md §2.8b).  ``ndisp``: 64 and 128 are both recorded (the
    reference's reconfigure schema caps disparity_range at 128,
    cfg/GPU.cfg:18)."""
    import jax
    import jax.numpy as jnp

    from ros_gpu_stereo_processor_tpu.config import StereoBMConfig
    from ros_gpu_stereo_processor_tpu.ops import sgm as sgm_ops

    cfg = StereoBMConfig(num_disparities=ndisp, block_size=15,
                         texture_threshold=10)
    B = int(os.environ.get("BENCH_BATCH", "8"))
    lefts = jnp.asarray(np.stack([left + i for i in range(B)]).astype(np.uint8))
    rights = jnp.asarray(np.stack([right + i for i in range(B)]).astype(np.uint8))

    @jax.jit
    def run(ls, rs):
        def step(c, lr):
            d, v = sgm_ops.compute_disparity_sgm(lr[0], lr[1], cfg)
            return c, jnp.sum(d) + jnp.sum(v)
        _, s = jax.lax.scan(step, 0, jnp.stack([ls, rs], 1))
        return jnp.sum(s)

    # warmups: compile + first executions off the clock
    for i in range(3):
        jax.block_until_ready(run(lefts + 7 + i, rights + 7 + i))
    iters = int(os.environ.get("BENCH_SGM_ITERS", "6"))
    ms_runs = []
    for rep in range(REPEATS):
        # queue all iterations, join once
        t0 = time.perf_counter()
        vals = [run(lefts + i, rights + i) for i in range(iters)]
        jax.block_until_ready(vals)
        ms_runs.append((time.perf_counter() - t0) / (iters * B) * 1e3)
    return _med_spread(ms_runs)


def _slam_compute_metric(model, left, right, cfg):
    """Device-bound SLAM step time: the dense frontend (rectify + fused
    disparity + speckle) AND the fused VO step (detect/describe →
    triangulate → match → PnP) chained across frames in ONE lax.scan — the
    tracked-frame state (keypoints, 3-D points, validity) is the scan
    carry, exactly the dependency chain StereoSlam.run_stream executes.
    Host I/O and the link are off the clock: this records what an attached
    host runs per frame (the number round-4's README hand-waved as
    '17 ms/frame' without an artifact — VERDICT r04 item 1a)."""
    import jax
    import jax.numpy as jnp

    from ros_gpu_stereo_processor_tpu.config import Outputs
    from ros_gpu_stereo_processor_tpu.models.pipeline import _pipeline_step
    from ros_gpu_stereo_processor_tpu.models.vo import _vo_core, _vo_first

    B = int(os.environ.get("BENCH_BATCH", "8"))
    lefts = jnp.asarray(np.stack([left + i for i in range(B)]).astype(np.uint8))
    rights = jnp.asarray(np.stack([right + i for i in range(B)]).astype(np.uint8))
    maps = jnp.asarray(model.rect_maps_stacked())
    Q = jnp.asarray(model.Q.astype(np.float32))
    outputs = Outputs.of("disparity", "rect_mono_left")
    cam = dict(
        k=512, threshold=20.0, fx=model.fx, cx=model.left.calib.cx,
        cy=model.left.calib.cy, baseline=model.baseline,
        disparity_offset=model.disparity_offset,
    )

    def dense(l, r):
        out = _pipeline_step(
            l, r, maps, Q, encoding="mono8", outputs=outputs,
            bm=cfg.stereobm, speckle=cfg.speckle,
        )
        return out["rect_mono_left"], out["disparity"]

    @jax.jit
    def run(ls, rs):
        rect0, disp0 = dense(ls[0], rs[0])
        kp, pts, pv = _vo_first(rect0, disp0, **cam)

        def step(carry, lr):
            kp, pts, pv = carry
            rect, disp = dense(lr[0], lr[1])
            kp2, pts2, pv2, n, R, t, rms = _vo_core(
                kp, pts, pv, rect, disp, **cam)
            return (kp2, pts2, pv2), (n.astype(jnp.float32)
                                      + jnp.sum(R) + jnp.sum(t) + rms)

        _, sums = jax.lax.scan(
            step, (kp, pts, pv), jnp.stack([ls[1:], rs[1:]], axis=1))
        return jnp.sum(sums)

    jax.block_until_ready(run(lefts, rights))
    jax.block_until_ready(run(lefts, rights))
    iters = int(os.environ.get("BENCH_SLAM_COMPUTE_ITERS", "6"))
    ms_runs = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        vals = [run(lefts, rights) for _ in range(iters)]
        jax.block_until_ready(vals)
        # B-1 chained VO steps + 1 bootstrap per run: count B frames
        ms_runs.append((time.perf_counter() - t0) / (iters * B) * 1e3)
    return _med_spread(ms_runs)


def _slam_metric():
    """SLAM throughput on the device (BASELINE configs 4/5):
    StereoSlam.step steady-state fps over a synthetic 752x480 planar
    sequence (dense pipeline + fused VO dispatch + TrackStore host work +
    windowed BA every 2nd keyframe), with the per-stage wall breakdown from
    the engine's own timer."""
    from ros_gpu_stereo_processor_tpu.config import (
        PipelineConfig, SpeckleConfig, StereoBMConfig,
    )
    from ros_gpu_stereo_processor_tpu.models.slam import SlamConfig, StereoSlam
    from ros_gpu_stereo_processor_tpu.utils.synth import render_planar_sequence

    n = int(os.environ.get("BENCH_SLAM_FRAMES", "24"))
    seq = render_planar_sequence(n_frames=n, width=752, height=480,
                                 fx=441.0, radius=0.25)
    model = seq.model()
    pcfg = PipelineConfig(
        stereobm=StereoBMConfig(num_disparities=64, block_size=15,
                                texture_threshold=10),
        speckle=SpeckleConfig(max_speckle_size=800, max_diff=5.0,
                              propagation_iters=16),
    )
    # keyframe_every=2 fills the BA window fast, so every BA shape compiles
    # inside the warmup frames and steady state includes amortized BA
    slam = StereoSlam(
        model,
        SlamConfig(num_features=512, keyframe_every=2),
        pipeline_config=pcfg,
    )
    frames = seq.frames()
    # warmup must cover every BA window fill (keyframe_every=2 -> the
    # window reaches its full 5 keyframes by frame 8, compiling each shape)
    warm = min(10, len(frames) // 2)
    for f in frames[:warm]:
        slam.step(*f)
    slam.timer.stages.clear()
    timed = frames[warm:]
    # pipelined stepping + async mapping (run_stream: frame t's host work
    # overlaps frame t+1's device compute; TrackStore/BA on the mapping
    # worker); three contiguous chunks as repeats
    k = max(1, len(timed) // 3)
    fps_runs = []
    for c in range(3):
        chunk = timed[c * k : (c + 1) * k]
        if not chunk:
            continue
        t0 = time.perf_counter()
        for _ in slam.run_stream(iter(chunk), async_mapping=True):
            pass
        fps_runs.append(len(chunk) / (time.perf_counter() - t0))
    fps, spread = _med_spread(fps_runs)
    stages = {
        name: round(st.total_ms / max(1, st.count), 2)
        for name, st in slam.timer.stages.items()
    }
    return fps, spread, stages


def _stage_breakdown(model, left, right, cfg):
    """Per-stage ms — the reference's TIMING debug line
    (upload/color/rectify/disparity/img/pc2/total,
    src/StereoProcessor.cpp:288-297).  Each stage is a checksum-wrapped jit
    (scalar output, not a full-frame transfer), timed as a queued run
    joined once; medians over REPEATS runs."""
    import jax
    import jax.numpy as jnp

    from ros_gpu_stereo_processor_tpu.config import Outputs
    from ros_gpu_stereo_processor_tpu.models.pipeline import StereoPipeline

    iters = int(os.environ.get("BENCH_STAGE_ITERS", "10"))
    pipe = StereoPipeline(model, cfg)
    stages = {
        "rectify": Outputs.of("rect_mono_left", "rect_mono_right"),
        "disparity": Outputs.of("disparity"),
        "disparity_vis": Outputs.of("disparity_vis"),
        "pointcloud": Outputs.of("pointcloud"),
        "total": Outputs.of("disparity", "disparity_vis", "pointcloud"),
    }
    out = {}
    spread = {}

    # upload: host→device ingest (the uploadMat role).  Queued async puts
    # joined once (the transfers themselves are pipelined, which is how the
    # streaming engine issues them).
    dev = jax.devices()[0]
    jax.block_until_ready(
        (jax.device_put(left, dev), jax.device_put(right, dev)))
    up_runs = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        puts = [
            (jax.device_put(left, dev), jax.device_put(right, dev))
            for _ in range(iters)
        ]
        jax.block_until_ready(puts)
        up_runs.append((time.perf_counter() - t0) / iters * 1e3)
    out["upload"], spread["upload"] = _med_spread(up_runs)

    l_d, r_d = jax.device_put(left, dev), jax.device_put(right, dev)
    for name, o in stages.items():
        fn = pipe._get_variant(o, "mono8")

        @jax.jit
        def summed(l, r, maps, Q, _fn=fn):
            outs = _fn(l, r, maps, Q)
            return sum(
                jnp.sum(jnp.nan_to_num(v.astype(jnp.float32)))
                for v in outs.values()
            )

        args = (l_d, r_d, pipe._rect_maps, pipe._Q)
        jax.block_until_ready(summed(*args))  # compile + first exec
        jax.block_until_ready(summed(*args))
        runs = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            rs = [summed(*args) for _ in range(iters)]
            jax.block_until_ready(rs)
            runs.append((time.perf_counter() - t0) / iters * 1e3)
        out[name], spread[name] = _med_spread(runs)
    return (
        {k: round(v, 3) for k, v in out.items()},
        spread,
    )


def main() -> None:
    from ros_gpu_stereo_processor_tpu.config import (
        Outputs, PipelineConfig, SpeckleConfig, StereoBMConfig,
    )
    from ros_gpu_stereo_processor_tpu.utils import device as device_env
    from ros_gpu_stereo_processor_tpu.utils.synth import euroc_rig_frame

    dev = device_env.require_gpu()
    device_env.enable_compile_cache()
    model, left, right, _ = euroc_rig_frame()

    cfg = PipelineConfig(
        stereobm=StereoBMConfig(
            num_disparities=64, block_size=15, texture_threshold=10
        ),
        speckle=SpeckleConfig(max_speckle_size=800, max_diff=5.0, propagation_iters=16),
    )
    outputs = Outputs.of("disparity", "pointcloud")

    fps, fps_spread = _compute_metric(model, left, right, cfg, outputs)

    record = {
        "metric": "dense_disparity_fps_752x480_64d",
        "value": round(fps, 3),
        "unit": "frames/s/device",
        "device": device_env.device_record(dev),
        "gpu": device_env.gpu_name_and_power_limit(),
        "repeats": REPEATS,
        "value_spread": fps_spread,
    }
    if os.environ.get("BENCH_E2E", "1") == "1":
        batched, pf, d2h, lat, pc_bytes, budget = _e2e_metric(
            model, left, right, cfg
        )
        record["e2e_fps"] = round(batched[0], 3)
        record["e2e_spread"] = batched[1]
        record["e2e_wire"] = {"batched": "fixed8_u8",
                              "per_frame": "fixed8_u8"}
        record["e2e_fps_per_frame_dispatch"] = round(pf[0], 3)
        record["e2e_pf_spread"] = pf[1]
        record["latency_ms_p50"] = round(lat[0], 1)
        record["latency_ms_p95"] = round(lat[1], 1)
        record["latency_budget"] = budget
        record["link_d2h_MBps"] = round(d2h, 1)
        record["pc2_bytes_frame"] = pc_bytes
    if os.environ.get("BENCH_STAGES", "1") == "1":
        stage_ms, stage_spread = _stage_breakdown(model, left, right, cfg)
        record["stage_ms"] = stage_ms
        record["stage_ms_spread"] = stage_spread
    if os.environ.get("BENCH_SGM", "1") == "1":
        m64, s64 = _sgm_metric(left, right, ndisp=64)
        record["sgm_ms_64d"] = round(m64, 2)
        record["sgm_ms_64d_spread"] = s64
        m128, s128 = _sgm_metric(left, right, ndisp=128)
        record["sgm_ms_128d"] = round(m128, 2)
        record["sgm_ms_128d_spread"] = s128
    if os.environ.get("BENCH_SLAM", "1") == "1":
        cms, cspread = _slam_compute_metric(model, left, right, cfg)
        record["slam_compute_ms_frame"] = round(cms, 2)
        record["slam_compute_ms_spread"] = cspread
        record["slam_compute_fps"] = round(1e3 / cms, 2)
        sfps, sspread, sstages = _slam_metric()
        record["slam_fps"] = round(sfps, 2)
        record["slam_fps_spread"] = sspread
        record["slam_stage_ms"] = sstages

    print(json.dumps(record))


if __name__ == "__main__":
    main()
