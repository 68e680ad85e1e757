"""CLI surface: run / compare (single-pair and sequence-aggregate A/B vs the
OpenCV oracle — the reference's side-by-side CPU-vs-GPU replay,
launch/test_node.launch:36-67)."""

import json
import os

import numpy as np
import pytest

from ros_gpu_stereo_processor_tpu import cli
from ros_gpu_stereo_processor_tpu.utils.io import synthetic_stereo_pair

from tests.test_serve import H, W, _write_calib


def _make_euroc(root, n_frames=3):
    """Tiny EuRoC-layout dataset from synthetic pairs."""
    import imageio.v3 as iio

    for cam in ("cam0", "cam1"):
        os.makedirs(os.path.join(root, "mav0", cam, "data"), exist_ok=True)
    rows = []
    for i in range(n_frames):
        left, right, _ = synthetic_stereo_pair(H, W, max_disparity=12, seed=i)
        ts = int((1.0 + 0.05 * i) * 1e9)
        for cam, img in (("cam0", left), ("cam1", right)):
            iio.imwrite(
                os.path.join(root, "mav0", cam, "data", f"{ts}.png"), img
            )
        rows.append(f"{ts},{ts}.png")
    for cam in ("cam0", "cam1"):
        with open(os.path.join(root, "mav0", cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n" + "\n".join(rows) + "\n")


@pytest.fixture()
def calib(tmp_path):
    cl = str(tmp_path / "l.yaml")
    cr = str(tmp_path / "r.yaml")
    _write_calib(cl, "left")
    _write_calib(cr, "right", tx=-8.0)
    return cl, cr


def test_compare_euroc_aggregate(tmp_path, calib, capsys):
    root = str(tmp_path / "euroc")
    _make_euroc(root, n_frames=3)
    dump = str(tmp_path / "dump")
    rc = cli.main([
        "compare", "--calib-left", calib[0], "--calib-right", calib[1],
        "--euroc", root, "--dump-dir", dump,
        "--ndisp", "16", "--block", "9", "--texture-threshold", "5",
        "--speckle-size", "0",
    ])
    out = capsys.readouterr().out
    assert rc == 0, out
    report = json.loads(out[: out.rindex("}") + 1])
    assert report["frames"] == 3
    assert report["within_1px_mean"] > 0.85
    # worst-frame artifacts + full per-frame report on disk
    with open(os.path.join(dump, "compare_report.json")) as f:
        full = json.load(f)
    assert len(full["per_frame"]) == 3
    assert full["summary"]["worst_frame_stamp"] is not None


def test_compare_single_pair(tmp_path, calib, capsys):
    import imageio.v3 as iio

    left, right, _ = synthetic_stereo_pair(H, W, max_disparity=12, seed=0)
    lp, rp = str(tmp_path / "l.png"), str(tmp_path / "r.png")
    iio.imwrite(lp, left)
    iio.imwrite(rp, right)
    rc = cli.main([
        "compare", "--calib-left", calib[0], "--calib-right", calib[1],
        "--left", lp, "--right", rp,
        "--ndisp", "16", "--block", "9", "--texture-threshold", "5",
        "--speckle-size", "0",
    ])
    assert rc == 0


def test_run_euroc(tmp_path, calib, capsys):
    root = str(tmp_path / "euroc")
    _make_euroc(root, n_frames=2)
    out_dir = str(tmp_path / "out")
    rc = cli.main([
        "run", "--calib-left", calib[0], "--calib-right", calib[1],
        "--euroc", root, "--out-dir", out_dir, "--save-frames", "1",
        "--outputs", "disparity,disparity_vis",
        "--ndisp", "16", "--block", "5",
    ])
    assert rc == 0
    assert os.path.exists(os.path.join(out_dir, "disparity_0000.npy"))


def test_compare_requires_input(calib):
    with pytest.raises(SystemExit):
        cli.main(["compare", "--calib-left", calib[0],
                  "--calib-right", calib[1]])


def test_run_multichip(tmp_path, calib):
    """`run --devices N` routes the pipeline through the mesh path."""
    root = str(tmp_path / "euroc")
    _make_euroc(root, n_frames=2)
    out_dir = str(tmp_path / "out")
    rc = cli.main([
        "run", "--calib-left", calib[0], "--calib-right", calib[1],
        "--euroc", root, "--out-dir", out_dir, "--save-frames", "1",
        "--outputs", "disparity", "--devices", "8",
        "--ndisp", "16", "--block", "5", "--speckle-size", "0",
    ])
    assert rc == 0
    d = np.load(os.path.join(out_dir, "disparity_0000.npy"))
    assert d.shape == (H, W)
