"""The GPU bring-up surface on the CPU: calibration parsing without PyYAML,
compile-cache placement, the entry points refusing a CPU-only run, imports
without the optional packages, and chip_smoke's phases at a tiny size (the
same functions the ``chip`` test runs at full size on the card)."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from ros_gpu_stereo_processor_tpu.utils.calib import (  # noqa: E402
    load_camera_calib, parse_calib_yaml,
)


def _run(code_or_args, env_extra=None, unset=(), timeout=240):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    for k in unset:
        env.pop(k, None)
    env.update(env_extra or {})
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    args = (["-c", code_or_args] if isinstance(code_or_args, str)
            else code_or_args)
    return subprocess.run([sys.executable] + args, cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


# ---------------------------------------------------------------------------
# calibration files without PyYAML
# ---------------------------------------------------------------------------


def test_calib_parser_reads_synth_calibration(tmp_path):
    from ros_gpu_stereo_processor_tpu.utils.synth import _calib_yaml

    path = str(tmp_path / "right.yaml")
    _calib_yaml(path, "right", 752, 480, 441.0, -44.1)
    c = load_camera_calib(path)
    assert (c.width, c.height, c.name) == (752, 480, "right")
    np.testing.assert_array_equal(
        c.P, [[441.0, 0, 376, -44.1], [0, 441.0, 240, 0], [0, 0, 1, 0]])
    np.testing.assert_array_equal(c.D, np.zeros(5))
    np.testing.assert_array_equal(c.R, np.eye(3))


def test_calib_parser_multiline_lists_comments_quotes():
    doc = parse_calib_yaml('''image_width: 752   # pixels
image_height: 480
camera_name: "narrow_stereo/left"
camera_matrix:
  rows: 3
  cols: 3
  data: [458.654, 0, 367.215,
         0, 457.296, 248.375,
         0, 0, 1]
distortion_model: plumb_bob
''')
    assert doc["image_width"] == 752 and doc["camera_name"] == "narrow_stereo/left"
    assert doc["camera_matrix"]["rows"] == 3
    assert doc["camera_matrix"]["data"] == [458.654, 0, 367.215, 0, 457.296,
                                            248.375, 0, 0, 1]
    assert doc["distortion_model"] == "plumb_bob"


@pytest.mark.parametrize("text", [
    "camera_matrix:\n  data: [1, 2,\n",          # unterminated list
    "  rows: 3\n",                                # indented, outside a block
    "image_width 752\n",                          # no colon
], ids=["unterminated", "orphan_indent", "no_colon"])
def test_calib_parser_rejects_malformed(text):
    with pytest.raises(ValueError):
        parse_calib_yaml(text)


# ---------------------------------------------------------------------------
# compile cache, device checks, imports
# ---------------------------------------------------------------------------

_CACHE_PROBE = ("import jax; from ros_gpu_stereo_processor_tpu.utils.device "
                "import enable_compile_cache as e; print(e()); "
                "print(jax.config.jax_compilation_cache_dir)")


def test_compile_cache_follows_env(tmp_path):
    r = _run(_CACHE_PROBE, {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [str(tmp_path), str(tmp_path)]


def test_compile_cache_defaults_to_fixed_repo_dir():
    r = _run(_CACHE_PROBE, unset=("JAX_COMPILATION_CACHE_DIR",))
    assert r.returncode == 0, r.stderr
    want = os.path.join(REPO, ".jax_cache")
    assert r.stdout.split() == [want, want]
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_entry_point_refuses_cpu_only_run(script):
    r = _run([script])
    assert r.returncode != 0
    assert "no GPU" in r.stderr and "'cpu'" in r.stderr
    assert r.stdout.strip() == ""


def test_imports_without_yaml_cv2_imageio():
    """The package, the SLAM engine, chip_smoke and the synthetic data it
    renders need none of PyYAML, OpenCV or imageio."""
    code = '''
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("yaml", "cv2", "imageio"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import ros_gpu_stereo_processor_tpu as tps
import chip_smoke
from ros_gpu_stereo_processor_tpu.models.slam import StereoSlam
from ros_gpu_stereo_processor_tpu.utils.synth import (
    euroc_rig_frame, render_planar_sequence)
model, l, r, gt = euroc_rig_frame(width=96, height=64, max_disparity=8)
seq = render_planar_sequence(n_frames=2, width=64, height=48, fx=60.0)
assert l.shape == (64, 96) and seq.lefts.shape == (2, 48, 64)
assert not any(m.split(".")[0] in ("yaml", "cv2", "imageio") for m in sys.modules)
print("ok")
'''
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_no_tpu_only_code_left():
    """No module imports the TPU Pallas backend, runs a kernel in interpret
    mode, or branches on a "tpu" platform."""
    bad = re.compile(r"pallas\.tpu|pltpu|interpret\s*=|==\s*['\"]tpu['\"]|"
                     r"['\"]tpu['\"]\s*==|use_pallas")
    files = [os.path.join(REPO, f) for f in
             ("bench.py", "chip_smoke.py", "__graft_entry__.py")]
    for root, _, names in os.walk(os.path.join(REPO,
                                               "ros_gpu_stereo_processor_tpu")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    hits = []
    for f in files:
        with open(f) as fh:
            for i, line in enumerate(fh, 1):
                if bad.search(line):
                    hits.append(f"{os.path.relpath(f, REPO)}:{i}: {line.strip()}")
    assert not hits, hits


# ---------------------------------------------------------------------------
# chip_smoke phases: tiny on the CPU here, full size on the GPU (chip)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("phase", ["dense", "sgm", "color", "slam"])
def test_smoke_phase_tiny_on_cpu(phase):
    import jax

    cpu = jax.devices("cpu")[0]
    res = getattr(chip_smoke, f"phase_{phase}")(cpu, cpu, chip_smoke.TINY)
    assert res


def test_smoke_stage_times_tiny_on_cpu():
    import jax

    res = chip_smoke.stage_times(jax.devices("cpu")[0], chip_smoke.TINY)
    assert set(res) == {"remap", "bm", "speckle", "sgm_32d", "sgm_48d"}
    assert all(r["median_ms"] > 0 for r in res.values())


def test_smoke_four_cards_tiny_on_virtual_mesh():
    import jax

    res = chip_smoke.phase_four_cards(jax.devices()[:4], chip_smoke.TINY)
    assert res["disp_slabs_identical"]


@pytest.mark.chip
@pytest.mark.parametrize("phase", ["dense", "sgm", "color", "slam"])
def test_smoke_phase_on_gpu(gpu, phase):
    import jax

    getattr(chip_smoke, f"phase_{phase}")(gpu, jax.devices("cpu")[0])
