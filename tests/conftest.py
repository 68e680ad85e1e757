"""Test env: an 8-device virtual CPU mesh, set before JAX is imported, so
multi-chip sharding logic is CI-able without accelerators (SURVEY.md §4
implications).  ``JAX_PLATFORMS`` is only defaulted: tests marked ``chip``
run on the GPU with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m chip``
(``cpu`` too, for the reference), and skip everywhere else."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest

TEST_DATA = "/root/reference/test/stereobm/test_data"


@pytest.fixture
def gpu():
    """The GPU for ``chip`` tests, decided when the test runs (never at
    import or collection, so every worker collects the same tests)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is on {dev.platform!r}")
    return dev


@pytest.fixture(scope="session")
def test_data_dir():
    if not os.path.isdir(TEST_DATA):
        pytest.skip("reference test data not available")
    return TEST_DATA


@pytest.fixture(scope="session")
def kitchen_images(test_data_dir):
    """752×480 mono stereo pair + pre-rectified goldens (the reference's
    loadImagesKitchen fixture, test/UTest.cpp:89-95)."""
    import cv2

    def rd(name):
        img = cv2.imread(os.path.join(test_data_dir, name), cv2.IMREAD_GRAYSCALE)
        assert img is not None, name
        return img

    return {
        "left": rd("left-0022.png"),
        "right": rd("right-0022.png"),
        "left_rect": rd("left-0022_rect.png"),
        "right_rect": rd("right-0022_rect.png"),
    }


@pytest.fixture(scope="session")
def aloe_images(test_data_dir):
    import cv2

    def rd(name, flag=None):
        img = cv2.imread(
            os.path.join(test_data_dir, name),
            cv2.IMREAD_GRAYSCALE if flag is None else flag,
        )
        assert img is not None, name
        return img

    return {
        "left": rd("aloe-L-Mono.png"),
        "right": rd("aloe-R.png", cv2.IMREAD_GRAYSCALE),
        "disp": rd("aloe-disp.png"),
    }


@pytest.fixture(scope="session")
def stereo_model(test_data_dir):
    from ros_gpu_stereo_processor_tpu.utils.calib import StereoCameraModel

    return StereoCameraModel.from_files(
        os.path.join(test_data_dir, "left.yaml"),
        os.path.join(test_data_dir, "right.yaml"),
    )


def mean_abs_error(a, b):
    """The reference's mat_are_similar comparator: mean |a−b| per pixel
    (test/UTest.cpp:125-149)."""
    return float(np.mean(np.abs(a.astype(np.float64) - b.astype(np.float64))))
