"""Stereo vision / SLAM engine in JAX, run on an NVIDIA GPU.

A from-scratch JAX/XLA re-design of the capabilities of the reference
ROS/CUDA nodelet ``maciejmatuszak/ros_gpu_stereo_processor`` (package
``gpuimageproc``): debayer/color conversion, stereo rectification, SAD
block-matching disparity with prefilter/texture/speckle filtering, disparity
visualization and Q-matrix reprojection to colored point clouds — driven by a
demand-activated, jit-compiled frame pipeline — and extended into a distributed
stereo SLAM system (features, VO, windowed BA, pose-graph optimisation) sharded
over multi-device meshes.

Reference layer map: see SURVEY.md §1 (reference: include/gpuimageproc/*.h,
src/*.cpp).  Nothing here is a translation: the compute path is jnp left
to XLA, the orchestration is jit variant caching over a demand flag-set, and
multi-device parallelism (absent from the reference) is first-class via
jax.sharding.
"""

from ros_gpu_stereo_processor_tpu.config import (
    StereoBMConfig,
    SpeckleConfig,
    PipelineConfig,
    Outputs,
)
from ros_gpu_stereo_processor_tpu.utils.calib import (
    CameraCalib,
    PinholeCameraModel,
    StereoCameraModel,
    load_camera_calib,
)
from ros_gpu_stereo_processor_tpu.models.pipeline import StereoPipeline


def __getattr__(name):
    # heavier subsystems load lazily so `import ros_gpu_stereo_processor_tpu`
    # stays light for dense-pipeline-only users
    if name in ("StereoSlam", "SlamConfig"):
        from ros_gpu_stereo_processor_tpu.models import slam

        return getattr(slam, name)
    if name == "StereoVisualOdometry":
        from ros_gpu_stereo_processor_tpu.models.vo import StereoVisualOdometry

        return StereoVisualOdometry
    if name in ("Trajectory", "ate_rmse", "load_euroc_groundtruth"):
        from ros_gpu_stereo_processor_tpu.utils import evaluate

        return getattr(evaluate, name)
    if name == "EurocReader":
        from ros_gpu_stereo_processor_tpu.utils.io import EurocReader

        return EurocReader
    raise AttributeError(name)


__version__ = "0.1.0"

__all__ = [
    "StereoBMConfig",
    "SpeckleConfig",
    "PipelineConfig",
    "Outputs",
    "CameraCalib",
    "PinholeCameraModel",
    "StereoCameraModel",
    "load_camera_calib",
    "StereoPipeline",
    "StereoSlam",
    "SlamConfig",
    "StereoVisualOdometry",
    "EurocReader",
    "Trajectory",
    "ate_rmse",
    "load_euroc_groundtruth",
]
