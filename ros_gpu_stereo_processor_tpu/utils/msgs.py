"""Output message structs and async senders.

The reference's L2 layer (SURVEY.md §2.10-2.13) builds ROS messages inside
CUDA stream host-callbacks: ``enqueueSend(stream)`` registers a callback that
runs ``fillInData(); publish()`` once prior device work completes
(src/GpuSenderIfc.cpp:13-26), overlapping publish I/O with later compute.

The idiomatic JAX equivalent implemented here: the jitted pipeline step
*dispatches* asynchronously and returns device arrays (futures); a
:class:`SenderPool` worker thread blocks on each output array
(``block_until_ready`` ≙ the stream reaching the callback), converts to a
message struct, and invokes the registered publisher callback.  A ``None``
publisher is allowed and skips publishing — the reference's NULL-publisher
test trick (test/UTest.cpp:304, guard src/GpuSenderImage.cpp:30).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from ros_gpu_stereo_processor_tpu.config import StereoBMConfig
from ros_gpu_stereo_processor_tpu.ops import color as color_ops


@dataclasses.dataclass(frozen=True)
class Header:
    stamp: float = 0.0
    frame_id: str = ""
    seq: int = 0


@dataclasses.dataclass
class ImageMessage:
    """sensor_msgs/Image equivalent (reference: src/GpuSenderImage.cpp:15-26)."""

    header: Header
    height: int
    width: int
    encoding: str
    data: np.ndarray                 # (H, W[, C]) array

    @property
    def step(self) -> int:
        return self.width * color_ops.bytes_per_pixel(self.encoding)


@dataclasses.dataclass
class DisparityImageMessage:
    """stereo_msgs/DisparityImage equivalent with *correctly wired* metadata —
    the intent of the reference's sender, fixing its ctor-argument-swap and
    8U-as-32F bugs (SURVEY.md §2.12).  ``image`` is true float32 disparity."""

    header: Header
    image: np.ndarray                # (H, W) float32, invalid < min_disparity
    f: float                         # focal length (px)
    T: float                         # baseline (m)
    min_disparity: float
    max_disparity: float
    delta_d: float                   # smallest disparity increment
    valid_window: Tuple[int, int, int, int]  # x, y, w, h


@dataclasses.dataclass
class PointCloud2Message:
    """sensor_msgs/PointCloud2 equivalent: organized H×W cloud with
    x/y/z/rgb float32 fields (reference: src/GpuSenderPc2.cpp:15-72).
    ``xyz`` is NaN for invalid points; is_dense=False."""

    header: Header
    height: int
    width: int
    xyz: np.ndarray                  # (H, W, 3) float32
    rgb: Optional[np.ndarray]        # (H, W) float32 packed 0x00RRGGBB, or None
    is_dense: bool = False

    fields = (("x", 0), ("y", 4), ("z", 8), ("rgb", 12))
    point_step: int = 16

    def packed_data(self) -> np.ndarray:
        """Serialise to the PointCloud2 wire layout (H*W, 16 bytes)."""
        out = np.zeros((self.height * self.width, 4), np.float32)
        out[:, :3] = self.xyz.reshape(-1, 3)
        if self.rgb is not None:
            out[:, 3] = self.rgb.reshape(-1)
        return out.view(np.uint8).reshape(self.height, self.width * self.point_step)


def make_disparity_message(
    header: Header,
    disp_np: np.ndarray,
    cfg: StereoBMConfig,
    fx: float,
    baseline: float,
    shape: Tuple[int, int],
) -> DisparityImageMessage:
    from ros_gpu_stereo_processor_tpu.ops.stereobm import valid_window

    H, W = shape
    delta_d = (1.0 / 16.0) if cfg.refine_disparity else 1.0
    if disp_np.dtype == np.int16:
        # fixed-point ×16 wire format (the matcher's native 1/16 px
        # resolution — the 16S convention the reference's pipeline carries,
        # src/GPUStereoProcessor.cpp:367-385): half the publish bytes,
        # semantically lossless for |d| < 2048
        disp_np = disp_np.astype(np.float32) / 16.0
    elif disp_np.dtype == np.uint8:
        # fixed8 offset wire (the reference's de-facto 8-bit disparity wire
        # + 2 subpixel bits, SURVEY.md §2.12): quarter the float bytes
        disp_np = disparity_fixed8_decode(
            disp_np, cfg.min_disparity,
            fill_value=float(cfg.min_disparity - 1))
        delta_d = max(delta_d, 0.25)
    return DisparityImageMessage(
        header=header,
        image=disp_np,
        f=fx,
        T=baseline,
        min_disparity=float(cfg.min_disparity),
        max_disparity=float(cfg.min_disparity + cfg.num_disparities - 1),
        delta_d=delta_d,
        valid_window=valid_window(cfg, H, W),
    )


def disparity_fixed16(disp) -> "jnp.ndarray":
    """Device-side ×16 int16 quantisation for wire transfer (exact at the
    matcher's 1/16 px resolution)."""
    import jax.numpy as jnp

    return jnp.round(disp * 16.0).astype(jnp.int16)


def disparity_fixed8(disp, min_disparity: int = 0) -> "jnp.ndarray":
    """Device-side ×4 uint8 quantisation for wire transfer — the
    reference's de-facto 8-bit disparity wire (its published buffer is the
    CV_8UC1 fixed-point matcher output, SURVEY.md §2.12/§2.7), upgraded
    with 2 subpixel bits.  Halves the publish bytes of fixed16 — the right
    wire when the link, not the engine, is the bottleneck and the consumer
    accepts 1/4-px granularity.

    The wire carries the OFFSET from ``min_disparity`` (plus a half-pixel
    bias for the subpixel excursion below the first candidate):
    ``code = (d − min_disparity + 0.5)·4``, decoded by
    :func:`disparity_fixed8_decode`; 255 is the invalid sentinel.  Any
    non-negative 64-candidate search range fits: exact at 1/4 px for
    d ∈ [min−0.5, min+63.0]; the top subpixel excursion
    (min+63.0, min+63.5] saturates to the largest code (≤ 0.5 px error at
    the extreme top of the range, never a silent invalidation).

    ``min_disparity`` must match the matcher config: the engine's invalid
    fill is ``min_disparity − 1``, detected here as
    ``disp < min_disparity − 0.5`` (subpixel refinement reaches at most
    0.5 px below the smallest candidate).  Negative search ranges don't
    fit an unsigned wire — use :func:`disparity_fixed16`."""
    import jax.numpy as jnp

    if min_disparity < 0:
        raise ValueError(
            "disparity_fixed8 needs a non-negative search range; "
            "use disparity_fixed16 for min_disparity < 0")
    q = jnp.round((disp - float(min_disparity) + 0.5) * 4.0)
    invalid = disp < float(min_disparity) - 0.5
    return jnp.where(invalid, 255.0, jnp.minimum(q, 254.0)).astype(jnp.uint8)


def disparity_fixed8_decode(wire: np.ndarray, min_disparity: int = 0,
                            fill_value: float = float("nan")) -> np.ndarray:
    """Decode the :func:`disparity_fixed8` wire back to float32 disparity
    (``fill_value`` at the 255 sentinel).  Host-side numpy (consumers run
    off-device)."""
    w = np.asarray(wire)
    d = w.astype(np.float32) / 4.0 - 0.5 + float(min_disparity)
    return np.where(w == 255, np.float32(fill_value), d)


PublishFn = Callable[[Any], None]


class SenderPool:
    """Async output delivery: per-output device futures → messages → publishers.

    ``enqueue(name, device_array, build_fn)`` returns immediately; a worker
    blocks on the array, builds the message and calls the publisher registered
    for ``name`` (if any).  ``wait_all()`` ≙ the reference's
    ``waitForAllStreams`` + sender drain (src/GPUStereoProcessor.cpp:348-354).
    Unlike the reference, in-flight sends are joined before re-use, closing its
    acknowledged previous-frame-senders race (src/StereoProcessor.cpp:165-166).
    """

    def __init__(self, max_workers: int = 2):
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=max_workers)
        self._publishers: Dict[str, PublishFn] = {}
        self._inflight: list = []
        self._lock = threading.Lock()
        self._sent: Dict[str, bool] = {}

    def register(self, name: str, publish: Optional[PublishFn]) -> None:
        if publish is not None:
            self._publishers[name] = publish

    def enqueue(self, name: str, arrays, build_fn: Callable[..., Any]) -> "concurrent.futures.Future":
        """arrays: device array or tuple of them; build_fn(*host_arrays) → msg."""
        self._sent[name] = False
        arrs = arrays if isinstance(arrays, tuple) else (arrays,)
        # start the device→host copy NOW, from the enqueueing thread: the
        # copy is queued after the producing computation and streams into the
        # runtime's host cache, so the worker's np.asarray mostly finds the
        # bytes already landed.  This amortises the per-fetch round trip
        # across all in-flight sends.
        for a in arrs:
            if hasattr(a, "copy_to_host_async"):
                try:
                    a.copy_to_host_async()
                except Exception:
                    pass  # committed/donated edge cases: worker fetch still works

        def work():
            host = tuple(np.asarray(a) for a in arrs)
            msg = build_fn(*host)
            pub = self._publishers.get(name)
            if pub is not None:
                pub(msg)
            self._sent[name] = True
            return msg

        fut = self._pool.submit(work)
        with self._lock:
            self._inflight.append(fut)
        return fut

    def was_data_sent(self, name: str) -> bool:
        """The reference's wasDataSent() test hook (GpuSenderIfc.h:20)."""
        return self._sent.get(name, False)

    def wait_all(self) -> None:
        with self._lock:
            inflight, self._inflight = self._inflight, []
        for fut in inflight:
            fut.result()

    def shutdown(self) -> None:
        self.wait_all()
        self._pool.shutdown(wait=True)
