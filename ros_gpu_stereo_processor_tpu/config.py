"""Configuration dataclasses for the stereo engine.

Covers the reference's three config tiers (SURVEY.md §5.6):
  * the dynamic_reconfigure schema (reference: cfg/GPU.cfg:12-40) becomes
    :class:`StereoBMConfig` / :class:`SpeckleConfig` — frozen dataclasses whose
    fields are jit-static, so a change triggers recompilation of exactly the
    affected pipeline variants (the reference instead mutates live matcher
    objects under a mutex, src/StereoProcessor.cpp:307-336);
  * static rosparams (reference: src/StereoProcessor.cpp:33-49) become
    :class:`PipelineConfig`;
  * the demand bitfield ``ConnectedTopics`` (reference:
    include/gpuimageproc/ConnectedTopics.h:5-28) becomes :class:`Outputs`, a
    frozen flag-set that keys the jit variant cache.

Validation rules are the reference's (window forced odd, disparity range forced
to a multiple of 16 — src/StereoProcessor.cpp:310-311) applied at construction
time rather than silently at apply time.  The reference's ``disparity_min``
wiring bug (setMinDisparity(config.disparity_range),
src/StereoProcessor.cpp:317) is *not* replicated: ``min_disparity`` here is
real and used.
"""

from __future__ import annotations

import dataclasses
from typing import FrozenSet


def _validate_odd(name: str, value: int, lo: int, hi: int) -> int:
    if not (lo <= value <= hi):
        raise ValueError(f"{name}={value} out of range [{lo}, {hi}]")
    if value % 2 == 0:
        raise ValueError(f"{name}={value} must be odd")
    return value


@dataclasses.dataclass(frozen=True)
class StereoBMConfig:
    """Block-matcher parameters.

    Defaults follow the reference's reconfigure schema (cfg/GPU.cfg:16-35)
    rather than its constructor defaults (48/19), since the reconfigure server
    fires once at startup and overwrites them (src/StereoProcessor.cpp:80-82).
    """

    num_disparities: int = 64          # cfg/GPU.cfg:18 ("disparity_range", 16..128)
    block_size: int = 15               # cfg/GPU.cfg:16 ("correlation_window_size")
    min_disparity: int = 0             # cfg/GPU.cfg:17 (never applied in reference; fixed here)
    prefilter_cap: int = 31            # OpenCV StereoBM default, mirrored GPU/CPU
    xsobel: bool = True                # cfg/GPU.cfg:14 (PREFILTER_XSOBEL)
    texture_threshold: int = 10        # cfg/GPU.cfg:33
    uniqueness_ratio: int = 0          # cuda::StereoBM has none; 0 disables (parity default)
    refine_disparity: bool = False     # cfg/GPU.cfg:15 (subpixel parabola refine)
    # matcher algorithm: "bm" (SAD WTA, the reference's) or "sgm"
    # (semi-global path aggregation — the capability its stubbed bilateral
    # refinement aimed at, SURVEY.md §2.8b)
    algorithm: str = "bm"
    sgm_p1: float = 10.0
    sgm_p2: float = 120.0
    sgm_paths: int = 4
    # left-right consistency check (north-star frontend feature; invalidates
    # occlusions/mismatches where |d_L(x) − d_R(x − d_L)| > lr_max_diff)
    lr_check: bool = False
    lr_max_diff: int = 1

    def __post_init__(self) -> None:
        _validate_odd("block_size", self.block_size, 5, 255)
        if not (16 <= self.num_disparities <= 1024):
            raise ValueError(f"num_disparities={self.num_disparities} out of range")
        if self.num_disparities % 16 != 0:
            raise ValueError(
                f"num_disparities={self.num_disparities} must be a multiple of 16"
            )
        if not (-128 <= self.min_disparity <= 128):
            raise ValueError(f"min_disparity={self.min_disparity} out of range")
        if not (1 <= self.prefilter_cap <= 63):
            raise ValueError(f"prefilter_cap={self.prefilter_cap} out of range")
        if not (0 <= self.uniqueness_ratio <= 100):
            raise ValueError(f"uniqueness_ratio={self.uniqueness_ratio} out of range")
        if self.algorithm not in ("bm", "sgm"):
            raise ValueError(f"algorithm={self.algorithm!r} must be 'bm' or 'sgm'")
        if self.sgm_paths not in (2, 4, 8):
            raise ValueError(f"sgm_paths={self.sgm_paths} must be 2, 4 or 8")

    @property
    def block_radius(self) -> int:
        return self.block_size // 2

    def replace(self, **kw) -> "StereoBMConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class SpeckleConfig:
    """Speckle-filter parameters (cfg/GPU.cfg:34-35; applied reference:
    src/GPUStereoProcessor.cpp:356-385).  ``max_speckle_size <= 0`` disables
    the filter, as in the reference's gate."""

    max_speckle_size: int = 800        # cfg/GPU.cfg:34
    max_diff: float = 5.0              # cfg/GPU.cfg:35
    # label-propagation iteration budget (see ops/speckle.py); the exact
    # flood fill is sequential so we run a bounded number of min-label passes.
    propagation_iters: int = 64
    # multi-chip path: cross-band label-merge rounds (boundary-row
    # exchanges between devices — parallel/frontend.filter_speckles_row_sharded).  0 (the
    # default) iterates to convergence (a psum'd changed-flag clears), which
    # is exact for any component topology; > 0 forces a fixed bound.
    boundary_merge_rounds: int = 0

    @property
    def enabled(self) -> bool:
        return self.max_speckle_size > 0

    def replace(self, **kw) -> "SpeckleConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class BilateralConfig:
    """Disparity bilateral filter parameters (cfg/GPU.cfg:21-27).

    The reference declares and configures a
    ``cv::cuda::DisparityBilateralFilter`` but its creation/apply block is
    commented out (src/StereoProcessor.cpp:324-335) — a stub per SURVEY.md
    §2.8b.  Here the component is real (ops/bilateral.py) with the same
    parameter names, defaults and ranges as the reconfigure group.
    """

    enabled: bool = False              # cfg/GPU.cfg:21 ("bilateral_filter")
    ndisp: int = 64                    # cfg/GPU.cfg:22 ("filter_ndisp", 16..128)
    radius: int = 3                    # cfg/GPU.cfg:23 ("filter_radius", 1..10)
    iters: int = 1                     # cfg/GPU.cfg:24 ("filter_iters", 1..10)
    edge_threshold: float = 0.1        # cfg/GPU.cfg:25 (0.001..10)
    max_disc_threshold: float = 0.2    # cfg/GPU.cfg:26 (0.001..10)
    sigma_range: float = 10.0          # cfg/GPU.cfg:27 (1..100)

    def __post_init__(self) -> None:
        if not (16 <= self.ndisp <= 128):
            raise ValueError(f"ndisp={self.ndisp} out of range [16, 128]")
        if not (1 <= self.radius <= 10):
            raise ValueError(f"radius={self.radius} out of range [1, 10]")
        if not (1 <= self.iters <= 10):
            raise ValueError(f"iters={self.iters} out of range [1, 10]")
        for nm in ("edge_threshold", "max_disc_threshold"):
            v = getattr(self, nm)
            if not (0.001 <= v <= 10.0):
                raise ValueError(f"{nm}={v} out of range [0.001, 10]")
        if not (1.0 <= self.sigma_range <= 100.0):
            raise ValueError(f"sigma_range={self.sigma_range} out of range [1, 100]")

    def replace(self, **kw) -> "BilateralConfig":
        return dataclasses.replace(self, **kw)


# Reconfigure-key aliases: the reference's dynamic_reconfigure parameter
# names (cfg/GPU.cfg:21-27) → BilateralConfig fields.
BILATERAL_PARAM_ALIASES = {
    "bilateral_filter": "enabled",
    "filter_ndisp": "ndisp",
    "filter_radius": "radius",
    "filter_iters": "iters",
    "filter_edge_threshold": "edge_threshold",
    "filter_max_disc_threshold": "max_disc_threshold",
    "filter_sigma_range": "sigma_range",
}

# The full dynamic_reconfigure vocabulary (cfg/GPU.cfg:12-40) → our fields,
# so a live reconfigure channel can speak the reference's parameter names.
RECONFIGURE_PARAM_ALIASES = {
    "correlation_window_size": "block_size",     # cfg/GPU.cfg:16
    "disparity_range": "num_disparities",        # cfg/GPU.cfg:18
    "disparity_min": "min_disparity",            # cfg/GPU.cfg:17 (wired here;
                                                 # dead in the reference, §2.19)
    "max_speckle_diff": "max_diff",              # cfg/GPU.cfg:35
    **BILATERAL_PARAM_ALIASES,
}


def sanitize_reconfigure(kw: dict) -> dict:
    """The reference configCb's parameter sanitisation
    (src/StereoProcessor.cpp:310-311): correlation window forced odd,
    disparity range forced to a multiple of 16."""
    kw = {RECONFIGURE_PARAM_ALIASES.get(k, k): v for k, v in kw.items()}
    if "block_size" in kw:
        kw["block_size"] = int(kw["block_size"]) | 1
    if "num_disparities" in kw:
        kw["num_disparities"] = max(16, (int(kw["num_disparities"]) // 16) * 16)
    return kw


# ---------------------------------------------------------------------------
# Demand flags — the reference's ConnectedTopics bitfield
# ---------------------------------------------------------------------------

# One name per lazily-advertised topic of the reference
# (src/StereoProcessor.cpp:90-100 / ConnectedTopics.h:8-20).
OUTPUT_NAMES = (
    "mono_left",
    "mono_right",
    "color_left",
    "color_right",
    "rect_mono_left",
    "rect_mono_right",
    "rect_color_left",
    "rect_color_right",
    "disparity",
    "disparity_vis",
    "pointcloud",
)


@dataclasses.dataclass(frozen=True)
class Outputs:
    """Frozen demand flag-set: which pipeline outputs are wanted this frame.

    Replaces the reference's ``ConnectedTopics`` union-of-bitfields
    (include/gpuimageproc/ConnectedTopics.h:5-28).  Hashable → usable as a
    jit-static argument; XLA dead-code-eliminates every stage whose output is
    not requested, which is the compiler doing what the reference's demand-
    driven ``imageCb`` branches (src/StereoProcessor.cpp:183-281) do by hand.
    """

    flags: FrozenSet[str] = frozenset()

    def __post_init__(self) -> None:
        unknown = set(self.flags) - set(OUTPUT_NAMES)
        if unknown:
            raise ValueError(f"unknown output flags: {sorted(unknown)}")
        object.__setattr__(self, "flags", frozenset(self.flags))

    @classmethod
    def of(cls, *names: str) -> "Outputs":
        return cls(frozenset(names))

    @classmethod
    def all(cls) -> "Outputs":
        return cls(frozenset(OUTPUT_NAMES))

    @classmethod
    def none(cls) -> "Outputs":
        return cls(frozenset())

    def __contains__(self, name: str) -> bool:
        return name in self.flags

    def __or__(self, other: "Outputs") -> "Outputs":
        return Outputs(self.flags | other.flags)

    def __bool__(self) -> bool:
        return bool(self.flags)

    # ---- derived demand, mirroring imageCb's stage gating -----------------
    # (reference: src/StereoProcessor.cpp:183-281)

    @property
    def needs_disparity(self) -> bool:
        return bool(self.flags & {"disparity", "disparity_vis", "pointcloud"})

    @property
    def needs_rect_mono(self) -> bool:
        # rectified mono feeds the block matcher as well as its own topics
        return self.needs_disparity or bool(
            self.flags & {"rect_mono_left", "rect_mono_right"}
        )

    @property
    def needs_rect_color(self) -> bool:
        # the point cloud packs rectified color as RGB (GpuSenderPc2.cpp:43-71)
        return bool(self.flags & {"rect_color_left", "rect_color_right", "pointcloud"})

    @property
    def needs_mono(self) -> bool:
        return self.needs_rect_mono or bool(self.flags & {"mono_left", "mono_right"})

    @property
    def needs_color(self) -> bool:
        return self.needs_rect_color or bool(self.flags & {"color_left", "color_right"})

    def level(self) -> int:
        """Pipeline depth = index of deepest requested stage
        (reference: ConnectedTopics::level(), ConnectedTopics.h:22-27)."""
        depth = 0
        for i, name in enumerate(OUTPUT_NAMES):
            if name in self.flags:
                depth = i + 1
        return depth


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static engine options (the reference's startup rosparams,
    src/StereoProcessor.cpp:33-49 & README.rst:4-8)."""

    queue_size: int = 5                 # input pairing queue depth
    approximate_sync: bool = False      # exact vs nearest-timestamp pairing
    publisher_queue_size: int = 1       # output adapter queue depth
    max_in_flight: int = 2              # frames in flight (reference syncs every frame)
    # disparity publish wire: 'float32' (4 B/px, exact), 'fixed16' (2 B/px,
    # exact at the matcher's 1/16 px), 'fixed8' (1 B/px, 1/4 px — the
    # reference's own 8-bit wire upgraded with subpixel bits, SURVEY.md
    # §2.12; requires min_disparity ≥ 0).  On link-bound deployments the
    # wire width IS the publish latency.
    disparity_wire: str = "float32"
    stereobm: StereoBMConfig = StereoBMConfig()
    speckle: SpeckleConfig = SpeckleConfig()
    bilateral: BilateralConfig = BilateralConfig()

    def __post_init__(self):
        if self.disparity_wire not in ("float32", "fixed16", "fixed8"):
            raise ValueError(
                f"disparity_wire={self.disparity_wire!r} must be "
                "'float32', 'fixed16' or 'fixed8'")
        if self.disparity_wire == "fixed8" and self.stereobm.min_disparity < 0:
            raise ValueError(
                "fixed8 wire needs min_disparity >= 0 (unsigned wire); "
                "use fixed16 for negative search ranges")

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)
