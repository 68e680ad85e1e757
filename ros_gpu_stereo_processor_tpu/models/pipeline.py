"""The demand-driven stereo frame pipeline — the engine's flagship "model".

Re-design of the reference's orchestrator
``StereoProcessor::imageCb`` (src/StereoProcessor.cpp:157-298) and engine
``GpuStereoProcessor`` (src/GPUStereoProcessor.cpp).  Key translations
(SURVEY.md §7 architecture):

  * the enum-keyed mutable buffer registry (GpuMatSource + HostMem map,
    GPUStereoProcessor.h:21-61,112) → a functional dict of jnp arrays inside
    one traced step;
  * the hand-written demand branches of imageCb → ONE jitted function per
    :class:`Outputs` flag-set; stages whose outputs aren't requested are
    dead-code-eliminated by XLA.  Variants are memoized in a jit cache keyed
    by (outputs, encoding, bm-config, speckle-config) — the compiler-native
    form of lazy topic subscription (connectCb, src/StereoProcessor.cpp:104-142);
  * dual CUDA streams per side (GPUStereoProcessor.h:110) → L/R batched on a
    leading axis, vectorised in one launch;
  * per-frame stream sync (src/StereoProcessor.cpp:284) → async dispatch;
    outputs are device futures consumed by the SenderPool off-thread.

Per-stage wall timing (the reference's TIMING debug line,
src/StereoProcessor.cpp:288-297) is available via
:meth:`StereoPipeline.timed_process`.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ros_gpu_stereo_processor_tpu.config import (
    BilateralConfig,
    Outputs,
    PipelineConfig,
    SpeckleConfig,
    StereoBMConfig,
)
from ros_gpu_stereo_processor_tpu.ops import color as color_ops
from ros_gpu_stereo_processor_tpu.ops import colormap as colormap_ops
from ros_gpu_stereo_processor_tpu.ops import remap as remap_ops
from ros_gpu_stereo_processor_tpu.ops import reproject as reproject_ops
from ros_gpu_stereo_processor_tpu.ops import speckle as speckle_ops
from ros_gpu_stereo_processor_tpu.ops import stereobm as stereobm_ops
from ros_gpu_stereo_processor_tpu.utils.calib import StereoCameraModel
from ros_gpu_stereo_processor_tpu.utils.msgs import (
    Header,
    ImageMessage,
    PointCloud2Message,
    SenderPool,
    make_disparity_message,
)

logger = logging.getLogger("tpu_stereo")


def _pipeline_step(
    left_raw: jnp.ndarray,
    right_raw: jnp.ndarray,
    rect_maps: jnp.ndarray,      # (2, H, W, 2)
    Q: jnp.ndarray,              # (4, 4)
    *,
    encoding: str,
    outputs: Outputs,
    bm: StereoBMConfig,
    speckle: SpeckleConfig,
    bilateral: BilateralConfig = BilateralConfig(),
    mesh: Any | None = None,
    shard_axis: str = "rows",
    shard_mode: str = "rows",
) -> Dict[str, Any]:
    """One traced frame step.  Static args select the stage set; XLA DCEs the
    rest.  Mirrors the stage DAG of imageCb (SURVEY.md §3.1).

    ``mesh``: optional jax.sharding.Mesh — the multi-chip path.  The matcher
    runs under shard_map (row-band halo exchange, disparity slabs, or
    row-sharded SGM per ``shard_mode``/config; parallel/frontend.py), speckle
    and bilateral run their sharded variants, and every pointwise stage is
    constrained to row-band sharding so the whole frame stays distributed —
    the multi-chip generalisation of the reference's dual-stream parallelism
    (SURVEY.md §2 parallelism note)."""
    res: Dict[str, Any] = {}

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as _P

        from ros_gpu_stereo_processor_tpu.parallel import frontend as par

        _row = NamedSharding(mesh, _P(shard_axis))

        def _shard(x):
            return jax.lax.with_sharding_constraint(x, _row)
    else:
        def _shard(x):
            return x

    def _remap(img, side):
        i = 0 if side == "left" else 1
        return _shard(remap_ops.remap_bilinear(img, rect_maps[i]))

    mono = {}
    if outputs.needs_mono:
        mono["left"] = color_ops.convert(left_raw, encoding, "mono8")
        mono["right"] = color_ops.convert(right_raw, encoding, "mono8")
        for side in ("left", "right"):
            if f"mono_{side}" in outputs:
                res[f"mono_{side}"] = _shard(mono[side])

    colr = {}
    if outputs.needs_color:
        colr["left"] = color_ops.convert(left_raw, encoding, "rgb8")
        colr["right"] = color_ops.convert(right_raw, encoding, "rgb8")
        for side in ("left", "right"):
            if f"color_{side}" in outputs:
                res[f"color_{side}"] = _shard(colr[side])

    rect_mono = {}
    if outputs.needs_rect_mono:
        for side in ("left", "right"):
            rect_mono[side] = _remap(mono[side], side)
            if f"rect_mono_{side}" in outputs:
                res[f"rect_mono_{side}"] = rect_mono[side]

    rect_color = {}
    if outputs.needs_rect_color:
        # the reference rectifies color only for requested sides + pc left
        # (src/StereoProcessor.cpp:239-256); we batch both when both needed
        need = [
            s
            for s in ("left", "right")
            if f"rect_color_{s}" in outputs or (s == "left" and "pointcloud" in outputs)
        ]
        for side in need:
            rect_color[side] = _remap(colr[side], side)
            if f"rect_color_{side}" in outputs:
                res[f"rect_color_{side}"] = rect_color[side]

    if outputs.needs_disparity:
        if mesh is not None:
            if bm.algorithm == "sgm":
                disp, valid = par.disparity_sgm_row_sharded(
                    rect_mono["left"], rect_mono["right"], bm, mesh,
                    shard_axis, p1=bm.sgm_p1, p2=bm.sgm_p2,
                )
            elif shard_mode == "disp":
                disp, valid = par.disparity_slab_sharded(
                    rect_mono["left"], rect_mono["right"], bm, mesh, shard_axis
                )
                disp, valid = _shard(disp), _shard(valid)
            else:
                disp, valid = par.disparity_row_sharded(
                    rect_mono["left"], rect_mono["right"], bm, mesh,
                    shard_axis,
                )
        elif bm.algorithm == "sgm":
            from ros_gpu_stereo_processor_tpu.ops import sgm as sgm_ops

            disp, valid = sgm_ops.compute_disparity_sgm(
                rect_mono["left"], rect_mono["right"], bm,
                p1=bm.sgm_p1, p2=bm.sgm_p2, num_paths=bm.sgm_paths,
            )
        else:
            disp, valid = stereobm_ops.compute_disparity(
                rect_mono["left"], rect_mono["right"], bm
            )
        if speckle.enabled:
            if mesh is not None:
                disp, valid = par.filter_speckles_row_sharded(
                    disp, valid, mesh, shard_axis,
                    max_speckle_size=speckle.max_speckle_size,
                    max_diff=speckle.max_diff,
                    iters=speckle.propagation_iters,
                    merge_rounds=speckle.boundary_merge_rounds,
                    fill_value=float(bm.min_disparity - 1),
                )
            else:
                disp, valid = speckle_ops.filter_speckles(
                    disp,
                    valid,
                    max_speckle_size=speckle.max_speckle_size,
                    max_diff=speckle.max_diff,
                    iters=speckle.propagation_iters,
                    fill_value=float(bm.min_disparity - 1),
                )
        if bilateral.enabled:
            # the intended post-filter of the reference's stub (§2.8b):
            # refine disparity guided by the left rectified image
            from ros_gpu_stereo_processor_tpu.ops import bilateral as bilateral_ops

            if mesh is not None:
                refined = par.bilateral_row_sharded(
                    disp, rect_mono["left"], mesh, shard_axis,
                    ndisp=bilateral.ndisp,
                    radius=bilateral.radius,
                    iters=bilateral.iters,
                    edge_threshold=bilateral.edge_threshold,
                    max_disc_threshold=bilateral.max_disc_threshold,
                    sigma_range=bilateral.sigma_range,
                )
            else:
                refined = bilateral_ops.disparity_bilateral_filter(
                    disp,
                    rect_mono["left"],
                    ndisp=bilateral.ndisp,
                    radius=bilateral.radius,
                    iters=bilateral.iters,
                    edge_threshold=bilateral.edge_threshold,
                    max_disc_threshold=bilateral.max_disc_threshold,
                    sigma_range=bilateral.sigma_range,
                )
            # keep invalid pixels invalid: refinement only rewrites valid ones
            disp = jnp.where(valid, refined, disp)
        if "disparity" in outputs:
            res["disparity"] = disp
            res["disparity_valid"] = valid
        if "disparity_vis" in outputs:
            res["disparity_vis"] = _shard(colormap_ops.colorize_disparity(
                disp, bm.num_disparities, valid
            ))
        if "pointcloud" in outputs:
            pc = reproject_ops.point_cloud(
                disp, Q, rgb=rect_color.get("left"), valid=valid
            )
            res["pointcloud_xyz"] = _shard(pc["xyz"])
            if "rgb" in pc:
                res["pointcloud_rgb"] = _shard(pc["rgb"])

    return res


@dataclasses.dataclass
class FrameResult:
    """Device-array outputs of one frame step (futures until fetched)."""

    outputs: Dict[str, Any]
    header: Header

    def fetch(self) -> Dict[str, np.ndarray]:
        self.block_until_ready()   # join first: asarray on unfinished arrays
        return {k: np.asarray(v) for k, v in self.outputs.items()}

    def block_until_ready(self) -> "FrameResult":
        for v in self.outputs.values():
            if hasattr(v, "block_until_ready"):
                v.block_until_ready()
        return self


class StereoPipeline:
    """The engine object (library-embedding API — the role of the reference's
    nodelet deployment, SURVEY.md §2.18): construct once with a stereo model,
    then ``process`` frames with any demand flag-set."""

    def __init__(
        self,
        model: StereoCameraModel,
        config: PipelineConfig = PipelineConfig(),
        mesh=None,
        shard_axis: str | None = None,
        shard_mode: str = "rows",
    ):
        """``mesh``: optional jax.sharding.Mesh — run every frame step
        sharded over its ``shard_axis`` (default: the mesh's first axis).
        ``shard_mode``: 'rows' (row-band halo exchange) or 'disp'
        (disparity-slab argmin-reduce); SGM configs always row-shard."""
        self.model = model
        self.config = config
        self.mesh = mesh
        self.shard_axis = (
            shard_axis if shard_axis is not None
            else (mesh.axis_names[0] if mesh is not None else "rows")
        )
        if shard_mode not in ("rows", "disp"):
            raise ValueError(f"shard_mode={shard_mode!r} must be 'rows' or 'disp'")
        self.shard_mode = shard_mode
        if mesh is not None:
            n = mesh.shape[self.shard_axis]
            H = model.left.calib.height
            if H % n != 0:
                raise ValueError(
                    f"image height {H} not divisible by mesh axis "
                    f"{self.shard_axis}={n}"
                )
        if mesh is not None:
            # replicated placement that is multi-process-correct: every host
            # holds the same calib constants / raw frames, so a replicated
            # NamedSharding assembles the global arrays without cross-host
            # traffic (single-process meshes: identical to plain asarray)
            from jax.sharding import NamedSharding, PartitionSpec as _P

            self._repl = NamedSharding(mesh, _P())
            self._rect_maps = jax.device_put(
                model.rect_maps_stacked(), self._repl)
            self._Q = jax.device_put(
                model.Q.astype(np.float32), self._repl)
        else:
            self._repl = None
            self._rect_maps = jnp.asarray(model.rect_maps_stacked())
            self._Q = jnp.asarray(model.Q.astype(np.float32))
        self._variants: Dict[Tuple, Any] = {}
        self.senders = SenderPool(
            max_workers=max(1, config.publisher_queue_size + 1)
        )
        from ros_gpu_stereo_processor_tpu.utils.timing import StageTimer

        self.timer = StageTimer()
        # bounded dispatch depth (config.max_in_flight): the reference syncs
        # every frame (src/StereoProcessor.cpp:284); we keep up to
        # max_in_flight dispatched frames outstanding and join the oldest
        # before admitting a new one, so the host can't run unboundedly ahead
        # of the device.
        from collections import deque

        self._in_flight: deque = deque()
        # model-init log, the reference's FOV line
        # (src/GPUStereoProcessor.cpp:47-51)
        import numpy as _np

        logger.info(
            "stereo model: %dx%d fx=%.2f baseline=%.4fm FOV=%.1fx%.1fdeg",
            model.left.calib.width, model.left.calib.height, model.fx,
            model.baseline, _np.degrees(model.left.fov_x),
            _np.degrees(model.left.fov_y),
        )

    # -- live-tunable config (the dynamic_reconfigure role, SURVEY.md §2.19):
    # replacing the config swaps which jit variants future frames use; already
    # compiled variants for other configs stay cached.
    def reconfigure(self, **kw) -> None:
        # accept the reference's full dynamic_reconfigure vocabulary
        # (cfg/GPU.cfg:12-40) alongside our field names, with the reference
        # configCb's sanitisation (window odd, range ×16)
        from ros_gpu_stereo_processor_tpu.config import sanitize_reconfigure

        kw = sanitize_reconfigure(kw)
        bm_fields = {f.name for f in dataclasses.fields(StereoBMConfig)}
        sp_fields = {f.name for f in dataclasses.fields(SpeckleConfig)}
        bl_fields = {f.name for f in dataclasses.fields(BilateralConfig)}
        unknown = set(kw) - bm_fields - sp_fields - bl_fields
        if unknown:
            raise ValueError(f"unknown reconfigure parameters: {sorted(unknown)}")
        bm_kw = {k: v for k, v in kw.items() if k in bm_fields}
        sp_kw = {k: v for k, v in kw.items() if k in sp_fields and k not in bm_fields}
        bl_kw = {
            k: v
            for k, v in kw.items()
            if k in bl_fields and k not in bm_fields and k not in sp_fields
        }
        cfg = self.config
        if bm_kw:
            cfg = cfg.replace(stereobm=cfg.stereobm.replace(**bm_kw))
        if sp_kw:
            cfg = cfg.replace(speckle=cfg.speckle.replace(**sp_kw))
        if bl_kw:
            cfg = cfg.replace(bilateral=cfg.bilateral.replace(**bl_kw))
        self.config = cfg
        # reconfigure summary line (reference: src/StereoProcessor.cpp:322)
        logger.info("reconfigured: %s %s %s", cfg.stereobm, cfg.speckle, cfg.bilateral)

    def _get_variant(self, outputs: Outputs, encoding: str):
        key = (outputs.flags, encoding, self.config.stereobm, self.config.speckle,
               self.config.bilateral)
        fn = self._variants.get(key)
        if fn is None:
            bm, sp, bl = self.config.stereobm, self.config.speckle, self.config.bilateral
            mesh, axis, mode = self.mesh, self.shard_axis, self.shard_mode

            def step(l, r, maps, Q):
                return _pipeline_step(
                    l, r, maps, Q,
                    encoding=encoding, outputs=outputs, bm=bm, speckle=sp,
                    bilateral=bl,
                    mesh=mesh, shard_axis=axis, shard_mode=mode,
                )

            fn = jax.jit(step)
            self._variants[key] = fn
        return fn

    def process(
        self,
        left: np.ndarray,
        right: np.ndarray,
        outputs: Outputs,
        encoding: str = "mono8",
        header: Optional[Header] = None,
    ) -> FrameResult:
        """Dispatch one frame.  Returns immediately with device futures —
        unless ``config.max_in_flight`` frames are already outstanding, in
        which case the oldest is joined first (bounded pipelining)."""
        fn = self._get_variant(outputs, encoding)
        if self._repl is not None and not isinstance(left, jax.Array):
            left = jax.device_put(np.asarray(left), self._repl)
            right = jax.device_put(np.asarray(right), self._repl)
        out = fn(jnp.asarray(left), jnp.asarray(right), self._rect_maps, self._Q)
        res = FrameResult(outputs=out, header=header or Header())
        depth = max(1, self.config.max_in_flight)
        self._in_flight.append(res)
        while len(self._in_flight) > depth:
            self._in_flight.popleft().block_until_ready()
        return res

    def process_batch(
        self,
        lefts: np.ndarray,
        rights: np.ndarray,
        outputs: Outputs,
        encoding: str = "mono8",
    ) -> Dict[str, Any]:
        """Process a batch of frames in ONE device dispatch (lax.scan over the
        frame axis).  This is the streaming fast path: it amortises dispatch
        latency the way the reference keeps frames in flight on CUDA streams
        (SURVEY.md §7 'streaming without host stalls').

        Args: lefts/rights (B, H, W[, C]).  Returns dict of stacked outputs
        (B leading axis).
        """
        key = ("batch", outputs.flags, encoding, self.config.stereobm,
               self.config.speckle, self.config.bilateral)
        fn = self._variants.get(key)
        if fn is None:
            bm, sp, bl = self.config.stereobm, self.config.speckle, self.config.bilateral
            mesh, axis, mode = self.mesh, self.shard_axis, self.shard_mode

            def batched(ls, rs, maps, Q):
                def step(carry, lr):
                    out = _pipeline_step(
                        lr[0], lr[1], maps, Q,
                        encoding=encoding, outputs=outputs, bm=bm, speckle=sp,
                        bilateral=bl,
                        mesh=mesh, shard_axis=axis, shard_mode=mode,
                    )
                    return carry, out

                _, outs = jax.lax.scan(step, 0, jnp.stack([ls, rs], axis=1))
                return outs

            fn = jax.jit(batched)
            self._variants[key] = fn
        if self._repl is not None and not isinstance(lefts, jax.Array):
            # mirror process(): on a process-spanning mesh the jitted step
            # needs globally-addressable (replicated) inputs, not
            # process-local host arrays
            lefts = jax.device_put(np.asarray(lefts), self._repl)
            rights = jax.device_put(np.asarray(rights), self._repl)
        return fn(jnp.asarray(lefts), jnp.asarray(rights), self._rect_maps, self._Q)

    def timed_process(self, left, right, outputs, encoding="mono8", header=None):
        """Synchronous process with wall timing — the TIMING instrumentation
        hook (reference: src/StereoProcessor.cpp:288-297).  Accumulates into
        ``self.timer`` (utils/timing.StageTimer) and returns
        (FrameResult, total_ms).  Per-stage timing of a fused jit step isn't
        meaningful (XLA fuses stages); request single-output flag-sets to
        time stages individually."""
        t0 = time.perf_counter()
        res = self.process(left, right, outputs, encoding, header)
        res.block_until_ready()
        ms = (time.perf_counter() - t0) * 1e3
        self.timer.stages[f"process[{len(outputs.flags)} outs]"].update(ms)
        return res, ms

    def timing_line(self) -> str:
        return self.timer.timing_line()

    # ------------------------------------------------------------------
    # Async publish (L2): enqueue outputs to the sender pool
    # ------------------------------------------------------------------

    def enqueue_send(self, res: FrameResult, outputs: Outputs) -> None:
        """Register async message builds for every requested output —
        the role of enqueueSendImage/Disparity/Points
        (src/GPUStereoProcessor.cpp:210-234)."""
        h = res.header
        cfg = self.config.stereobm
        H = self.model.left.calib.height
        W = self.model.left.calib.width

        def img_builder(enc):
            return lambda a: ImageMessage(h, a.shape[0], a.shape[1], enc, a)

        for name in outputs.flags:
            if name.startswith(("mono_", "rect_mono_")):
                self.senders.enqueue(name, res.outputs[name], img_builder("mono8"))
            elif name.startswith(("color_", "rect_color_")):
                self.senders.enqueue(name, res.outputs[name], img_builder("rgb8"))
            elif name == "disparity":
                self.senders.enqueue(
                    name,
                    self._wire_disparity(res.outputs["disparity"]),
                    lambda a: make_disparity_message(
                        h, a, cfg, self.model.fx, self.model.baseline, (H, W)
                    ),
                )
            elif name == "disparity_vis":
                self.senders.enqueue(name, res.outputs[name], img_builder("rgb8"))
            elif name == "pointcloud":
                arrays = (res.outputs["pointcloud_xyz"],)
                has_rgb = "pointcloud_rgb" in res.outputs
                if has_rgb:
                    arrays = arrays + (res.outputs["pointcloud_rgb"],)

                def pc_builder(xyz, rgb=None):
                    return PointCloud2Message(
                        h, xyz.shape[0], xyz.shape[1], xyz, rgb
                    )

                self.senders.enqueue(name, arrays, pc_builder)

    def _wire_disparity(self, disp):
        """Quantize disparity device-side per ``config.disparity_wire``
        before the device→host publish fetch (the message builder decodes,
        make_disparity_message) — on link-bound deployments the wire width
        IS the publish latency (fixed8 = ¼ the float bytes)."""
        wire = self.config.disparity_wire
        if wire == "float32":
            return disp
        from ros_gpu_stereo_processor_tpu.utils import msgs as _msgs

        key = ("wire", wire, self.config.stereobm.min_disparity)
        fn = self._variants.get(key)
        if fn is None:
            if wire == "fixed16":
                fn = jax.jit(_msgs.disparity_fixed16)
            else:
                md = int(self.config.stereobm.min_disparity)
                fn = jax.jit(
                    lambda d: _msgs.disparity_fixed8(d, min_disparity=md))
            self._variants[key] = fn
        return fn(disp)

    def wait_all(self) -> None:
        self.senders.wait_all()
