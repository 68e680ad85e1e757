"""The full stereo SLAM engine: dense frontend + VO + keyframes + local BA +
pose graph + checkpoint/resume.

Composition layer over the rest of the stack (BASELINE.json configs 4/5):

  frame ──► StereoPipeline (rectify + disparity + speckle)
        ──► StereoVisualOdometry (features, PnP tracking)
        ──► keyframe policy ──► KeyframeStore
        ──► windowed BA (models/ba.py; landmark-sharded via
            parallel/dist_ba.py when a mesh is given)
        ──► pose graph (odometry edges; optimize_global())

Checkpoint/resume uses orbax (the reference has *no* checkpointing at all —
SURVEY.md §5.4 — its only persistent state is the calibration YAML; the SLAM
map/trajectory state here is genuinely resumable).
"""

from __future__ import annotations

import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np

from ros_gpu_stereo_processor_tpu.config import Outputs, PipelineConfig
from ros_gpu_stereo_processor_tpu.models import ba as BA
from ros_gpu_stereo_processor_tpu.models import posegraph as PG
from ros_gpu_stereo_processor_tpu.models.pipeline import StereoPipeline
from ros_gpu_stereo_processor_tpu.models.vo import StereoVisualOdometry
from ros_gpu_stereo_processor_tpu.ops import features as feat_ops
from ros_gpu_stereo_processor_tpu.utils.calib import StereoCameraModel
from ros_gpu_stereo_processor_tpu.utils.evaluate import Trajectory


def _project_so3(R: np.ndarray) -> np.ndarray:
    """Nearest rotation matrix (Frobenius) via SVD — keeps pose chains on
    SO(3) so inverse-by-transpose stays exact."""
    U, _, Vt = np.linalg.svd(R)
    S = np.diag([1.0, 1.0, float(np.sign(np.linalg.det(U @ Vt)))])
    return U @ S @ Vt


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    num_features: int = 512
    fast_threshold: float = 20.0
    keyframe_every: int = 5            # force a keyframe every N frames
    keyframe_min_translation: float = 0.15   # m
    keyframe_min_rotation: float = 0.15      # rad
    window_size: int = 5               # keyframes in the local BA window
    ba_iters: int = 6
    ba_landmarks: int = 256            # padded landmark capacity per window
    stereo_point_prior: float = 10.0   # anchors scale to stereo depth
    track_capacity: int = 4096         # persistent landmark table size
    # keyframe↔track association matches against a compact buffer of the
    # most recently seen tracks instead of the whole table (old-track
    # re-association is relocalization/loop-closure's job, each of which
    # matches the full table on its own path): 4–8× less match compute +
    # transfer per keyframe.  None = match the full table.
    assoc_capacity: int | None = 1024
    # relocalization (tracking-loss recovery): match the lost frame against
    # the persistent track store and PnP re-anchor the pose
    reloc_min_matches: int = 20
    reloc_max_rms_px: float = 3.0
    # landmarks whose post-BA reprojection rms exceeds this are killed: a
    # point on an independently-moving object cannot fit the rigid window
    # solve, so a persistently-bad residual identifies it (0 disables)
    track_reject_rms_px: float = 4.0


@dataclasses.dataclass
class Keyframe:
    stamp: float
    R_wc: np.ndarray                   # world←camera
    t_wc: np.ndarray
    kp: feat_ops.Keypoints             # device arrays (fixed capacity)
    pts_cam: np.ndarray                # (K, 3)
    pts_valid: np.ndarray              # (K,)
    track_ids: np.ndarray | None = None  # (K,) int32 — landmark id per kp slot, −1 = none
    # host copies of the kp fields the map logic reads every window (fetched
    # once at keyframe creation; None on checkpoint-restored frames)
    kp_desc_h: np.ndarray | None = None
    kp_valid_h: np.ndarray | None = None
    kp_xy_h: np.ndarray | None = None

    def desc_host(self) -> np.ndarray:
        return self.kp_desc_h if self.kp_desc_h is not None else np.asarray(self.kp.desc)

    def valid_host(self) -> np.ndarray:
        return self.kp_valid_h if self.kp_valid_h is not None else np.asarray(self.kp.valid)

    def xy_host(self) -> np.ndarray:
        return self.kp_xy_h if self.kp_xy_h is not None else np.asarray(self.kp.xy)


class TrackStore:
    """Persistent landmark tracks — the structure BA windows and the pose
    graph SHARE (round-1 re-created landmarks per window from the window
    anchor; here a landmark observed by many keyframes is ONE optimisation
    variable across every window that sees it).

    Fixed-capacity table (XLA-friendly static shapes): world position,
    latest descriptor, aliveness, bookkeeping.  Slot allocation recycles the
    least-recently-seen tracks when full.
    """

    def __init__(self, capacity: int = 4096, desc_words: int = 8):
        self.capacity = capacity
        self.pos_w = np.zeros((capacity, 3), np.float64)
        self.desc = np.zeros((capacity, desc_words), np.uint32)
        self.alive = np.zeros(capacity, bool)
        self.last_seen = np.full(capacity, -1, np.int64)
        self.n_obs = np.zeros(capacity, np.int32)
        # bumped on every mutation (under the SLAM map lock): readers that
        # snapshot the table, solve unlocked, and write back can detect a
        # concurrent mutation instead of holding the lock across a device
        # round trip (see StereoSlam._relocalize)
        self.version = 0

    def allocate(self, k: int, protect_after: int = -1) -> np.ndarray:
        """Indices of ≤k slots: dead slots first, then least-recently-seen.

        Alive slots with ``last_seen >= protect_after`` are never recycled —
        evicting a track still referenced by the current BA window would let
        the slot be respawned as a different physical landmark while window
        keyframes still hold the old id, corrupting BA observations.  May
        return fewer than k when the table is saturated with protected
        tracks (callers must size ``track_capacity ≫ window·features``)."""
        dead = np.where(~self.alive)[0]
        if len(dead) >= k:
            return dead[:k]
        evictable = self.alive & (self.last_seen < protect_after)
        evict = np.argsort(self.last_seen[evictable])  # oldest first
        evict_idx = np.where(evictable)[0][evict]
        return np.concatenate([dead, evict_idx[: k - len(dead)]])

    def to_pytree(self) -> dict:
        return {
            "pos_w": self.pos_w, "desc": self.desc, "alive": self.alive,
            "last_seen": self.last_seen, "n_obs": self.n_obs,
        }

    @classmethod
    def from_pytree(cls, d: dict) -> "TrackStore":
        ts = cls(capacity=len(np.asarray(d["alive"])))
        ts.pos_w = np.asarray(d["pos_w"])
        ts.desc = np.asarray(d["desc"]).astype(np.uint32)
        ts.alive = np.asarray(d["alive"]).astype(bool)
        ts.last_seen = np.asarray(d["last_seen"])
        ts.n_obs = np.asarray(d["n_obs"])
        return ts


class KeyframeStore:
    """Append-only host-side keyframe map (the engine's persistent state)."""

    def __init__(self):
        self.frames: list[Keyframe] = []

    def add(self, kf: Keyframe) -> None:
        self.frames.append(kf)

    def __len__(self) -> int:
        return len(self.frames)

    def window(self, size: int) -> list[Keyframe]:
        return self.frames[-size:]

    # -- checkpoint serialisation ------------------------------------------
    def to_pytree(self) -> dict:
        if not self.frames:
            return {"n": 0}
        return {
            "n": len(self.frames),
            "stamp": np.asarray([k.stamp for k in self.frames]),
            "R_wc": np.stack([k.R_wc for k in self.frames]),
            "t_wc": np.stack([k.t_wc for k in self.frames]),
            "kp_xy": np.stack([np.asarray(k.kp.xy) for k in self.frames]),
            "kp_score": np.stack([np.asarray(k.kp.score) for k in self.frames]),
            "kp_angle": np.stack([np.asarray(k.kp.angle) for k in self.frames]),
            "kp_desc": np.stack([np.asarray(k.kp.desc) for k in self.frames]),
            "kp_valid": np.stack([np.asarray(k.kp.valid) for k in self.frames]),
            "pts_cam": np.stack([k.pts_cam for k in self.frames]),
            "pts_valid": np.stack([k.pts_valid for k in self.frames]),
            "track_ids": np.stack([
                k.track_ids if k.track_ids is not None
                else np.full(k.pts_cam.shape[0], -1, np.int32)
                for k in self.frames
            ]),
        }

    @classmethod
    def from_pytree(cls, d: dict) -> "KeyframeStore":
        store = cls()
        n = int(d["n"])
        for i in range(n):
            store.add(
                Keyframe(
                    stamp=float(d["stamp"][i]),
                    R_wc=np.asarray(d["R_wc"][i]),
                    t_wc=np.asarray(d["t_wc"][i]),
                    kp=feat_ops.Keypoints(
                        xy=jnp.asarray(d["kp_xy"][i]),
                        score=jnp.asarray(d["kp_score"][i]),
                        angle=jnp.asarray(d["kp_angle"][i]),
                        desc=jnp.asarray(d["kp_desc"][i]),
                        valid=jnp.asarray(d["kp_valid"][i]),
                    ),
                    pts_cam=np.asarray(d["pts_cam"][i]),
                    pts_valid=np.asarray(d["pts_valid"][i]),
                    track_ids=(
                        np.asarray(d["track_ids"][i]).astype(np.int32)
                        if "track_ids" in d else None
                    ),
                )
            )
        return store


class StereoSlam:
    """End-to-end engine: feed stereo frames, read out a trajectory."""

    def __init__(
        self,
        model: StereoCameraModel,
        config: SlamConfig = SlamConfig(),
        pipeline_config: PipelineConfig = PipelineConfig(),
        mesh=None,
    ):
        """``mesh``: optional jax.sharding.Mesh.  A ``rows`` axis shards the
        DENSE FRONTEND (row-band halo-exchange rectify/matcher/speckle —
        StereoPipeline's mesh path); a ``kf`` axis shards windowed BA's
        landmark blocks (parallel/dist_ba).  A 2-axis ``(kf, rows)`` mesh
        runs both — BASELINE config 5's one-engine layout: the frame step
        shards over ``rows`` (replicated over ``kf``), BA psum-reduces its
        camera system over ``kf`` (replicated over ``rows``)."""
        self.model = model
        self.config = config
        self.mesh = mesh
        pipe_mesh = None
        if mesh is not None and "rows" in mesh.axis_names:
            n_rows = mesh.shape["rows"]
            if model.left.calib.height % n_rows == 0:
                pipe_mesh = mesh
        self.pipeline = StereoPipeline(
            model, pipeline_config,
            mesh=pipe_mesh,
            shard_axis="rows" if pipe_mesh is not None else None,
        )
        self.vo = StereoVisualOdometry(
            model, num_features=config.num_features,
            fast_threshold=config.fast_threshold,
        )
        self.store = KeyframeStore()
        self.tracks = TrackStore(capacity=config.track_capacity)
        self.traj_stamps: list[float] = []
        self.traj_R: list[np.ndarray] = []
        self.traj_t: list[np.ndarray] = []
        self._frames_since_kf = 0
        # keyframes DECIDED so far (== len(store) once mapping catches up);
        # under async mapping the store lags this counter by queue depth
        self._kf_count = 0
        # shared with vo.pose_lock: one lock guards pose, TrackStore and
        # KeyframeStore against the async mapping worker
        self._map_lock = self.vo.pose_lock
        # one dispatcher at a time: on a multi-device mesh every program runs
        # on all devices with collectives, and two threads enqueueing
        # concurrently can order two programs differently on different
        # devices — each then waits in a collective for the other and the
        # process aborts.  Held while device work is ENQUEUED — across a
        # fetch only in relocalization (a rare lost frame) — so host work
        # still overlaps.
        self._dispatch_lock = threading.Lock()
        # per-stage wall timing of the SLAM step (the TIMING instrumentation
        # role, src/StereoProcessor.cpp:288-297): dense = pipeline dispatch
        # (async), vo = fused VO dispatch + its batched host fetch,
        # map_host = keyframe/TrackStore numpy work + windowed BA
        from ros_gpu_stereo_processor_tpu.utils.timing import StageTimer

        self.timer = StageTimer()

    # ------------------------------------------------------------------
    def step(self, left: np.ndarray, right: np.ndarray, stamp: float = 0.0,
             encoding: str = "mono8") -> dict:
        """Process one synchronized stereo frame (synchronous: dispatch +
        complete back to back).  For throughput, :meth:`run_stream`
        pipelines the two across frames."""
        return self._complete_frame(
            self._dispatch_frame(left, right, encoding), stamp
        )

    def run_stream(self, frames, encoding: str = "mono8",
                   async_mapping: bool = False, depth: int = 2):
        """Pipelined stepping over an iterable of ``(left, right, stamp)``:
        frame t's host work (VO fetch, keyframe/TrackStore updates,
        windowed BA) runs while frames t+1..t+depth's dense+VO chains
        compute on the device — the analogue of the reference's
        compute/publish overlap (src/GpuSenderIfc.cpp:13-26), applied to
        the SLAM loop.  ``depth`` dispatched frames stay outstanding, so
        frame uploads stream ahead of the completes and the (prefetched,
        see vo._prefetch) result fetches never drain the host link.  Yields
        one info dict per frame,
        in order.

        ``async_mapping=True`` additionally moves the MAPPING work
        (TrackStore association, keyframe insertion, windowed BA) onto a
        worker thread — the classic tracking/mapping split: tracking never
        stalls on BA; BA pose corrections are applied to the live pose as
        a delta under a lock, so the trajectory stays consistent.  Mapping
        lags tracking by at most the queue depth (2 keyframes)."""
        from collections import deque

        depth = max(1, depth)
        if not async_mapping:
            pending: deque = deque()
            for left, right, stamp in frames:
                pending.append(
                    (self._dispatch_frame(left, right, encoding), stamp))
                if len(pending) > depth:
                    yield self._complete_frame(*pending.popleft())
            while pending:
                yield self._complete_frame(*pending.popleft())
            return

        import queue as _queue
        import threading

        mq: "_queue.Queue" = _queue.Queue(maxsize=2)
        err: list = []

        def mapper():
            # stays alive until the None sentinel EVEN after a failure
            # (draining the queue) — dying with a full queue would deadlock
            # the tracking thread's backpressured put / sentinel put
            while True:
                item = mq.get()
                if item is None:
                    return
                if err:
                    continue   # drain; the error is raised on the tracker
                try:
                    self._map_keyframe(*item)
                except Exception as e:  # surface on the tracking thread
                    err.append(e)

        worker = threading.Thread(target=mapper, daemon=True,
                                  name="slam-mapping")
        worker.start()
        try:
            pending = deque()
            for left, right, stamp in frames:
                if err:
                    raise err[0]
                pending.append(
                    (self._dispatch_frame(left, right, encoding), stamp))
                if len(pending) > depth:
                    yield self._complete_frame(*pending.popleft(),
                                               map_queue=mq)
            while pending:
                yield self._complete_frame(*pending.popleft(), map_queue=mq)
        finally:
            mq.put(None)
            worker.join()
        if err:
            raise err[0]

    def _dispatch_frame(self, left, right, encoding: str = "mono8"):
        """Queue one frame's dense pipeline + fused VO device work."""
        with self.timer.stage("dense"), self._dispatch_lock:
            if not isinstance(left, jax.Array):
                left = jnp.asarray(np.ascontiguousarray(left))
                right = jnp.asarray(np.ascontiguousarray(right))
            out = self.pipeline.process(
                left, right, Outputs.of("disparity", "rect_mono_left"),
                encoding=encoding,
            )
            return self.vo.dispatch(
                out.outputs["rect_mono_left"], out.outputs["disparity"]
            )

    def _complete_frame(self, pend, stamp: float, map_queue=None) -> dict:
        """Fetch one dispatched frame's results and run the host-side SLAM
        logic (pose update, relocalization, keyframing); mapping work runs
        inline, or on the mapping worker when ``map_queue`` is given."""
        with self.timer.stage("vo"):
            # the keyframe host copies ride the same batched fetch (~30 KB
            # on a round trip already being paid), so a keyframe decision
            # below costs no extra round trip
            info = self.vo.complete(pend, with_frame_host=True)
        cur = info.pop("frame")
        host = info.pop("frame_host", None)
        info["stamp"] = stamp
        info["relocalized"] = False
        if info.get("lost") and self._kf_count > 0:
            # tracking dropped: PnP re-anchor against the persistent map
            # (the reference has no failure handling at all — SURVEY.md §5.3)
            info["relocalized"] = self._relocalize(cur)
        # a lost, un-relocalized frame must not spawn keyframes (its pose is
        # a constant-velocity guess) — the trajectory still records the guess;
        # the bootstrap frame (no keyframes yet) always keyframes
        usable = (info["tracked"] or info["relocalized"]
                  or self._kf_count == 0)
        info["is_keyframe"] = usable and self._keyframe_decision(info)
        # consistent (R, t) pair: the mapping worker's BA delta write-back
        # mutates both under the lock; an unlocked pair of copies could
        # tear (post-BA R with pre-BA t) into the trajectory/keyframe
        with self._map_lock:
            info["R_wc"] = self.vo.state.R_wc.copy()
            info["t_wc"] = self.vo.state.t_wc.copy()

        self.traj_stamps.append(stamp)
        self.traj_R.append(info["R_wc"])
        self.traj_t.append(info["t_wc"])

        if info["is_keyframe"]:
            kf_index = self._kf_count
            self._kf_count += 1
            self._frames_since_kf = 0
            if host is None:
                host = self.vo.fetch_frame_host(cur)
            kf = Keyframe(
                stamp=stamp,
                R_wc=info["R_wc"].copy(),
                t_wc=info["t_wc"].copy(),
                kp=cur.kp,
                pts_cam=host["pts_cam"],
                pts_valid=host["pts_valid"],
                kp_desc_h=host["desc"],
                kp_valid_h=host["valid"],
                kp_xy_h=host["xy"],
            )
            if map_queue is None:
                self._map_keyframe(kf, kf_index)
            else:
                map_queue.put((kf, kf_index))   # backpressure at depth 2
        else:
            self._frames_since_kf += 1
        return info

    def _map_keyframe(self, kf: Keyframe, kf_index: int) -> None:
        """Mapping-side work for one keyframe: TrackStore association,
        insertion, windowed BA.  Runs inline (synchronous stepping) or on
        the mapping worker (async); shared state is mutated under
        ``self._map_lock`` (_assign_tracks does its device round trip
        before taking it, so tracking's pose updates never wait on the
        link)."""
        with self.timer.stage("map_host"):
            self._assign_tracks(kf, kf_index)
            with self._map_lock:
                self.store.add(kf)
        if kf_index >= 1:
            with self.timer.stage("ba"):
                self._local_ba()

    def _relocalize(self, cur=None) -> bool:
        """PnP re-anchor of a lost frame against the persistent track store.

        Matches the lost frame's descriptors against every alive landmark
        (one Hamming dispatch), solves world→camera PnP from the landmarks'
        WORLD positions, and overwrites the VO pose on success.  The
        constant-velocity prediction seeds the solve, so recovery works even
        after several blind frames.  ``cur``: the lost frame's TrackedFrame
        (under pipelined stepping ``vo.state.prev`` may already be a LATER
        frame, so the caller passes the frame explicitly)."""
        if cur is None:
            cur = self.vo.state.prev
        if cur is None:
            return False
        # Snapshot → solve unlocked → validate-and-write (the
        # _assign_tracks pattern): holding the map lock across the match
        # dispatch + device fetch + PnP (~a full link round trip) would
        # stall the async mapping worker on every lock acquisition.  Up to
        # 2 attempts when the mapping thread mutates the table mid-solve.
        for _ in range(2):
            with self._map_lock:
                tr = self.tracks
                if not tr.alive.any():
                    return False
                snap_version = tr.version
                snap_desc = tr.desc.copy()
                snap_alive = tr.alive.copy()
                snap_pos = tr.pos_w.copy()
                R_wc0 = self.vo.state.R_wc.copy()
                t_wc0 = self.vo.state.t_wc.copy()
            # the solve fetches in between its dispatches; the mapper only
            # waits for it on the rare lost frame
            with self._dispatch_lock:
                solved = self._relocalize_solve(
                    cur, snap_desc, snap_alive, snap_pos, R_wc0, t_wc0)
            if solved is None:
                return False
            R_cw, t_cw = solved
            with self._map_lock:
                if self.tracks.version != snap_version:
                    continue       # table changed under us — re-snapshot
                self.vo.state.R_wc = R_cw.T
                self.vo.state.t_wc = -(R_cw.T @ t_cw)
                self.vo.state.lost_frames = 0
                return True
        return False

    def _relocalize_solve(self, cur, tr_desc, tr_alive, tr_pos,
                          R_wc0, t_wc0):
        """Unlocked part of relocalization: match the lost frame against a
        track-table snapshot and PnP-solve T_c←w.  Returns (R_cw, t_cw) or
        None."""
        from ros_gpu_stereo_processor_tpu.models.vo import pnp_gauss_newton

        idx, ok = feat_ops.match_desc(
            cur.kp.desc, cur.kp.valid,
            jnp.asarray(tr_desc), jnp.asarray(tr_alive),
        )
        n = int(jnp.sum(ok))
        if n < self.config.reloc_min_matches:
            return None
        pts_w = jnp.asarray(tr_pos, jnp.float32)[jnp.maximum(idx, 0)]
        obs = cur.kp.xy
        m = self.model
        # seed from the constant-velocity prediction: T_c←w = (R_wc, t_wc)⁻¹
        R0 = jnp.asarray(R_wc0.T)
        t0 = jnp.asarray(-R_wc0.T @ t_wc0)
        fx, cx, cy = m.fx, m.left.calib.cx, m.left.calib.cy
        R, t, _ = pnp_gauss_newton(
            pts_w, obs, ok.astype(jnp.float32),
            fx=fx, cx=cx, cy=cy, R0=R0, t0=t0, iters=12,
        )
        # store matches carry more outliers than frame-to-frame tracking, so
        # gate on the INLIER count at the solved pose (the raw rms is
        # inflated by outliers even when the pose is right), then refine on
        # inliers only; full f32, since TF32 can flip a decision at the gate
        pc = jnp.matmul(pts_w, R.T, precision=jax.lax.Precision.HIGHEST) + t
        z = jnp.maximum(pc[:, 2], 1e-6)
        u = fx * pc[:, 0] / z + cx
        v = fx * pc[:, 1] / z + cy
        rn = jnp.hypot(u - obs[:, 0], v - obs[:, 1])
        inl = ok & (rn < self.config.reloc_max_rms_px) & (pc[:, 2] > 1e-3)
        if int(jnp.sum(inl)) < self.config.reloc_min_matches:
            return None
        R, t, rms = pnp_gauss_newton(
            pts_w, obs, inl.astype(jnp.float32),
            fx=fx, cx=cx, cy=cy, R0=R, t0=t, iters=8,
        )
        if float(rms) > self.config.reloc_max_rms_px:
            return None
        return np.asarray(R), np.asarray(t)

    def _keyframe_decision(self, info) -> bool:
        if self._kf_count == 0:
            return True
        if self._frames_since_kf + 1 >= self.config.keyframe_every:
            return True
        with self._map_lock:
            # async mapping lag: the distance triggers would compare against
            # a STALE newest keyframe and over-fire; fall back to the
            # counter cadence (handled above) until mapping catches up
            if len(self.store.frames) < self._kf_count:
                return False
            last = self.store.frames[-1]
            last_R, last_t = last.R_wc, last.t_wc
        dt = np.linalg.norm(info["t_wc"] - last_t)
        dR = last_R.T @ info["R_wc"]
        ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        return bool(
            dt > self.config.keyframe_min_translation
            or ang > self.config.keyframe_min_rotation
        )

    # ------------------------------------------------------------------
    def _assign_tracks(self, kf: Keyframe, kf_index: int) -> None:
        """Associate a new keyframe's keypoints with the persistent track set
        (ONE matching dispatch against the whole table), spawning tracks for
        unmatched keypoints with valid stereo depth.  This is what makes BA
        windows share structure: a landmark seen by many keyframes is one
        table slot, not a per-window copy."""
        tr = self.tracks
        kp_desc = kf.desc_host()
        kp_valid = kf.valid_host()
        K = kp_desc.shape[0]
        track_ids = np.full(K, -1, np.int32)

        # the match (device dispatch + fetch round trip) runs OUTSIDE the
        # map lock: the mapping thread is the only writer of the track
        # table, so its own read snapshot is stable; only the mutations
        # below need the lock (vs the tracker's relocalization reads)
        idx = ok = None
        # timed as its own stage: map_host − map_match = the pure-numpy
        # bookkeeping; map_match is the device match dispatch + fetch (a
        # link round trip on remote transports, compute-only when attached)
        if tr.alive.any():
            with self.timer.stage("map_match"):
                idx, ok = self._match_recent(kf, tr)
        with self._map_lock:
            self._apply_track_assignment(
                kf, kf_index, track_ids, kp_desc, kp_valid, idx, ok)

    def _match_recent(self, kf: Keyframe, tr: TrackStore):
        """Match a keyframe's descriptors against the track table, using a
        compact buffer of the ``assoc_capacity`` most recently seen alive
        tracks when the table is larger (fixed buffer size → one compiled
        match variant; 4–8× less match compute + transfer than the full
        table).  Returns (global_track_idx, ok) host arrays."""
        A = self.config.assoc_capacity
        if A is not None and A < tr.capacity:
            cand = np.where(tr.alive)[0]
            if cand.size > A:
                cand = cand[np.argsort(-tr.last_seen[cand],
                                       kind="stable")[:A]]
            sub_desc = np.zeros((A, tr.desc.shape[1]), tr.desc.dtype)
            sub_alive = np.zeros(A, bool)
            sub_desc[: cand.size] = tr.desc[cand]
            sub_alive[: cand.size] = True
            with self._dispatch_lock:
                idx_d, ok_d = feat_ops.match_desc(
                    kf.kp.desc, kf.kp.valid,
                    jnp.asarray(sub_desc), jnp.asarray(sub_alive),
                )
            idx, ok = (np.asarray(a)
                       for a in jax.device_get((idx_d, ok_d)))
            # map buffer slots back to global track ids
            pad = np.full(A, -1, np.int64)
            pad[: cand.size] = cand
            idx = pad[np.maximum(idx, 0)].astype(np.int32)
            ok = ok & (idx >= 0)
            return idx, ok
        with self._dispatch_lock:
            idx_d, ok_d = feat_ops.match_desc(
                kf.kp.desc, kf.kp.valid,
                jnp.asarray(tr.desc), jnp.asarray(tr.alive),
            )
        return tuple(np.asarray(a) for a in jax.device_get((idx_d, ok_d)))

    def _apply_track_assignment(self, kf, kf_index, track_ids, kp_desc,
                                kp_valid, idx, ok) -> None:
        tr = self.tracks
        if idx is not None:
            track_ids[ok] = idx[ok]
            tr.last_seen[idx[ok]] = kf_index
            tr.n_obs[idx[ok]] += 1
            tr.desc[idx[ok]] = kp_desc[ok]       # drift with appearance

        new_mask = (track_ids < 0) & kp_valid & kf.pts_valid
        n_new = int(new_mask.sum())
        if n_new:
            # never recycle a slot the current BA window may still observe
            slots = tr.allocate(
                n_new, protect_after=kf_index - self.config.window_size
            )
            n_new = len(slots)
            recycled = slots[tr.alive[slots]]
            if recycled.size:
                # stale ids in older stored keyframes must not alias the
                # respawned landmark (used by optimize_global's correction).
                # One boolean LUT + fancy index per keyframe (id −1 lands on
                # the extra always-False slot) — np.isin per keyframe sorts
                # and was the store-size-proportional cost here.
                hit = np.zeros(tr.capacity + 1, bool)
                hit[recycled] = True
                for old_kf in self.store.frames:
                    tid = old_kf.track_ids
                    if tid is not None:
                        tid[hit[tid]] = -1
            sel = np.where(new_mask)[0][:n_new]
            world = (kf.R_wc @ kf.pts_cam[sel].T).T + kf.t_wc
            tr.pos_w[slots] = world
            tr.desc[slots] = kp_desc[sel]
            tr.alive[slots] = True
            tr.last_seen[slots] = kf_index
            tr.n_obs[slots] = 1
            track_ids[sel] = slots
        kf.track_ids = track_ids
        tr.version += 1

    def _window_problem(self, win: list):
        """Build the BA problem over the window from persistent tracks:
        landmarks = tracks observed by ≥2 window keyframes (most-observed
        first, up to the padded capacity)."""
        cfg = self.config
        M = len(win)
        N = cfg.ba_landmarks
        ids = np.concatenate([k.track_ids for k in win])
        ids = ids[ids >= 0]
        if ids.size == 0:
            return None
        counts = np.bincount(ids, minlength=self.tracks.capacity)
        cand = np.where(counts >= 2)[0]
        if cand.size < 8:
            return None
        cand = cand[np.argsort(-counts[cand])][:N]
        n_eff = len(cand)
        # landmark slot lookup: track id → [0, n_eff)
        lut = np.full(self.tracks.capacity, -1, np.int32)
        lut[cand] = np.arange(n_eff, dtype=np.int32)

        pts_w = np.zeros((N, 3), np.float64)
        pts_w[:n_eff] = self.tracks.pos_w[cand]
        pts_w[n_eff:, 2] = 1.0                   # benign padding depth
        obs = np.zeros((M, N, 2), np.float32)
        mask = np.zeros((M, N), np.float32)
        for m, kf in enumerate(win):
            kp_xy = kf.xy_host()
            has = kf.track_ids >= 0
            slot = np.where(has, lut[np.maximum(kf.track_ids, 0)], -1)
            use = slot >= 0
            obs[m, slot[use]] = kp_xy[use]
            mask[m, slot[use]] = 1.0
        return cand, pts_w, obs, mask, n_eff

    def _local_ba(self) -> None:
        """Windowed BA over the persistent track set: every track observed by
        ≥2 window keyframes is one shared optimisation variable; refined
        positions are written back to the table so the NEXT window (and the
        pose graph) starts from them."""
        cfg = self.config
        # build under the map lock (window poses + track table snapshot);
        # the SOLVE below runs unlocked so async tracking never waits on it
        with self._map_lock:
            win = self.store.window(cfg.window_size)
            M = len(win)
            if M < 2:
                return
            built = self._window_problem(win)
            if built is None:
                return
            cand, pts_w, obs, mask, n_eff = built

            # world→camera poses
            R_cw = np.stack([k.R_wc.T for k in win])
            t_cw = np.stack([-(k.R_wc.T @ k.t_wc) for k in win])
            # pre-solve pose of the newest keyframe: the correction delta
            # below is computed against it
            R_kf_old = win[-1].R_wc.copy()
            t_kf_old = win[-1].t_wc.copy()
        N = cfg.ba_landmarks

        with self._dispatch_lock:
            p = BA.BAProblem(
                R=jnp.asarray(R_cw), t=jnp.asarray(t_cw),
                points=jnp.asarray(pts_w), obs=jnp.asarray(obs),
                mask=jnp.asarray(mask),
                fx=self.model.fx, cx=self.model.left.calib.cx,
                cy=self.model.left.calib.cy,
            )
            lm_valid = np.zeros((N,), np.float32)
            lm_valid[:n_eff] = 1.0
            prior = jnp.asarray(cfg.stereo_point_prior * lm_valid)
            if (self.mesh is not None and "kf" in self.mesh.axis_names
                    and N % self.mesh.shape["kf"] == 0):
                from ros_gpu_stereo_processor_tpu.parallel.dist_ba import (
                    bundle_adjust_sharded,
                )

                pf, _ = bundle_adjust_sharded(
                    p, self.mesh, iters=cfg.ba_iters, point_prior=prior
                )
            else:
                pf, _ = BA.bundle_adjust(p, iters=cfg.ba_iters,
                                         point_prior=prior)

            # per-landmark reprojection rms at the solution: a landmark that
            # cannot fit the rigid window solve (independently-moving
            # object, bad triangulation) is identified by a persistently
            # large residual and purged from the map below
            r_dev, _ = BA.reprojection_residuals(pf)
            rn2 = jnp.sum(r_dev * r_dev, -1)
            lm_rms = jnp.sqrt(jnp.sum(rn2 * p.mask, 0)
                              / jnp.maximum(jnp.sum(p.mask, 0), 1.0))

        # write back refined keyframe poses (world←camera) AND track
        # positions — one batched fetch for the four solution arrays
        Rf, tf, pts_f, lm_rms_h = (np.asarray(a) for a in
                                   jax.device_get((pf.R, pf.t, pf.points,
                                                   lm_rms)))
        with self._map_lock:
            for m, kf in enumerate(win):
                # project onto SO(3): the solver's rotations carry small
                # non-orthogonality which the delta re-anchor below would
                # otherwise COMPOUND quadratically (R_oldᵀ is only an
                # inverse for orthogonal R_old — unprojected, pose norms
                # square on every BA and overflow within ~20 windows)
                kf.R_wc = _project_so3(Rf[m].T)
                kf.t_wc = -(kf.R_wc @ tf[m])
            self.tracks.pos_w[cand] = pts_f[:n_eff]
            rej = cfg.track_reject_rms_px
            if rej > 0:
                bad = cand[lm_rms_h[:n_eff] > rej]
                if bad.size:
                    # purge: kill the table slots and unlink the ids from
                    # the window keyframes so the next window build doesn't
                    # resurrect them from stale observations
                    self.tracks.alive[bad] = False
                    hit = np.zeros(self.tracks.capacity + 1, bool)
                    hit[bad] = True
                    for kf in win:
                        if kf.track_ids is not None:
                            kf.track_ids[hit[kf.track_ids]] = -1
            self.tracks.version += 1
            # re-anchor the live VO pose: apply the newest keyframe's
            # pre→post-BA correction as a DELTA to the current pose.  In
            # synchronous stepping the current pose IS the keyframe pose,
            # so this reduces to the plain overwrite; under async mapping
            # tracking may have advanced — the delta preserves the motion
            # composed since the keyframe.
            R_old = _project_so3(R_kf_old)
            dR = win[-1].R_wc @ R_old.T
            dt = win[-1].t_wc - dR @ t_kf_old
            self.vo.state.R_wc = _project_so3(dR @ self.vo.state.R_wc)
            self.vo.state.t_wc = dR @ self.vo.state.t_wc + dt

    # ------------------------------------------------------------------
    def detect_loop_closures(
        self,
        min_separation: int = 4,
        min_matches: int = 30,
        max_rms_px: float = 2.0,
        max_candidates: int = 32,
    ) -> list[tuple[int, int, np.ndarray, np.ndarray]]:
        """Appearance-based loop closure, batched for large keyframe stores.

        Three device dispatches regardless of store size K (the round-1
        version looped O(K²) host-side with one dispatch per pair):

          1. **candidate scoring** — per-keyframe bit-frequency signatures
             (feat_ops.descriptor_signature, vmapped) and ONE (K × K) cosine
             matmul; pairs separated by ≥ ``min_separation`` keyframes keep
             their score, the top ``max_candidates`` go forward;
          2. **batched matching** — ``match_desc`` vmapped over the stacked
             candidate pairs (mutual-NN Hamming in one dispatch);
          3. **batched PnP** — Gauss-Newton verification vmapped over every
             pair that has ≥ ``min_matches`` matches.

        Returns (i, j, R_ij, t_ij) relative-pose measurements (pose of j in
        i's frame) for pairs passing the ``max_rms_px`` gate."""
        import jax

        from ros_gpu_stereo_processor_tpu.models.vo import pnp_gauss_newton

        frames = self.store.frames
        K = len(frames)
        if K < min_separation + 1:
            return []
        m = self.model
        desc = jnp.stack([f.kp.desc for f in frames])        # (K, F, 8)
        kvalid = jnp.stack([f.kp.valid for f in frames])     # (K, F)
        xy = jnp.stack([f.kp.xy for f in frames])            # (K, F, 2)
        pts = jnp.asarray(np.stack([f.pts_cam for f in frames]), jnp.float32)
        pvalid = jnp.asarray(np.stack([f.pts_valid for f in frames]))

        # 1) appearance similarity: (K, 256) signatures → (K, K) cosine
        sigs = jax.vmap(feat_ops.descriptor_signature)(desc, kvalid)
        sim = np.asarray(sigs @ sigs.T)
        ii = np.arange(K)[:, None]
        jj = np.arange(K)[None, :]
        scores = np.where(jj - ii >= min_separation, sim, -np.inf)
        order = np.argsort(scores.ravel())[::-1][:max_candidates]
        order = order[np.isfinite(scores.ravel()[order])]
        if order.size == 0:
            return []
        ci = (order // K).astype(np.int32)
        cj = (order % K).astype(np.int32)

        # 2) one dispatch: mutual-NN matching over all candidate pairs
        idx, ok = jax.vmap(feat_ops.match_desc)(
            desc[ci], kvalid[ci], desc[cj], kvalid[cj]
        )
        ok = ok & pvalid[ci]
        counts = np.asarray(jnp.sum(ok, axis=1))
        keep = np.where(counts >= min_matches)[0]
        if keep.size == 0:
            return []
        ki, kj = ci[keep], cj[keep]

        # 3) one dispatch: PnP verification (points of the OLDER keyframe i
        # observed in the NEWER j) over all surviving pairs
        obs = jnp.take_along_axis(
            xy[kj], jnp.maximum(idx[keep], 0)[..., None], axis=1
        )
        w = ok[keep].astype(jnp.float32)
        fx, cx, cy = m.fx, m.left.calib.cx, m.left.calib.cy

        def one_pnp(p, o, wt):
            return pnp_gauss_newton(
                p, o, wt, fx=fx, cx=cx, cy=cy,
                R0=jnp.eye(3), t0=jnp.zeros(3), iters=12,
            )

        R, t, _ = jax.vmap(one_pnp)(pts[ki], obs, w)

        # cross-keyframe match sets carry outliers that inflate the raw rms
        # even when the pose is right (same issue as _relocalize): gate on
        # the INLIER count at the solved pose, refine on inliers, then gate
        # the refined rms (full f32: TF32 can flip a decision at the gate)
        pc = jnp.einsum("kij,knj->kni", R, pts[ki],
                        precision=jax.lax.Precision.HIGHEST) + t[:, None]
        z = jnp.maximum(pc[..., 2], 1e-6)
        u = fx * pc[..., 0] / z + cx
        v_ = fx * pc[..., 1] / z + cy
        rn = jnp.hypot(u - obs[..., 0], v_ - obs[..., 1])
        inl = (w > 0) & (rn < max_rms_px) & (pc[..., 2] > 1e-3)
        n_inl = np.asarray(jnp.sum(inl, axis=1))

        def refine(p, o, wt, R0, t0):
            return pnp_gauss_newton(p, o, wt, fx=fx, cx=cx, cy=cy,
                                    R0=R0, t0=t0, iters=8)

        R, t, rms = jax.vmap(refine)(
            pts[ki], obs, inl.astype(jnp.float32), R, t)
        R, t, rms = np.asarray(R), np.asarray(t), np.asarray(rms)

        closures = []
        for n in range(len(keep)):
            if n_inl[n] < min_matches or rms[n] > max_rms_px:
                continue
            # PnP gives T_j←i (points of i seen in j) ⇒ T_ij = inverse
            R_ij, t_ij = R[n].T, -(R[n].T @ t[n])
            closures.append((int(ki[n]), int(kj[n]), R_ij, t_ij))
        closures.sort(key=lambda c: (c[0], c[1]))
        return closures

    def optimize_global(self, iters: int = 10,
                        with_loop_closures: bool = True) -> int:
        """Pose-graph optimisation over all keyframes: odometry edges plus
        geometrically-verified loop closures.  Returns the number of closure
        edges used."""
        if len(self.store) < 3:
            return 0
        R = jnp.asarray(np.stack([k.R_wc for k in self.store.frames]))
        t = jnp.asarray(np.stack([k.t_wc for k in self.store.frames]))
        ei, ej, Rm, tm, w = PG.odometry_edges(R, t)
        n_closures = 0
        if with_loop_closures:
            for (i, j, R_ij, t_ij) in self.detect_loop_closures():
                ei = jnp.append(ei, i).astype(jnp.int32)
                ej = jnp.append(ej, j).astype(jnp.int32)
                Rm = jnp.concatenate([Rm, jnp.asarray(R_ij)[None]])
                tm = jnp.concatenate([tm, jnp.asarray(t_ij)[None]])
                w = jnp.append(w, 5.0)       # closures outweigh odometry
                n_closures += 1
        g = PG.PoseGraph(R=R, t=t, edge_i=ei, edge_j=ej,
                         R_meas=Rm, t_meas=tm, weight=w)
        old = [(k.R_wc.copy(), k.t_wc.copy(), k.stamp)
               for k in self.store.frames]
        gf, _ = PG.optimize_pose_graph(g, iters=iters)
        Rf, tf = np.asarray(gf.R), np.asarray(gf.t)
        for i, kf in enumerate(self.store.frames):
            kf.R_wc, kf.t_wc = Rf[i], tf[i]

        # propagate the correction to the per-frame trajectory: each frame is
        # rigidly attached to its most recent keyframe — apply that
        # keyframe's pose delta (T_new ∘ T_old⁻¹)
        kf_stamps = np.asarray([s for (_, _, s) in old])
        for fi, stamp in enumerate(self.traj_stamps):
            ki = int(np.searchsorted(kf_stamps, stamp, side="right")) - 1
            if ki < 0:
                continue
            R_old, t_old, _ = old[ki]
            dR = Rf[ki] @ R_old.T
            dt = tf[ki] - dR @ t_old
            self.traj_R[fi] = dR @ self.traj_R[fi]
            self.traj_t[fi] = dR @ self.traj_t[fi] + dt
        # persistent tracks ride their last-observing keyframe's correction
        alive = np.where(self.tracks.alive)[0]
        if alive.size:
            ki = np.clip(self.tracks.last_seen[alive], 0, len(old) - 1)
            for k in np.unique(ki):
                R_old, t_old, _ = old[int(k)]
                dR = Rf[int(k)] @ R_old.T
                dt = tf[int(k)] - dR @ t_old
                sel = alive[ki == k]
                self.tracks.pos_w[sel] = (dR @ self.tracks.pos_w[sel].T).T + dt
            self.tracks.version += 1
        # live VO pose rides the newest keyframe too
        R_old, t_old, _ = old[-1]
        dR = Rf[-1] @ R_old.T
        dt = tf[-1] - dR @ t_old
        self.vo.state.R_wc = dR @ self.vo.state.R_wc
        self.vo.state.t_wc = dR @ self.vo.state.t_wc + dt
        return n_closures

    # ------------------------------------------------------------------
    def trajectory(self) -> Trajectory:
        return Trajectory(
            stamps=np.asarray(self.traj_stamps),
            t=np.stack(self.traj_t) if self.traj_t else np.zeros((0, 3)),
            R=np.stack(self.traj_R) if self.traj_R else None,
        )

    # ------------------------------------------------------------------
    # Checkpoint / resume (orbax; SURVEY.md §5.4 — absent in the reference)
    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        import orbax.checkpoint as ocp

        state = {
            "store": self.store.to_pytree(),
            "tracks": self.tracks.to_pytree(),
            "traj_stamps": np.asarray(self.traj_stamps),
            "traj_R": np.stack(self.traj_R) if self.traj_R else np.zeros((0, 3, 3)),
            "traj_t": np.stack(self.traj_t) if self.traj_t else np.zeros((0, 3)),
            "vo_R": self.vo.state.R_wc,
            "vo_t": self.vo.state.t_wc,
        }
        ckptr = ocp.PyTreeCheckpointer()
        ckptr.save(os.path.abspath(path), state, force=True)

    def load_checkpoint(self, path: str) -> None:
        import orbax.checkpoint as ocp

        ckptr = ocp.PyTreeCheckpointer()
        state = ckptr.restore(os.path.abspath(path))
        self.store = KeyframeStore.from_pytree(state["store"])
        self._kf_count = len(self.store)
        if "tracks" in state:
            self.tracks = TrackStore.from_pytree(state["tracks"])
        self.traj_stamps = list(np.asarray(state["traj_stamps"]))
        self.traj_R = list(np.asarray(state["traj_R"]))
        self.traj_t = list(np.asarray(state["traj_t"]))
        self.vo.reset()
        self.vo.state.R_wc = np.asarray(state["vo_R"])
        self.vo.state.t_wc = np.asarray(state["vo_t"])
