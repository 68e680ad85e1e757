"""Multi-host runtime: jax.distributed init + process-spanning meshes +
host-local frame feeding.

The reference is strictly single-process/single-GPU (SURVEY.md §5.8 — its
only "communication" is ROS pub/sub).  This engine's multi-host story:

  * :func:`initialize` — one call per process wires the JAX distributed
    runtime (coordinator rendezvous); after it, ``jax.devices()`` spans every
    host's devices and pjit/shard_map collectives ride the intra-host device
    links within a host and the network across hosts.
  * :func:`global_mesh` — a Mesh over the *global* device list, e.g.
    ``("kf", "rows")`` = host-level keyframe partitioning × per-host row
    bands (the layout of SURVEY.md §7 step 7).
  * :func:`host_local_rows` / :func:`put_row_sharded` — host-local frame
    ingest: each process stages only the row band its own devices own
    (through the native FrameRing), and
    ``jax.make_array_from_process_local_data`` assembles the global sharded
    array without any cross-host copy of pixel data.

CI story (SURVEY.md §4 implications): everything here runs on CPU-backend
processes — ``initialize(..., cpu_devices_per_process=N)`` forces an
N-device virtual CPU "chip set" per process and gloo collectives, so
N-host sharding logic is exercised by ``tests/test_multihost.py`` launching
real separate processes (no multi-host cluster needed).  Run a worker by
hand:

    python -m ros_gpu_stereo_processor_tpu.parallel.multihost \
        --coordinator 127.0.0.1:9991 --num-processes 2 --process-id 0 \
        --cpu-devices 4
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

import numpy as np


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    cpu_devices_per_process: Optional[int] = None,
) -> None:
    """Initialise the JAX distributed runtime for this process.

    On a real cluster, pass the coordinator address, process count and
    process id: nothing in the environment supplies them.
    ``cpu_devices_per_process`` switches to the CPU backend with that many
    virtual devices and gloo cross-process collectives — the CI
    configuration.
    """
    import jax

    if cpu_devices_per_process is not None:
        jax.config.update("jax_platforms", "cpu")
        try:
            jax.config.update("jax_num_cpu_devices", int(cpu_devices_per_process))
        except RuntimeError:
            # a backend is already initialised in this process: the
            # launcher must pass
            # XLA_FLAGS=--xla_force_host_platform_device_count=N instead,
            # which the CPU client reads at its own (lazy) init
            flags = os.environ.get("XLA_FLAGS", "")
            if "xla_force_host_platform_device_count" not in flags:
                raise RuntimeError(
                    "cannot set jax_num_cpu_devices (backends already "
                    "initialised) and XLA_FLAGS does not force a CPU device "
                    "count — launch with XLA_FLAGS="
                    f"--xla_force_host_platform_device_count={cpu_devices_per_process}"
                )
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    if jax.distributed.is_initialized():
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(axis_names: Tuple[str, ...], shape: Optional[Tuple[int, ...]] = None):
    """Mesh over the global (all-process) device list.

    Default 2-axis shape puts processes on the first axis and each process's
    local devices on the second — host-level partitioning × chip-level
    sharding (e.g. ``("kf", "rows")``), so first-axis collectives cross the
    network and second-axis collectives stay on the intra-host links.
    """
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    if shape is None:
        if len(axis_names) == 1:
            shape = (len(devs),)
        elif len(axis_names) == 2:
            shape = (jax.process_count(), len(devs) // jax.process_count())
        else:
            raise ValueError("pass an explicit shape for >2 mesh axes")
    arr = np.asarray(devs).reshape(shape)
    return Mesh(arr, axis_names)


def host_local_rows(mesh, axis: str, total_rows: int) -> Tuple[int, int]:
    """[start, stop) row range of the bands owned by THIS process's devices
    along mesh axis ``axis`` — what the host-local camera feed must stage."""
    import jax

    n = mesh.shape[axis]
    if total_rows % n:
        raise ValueError(f"rows={total_rows} not divisible by {axis}={n}")
    band = total_rows // n
    pid = jax.process_index()
    # mesh devices along `axis`, in order; find bands owned by this process
    ax = mesh.axis_names.index(axis)
    dev_grid = np.moveaxis(mesh.devices, ax, 0)
    lo, hi = None, None
    for i in range(n):
        if any(d.process_index == pid for d in np.ravel(dev_grid[i])):
            lo = i if lo is None else lo
            hi = i
    if lo is None:
        return 0, 0
    return lo * band, (hi + 1) * band


def put_row_sharded(local_rows: np.ndarray, mesh, axis: str, total_rows: int):
    """Assemble a globally row-sharded device array from this process's
    local row band (no cross-host pixel copy)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    spec = [None] * local_rows.ndim
    spec[0] = axis
    sharding = NamedSharding(mesh, P(*spec))
    global_shape = (total_rows,) + tuple(local_rows.shape[1:])
    return jax.make_array_from_process_local_data(
        sharding, np.ascontiguousarray(local_rows), global_shape
    )


# ---------------------------------------------------------------------------
# CI worker: one process of an N-process CPU "pod" running the sharded dense
# step + distributed BA, printing checksums for the launcher to cross-check.
# ---------------------------------------------------------------------------


def _worker(args) -> int:
    initialize(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        cpu_devices_per_process=args.cpu_devices,
    )
    import jax
    import jax.numpy as jnp

    from ros_gpu_stereo_processor_tpu.config import StereoBMConfig
    from ros_gpu_stereo_processor_tpu.parallel.frontend import (
        disparity_row_sharded, filter_speckles_row_sharded,
    )
    from ros_gpu_stereo_processor_tpu.runtime import FrameRing

    assert jax.process_count() == args.num_processes
    mesh = global_mesh(("rows",))
    H, W = args.rows, args.width
    cfg = StereoBMConfig(num_disparities=args.ndisp, block_size=args.block,
                         texture_threshold=5)
    spk = args.speckle_size

    # host-local feed: stage ONLY this process's row band through the native
    # ring (the reference's pinned staging buffers, SURVEY.md §2.2/§2.4)
    rng = np.random.default_rng(0)   # same stream everywhere; slice locally
    left = rng.integers(0, 255, (H, W), np.uint8)
    right = rng.integers(0, 255, (H, W), np.uint8)
    lo, hi = host_local_rows(mesh, "rows", H)
    ring = FrameRing(2, (hi - lo, W))
    ring.push(left[lo:hi], right[lo:hi])
    l_loc, r_loc, _, _ = ring.peek()
    l_dev = put_row_sharded(l_loc, mesh, "rows", H)
    r_dev = put_row_sharded(r_loc, mesh, "rows", H)
    ring.release()

    @jax.jit
    def step(l, r):
        d, v = disparity_row_sharded(l, r, cfg, mesh)
        d, v = filter_speckles_row_sharded(
            d, v, mesh, max_speckle_size=spk, max_diff=1.0, iters=8,
            merge_rounds=2,
        )
        return jnp.sum(jnp.where(v, d, 0.0)), jnp.sum(v)

    s, nv = step(l_dev, r_dev)
    print(f"DENSE {float(s):.3f} {int(nv)}", flush=True)

    # frames/s of the jointly-computed sharded step (each process reports its
    # own wall clock over the same SPMD program) — recorded by the 2-process
    # test into SCALING.json (VERDICT round-2 item 6)
    import time as _time

    for _ in range(2):
        jax.block_until_ready(step(l_dev, r_dev))
    fps_iters = args.fps_iters
    t0 = _time.perf_counter()
    out = None
    for _ in range(fps_iters):
        out = step(l_dev, r_dev)
    jax.block_until_ready(out)
    fps = fps_iters / (_time.perf_counter() - t0)
    print(f"FPS {fps:.2f}", flush=True)

    # full engine across both hosts: StereoPipeline(mesh=global) runs the
    # whole demand DAG (rectify → matcher → speckle → reproject) sharded
    from ros_gpu_stereo_processor_tpu.config import (
        Outputs, PipelineConfig, SpeckleConfig,
    )
    from ros_gpu_stereo_processor_tpu.models.pipeline import StereoPipeline
    from ros_gpu_stereo_processor_tpu.utils.calib import (
        CameraCalib, StereoCameraModel,
    )

    K = np.array([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1.0]])
    P3 = np.hstack([K, np.zeros((3, 1))])
    Pr = P3.copy()
    Pr[0, 3] = -8.0
    mk = lambda PP, nm: CameraCalib(W, H, K, np.zeros(5), np.eye(3), PP, nm)
    model = StereoCameraModel.from_calibs(mk(P3, "left"), mk(Pr, "right"))
    pipe = StereoPipeline(
        model,
        PipelineConfig(
            stereobm=cfg,
            speckle=SpeckleConfig(max_speckle_size=spk, max_diff=1.0,
                                  propagation_iters=8),
        ),
        mesh=mesh,
    )
    res = pipe.process(left, right, Outputs.of("disparity", "pointcloud"))
    res.block_until_ready()
    d = res.outputs["disparity"]
    v = res.outputs["disparity_valid"]
    import jax.numpy as jnp3

    ps = float(jnp3.sum(jnp3.where(v, d, 0.0)))
    pn = int(jnp3.sum(v))
    print(f"PIPE {ps:.3f} {pn}", flush=True)

    # distributed BA over a ("kf",) mesh spanning both hosts
    from ros_gpu_stereo_processor_tpu.models.ba import BAProblem
    from ros_gpu_stereo_processor_tpu.parallel.dist_ba import bundle_adjust_sharded
    from ros_gpu_stereo_processor_tpu.utils import lie

    kf_mesh = global_mesh(("kf",))
    n_dev = len(jax.devices())
    Mp, Np = 3, 8 * n_dev
    pts = rng.uniform([-2, -2, 4], [2, 2, 10], (Np, 3))
    xs = rng.normal(0, 0.05, (Mp, 6))
    xs[0] = 0
    Rs, ts = (np.asarray(a) for a in lie.se3_exp(jnp.asarray(xs)))
    pc = np.einsum("mij,nj->mni", Rs, pts) + ts[:, None]
    obs = np.stack(
        [400.0 * pc[..., 0] / pc[..., 2] + 320.0,
         400.0 * pc[..., 1] / pc[..., 2] + 240.0], -1)
    prob = BAProblem(
        R=jnp.asarray(Rs), t=jnp.asarray(ts),
        points=jnp.asarray(pts + rng.normal(0, 0.05, pts.shape)),
        obs=jnp.asarray(obs), mask=jnp.ones((Mp, Np)),
        fx=400.0, cx=320.0, cy=240.0,
    )
    pf, hist = bundle_adjust_sharded(prob, kf_mesh, iters=3)
    jax.block_until_ready(hist)
    print(f"BA {float(hist[0]):.4f} {float(hist[-1]):.4f}", flush=True)
    jax.distributed.shutdown()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="multi-host CI worker")
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--cpu-devices", type=int, default=4)
    ap.add_argument("--rows", type=int, default=64)
    ap.add_argument("--width", type=int, default=96)
    ap.add_argument("--ndisp", type=int, default=16)
    ap.add_argument("--block", type=int, default=5)
    ap.add_argument("--speckle-size", type=int, default=8)
    ap.add_argument("--fps-iters", type=int, default=10)
    args = ap.parse_args(argv)
    return _worker(args)


if __name__ == "__main__":
    raise SystemExit(main())
