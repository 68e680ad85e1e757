"""Multi-axis mesh tests — the multi-host layout (host × chip ≙ kf × rows)
exercised on the virtual CPU mesh (SURVEY.md §4 implications: CI-able
N-host sharding without a pod)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ros_gpu_stereo_processor_tpu.config import StereoBMConfig
from ros_gpu_stereo_processor_tpu.models import ba as BA
from ros_gpu_stereo_processor_tpu.ops import stereobm as bm
from ros_gpu_stereo_processor_tpu.parallel.mesh import make_mesh
from ros_gpu_stereo_processor_tpu.parallel.frontend import disparity_row_sharded
from ros_gpu_stereo_processor_tpu.parallel.dist_ba import bundle_adjust_sharded
from ros_gpu_stereo_processor_tpu.utils.io import synthetic_stereo_pair
from tests.test_ba import make_problem, _anchor


def test_2d_mesh_construction():
    mesh = make_mesh(8, ("kf", "rows"), shape=(2, 4))
    assert mesh.shape["kf"] == 2
    assert mesh.shape["rows"] == 4


def test_frontend_on_2d_mesh_submesh():
    """The dense frontend runs on the 'rows' axis of a 2-D (kf × rows) mesh
    while the same mesh's 'kf' axis carries BA — the multi-host layout."""
    mesh = make_mesh(8, ("kf", "rows"), shape=(2, 4))
    cfg = StereoBMConfig(num_disparities=32, block_size=9, texture_threshold=10)
    left, right, _ = synthetic_stereo_pair(64, 256, max_disparity=24, seed=0)
    ref_d, ref_v = bm.compute_disparity(jnp.asarray(left), jnp.asarray(right), cfg)

    d, v = disparity_row_sharded(
        jnp.asarray(left), jnp.asarray(right), cfg, mesh, axis="rows"
    )
    np.testing.assert_array_equal(np.asarray(v), np.asarray(ref_v))
    np.testing.assert_allclose(np.asarray(d), np.asarray(ref_d), atol=1e-5)


def test_ba_on_2d_mesh_kf_axis():
    mesh = make_mesh(8, ("kf", "rows"), shape=(4, 2))
    p, (R_true, t_true, pts_true) = make_problem(M=4, N=64, point_noise=0.0)
    pf, hist = bundle_adjust_sharded(p, mesh, axis="kf", iters=10,
                                     point_prior=_anchor(p))
    pf1, _ = BA.bundle_adjust(p, iters=10, point_prior=_anchor(p))
    np.testing.assert_allclose(np.asarray(pf.t), np.asarray(pf1.t), atol=1e-3)


def test_replicated_and_sharded_io_roundtrip():
    """Host-sharded device_put + collective read-back round-trips."""
    mesh = make_mesh(8, ("rows",))
    x = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    xs = jax.device_put(x, NamedSharding(mesh, P("rows")))
    assert xs.sharding.spec == P("rows")
    np.testing.assert_array_equal(np.asarray(xs), x)
    y = jax.jit(lambda a: a.sum())(xs)
    assert float(y) == x.sum()


# ---------------------------------------------------------------------------
# REAL multi-process launch: 2 CPU-backend processes × 4 virtual devices each,
# jax.distributed + gloo collectives (VERDICT item 2; BASELINE config 5's
# "N≥2 hosts" exercised without a pod).
# ---------------------------------------------------------------------------

import os
import socket
import subprocess
import sys


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_distributed():
    """Launches 2 separate processes running the sharded dense step (row-band
    halo exchange + sharded speckle over an 8-device global mesh spanning
    both processes) and distributed BA; checks both report identical
    checksums and BA convergence."""
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m",
             "ros_gpu_stereo_processor_tpu.parallel.multihost",
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(i),
             "--cpu-devices", "4"],
            env=env, cwd=repo,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        outs.append(out)
        assert p.returncode == 0, out[-2000:]
    dense = [l for o in outs for l in o.splitlines() if l.startswith("DENSE ")]
    pipe = [l for o in outs for l in o.splitlines() if l.startswith("PIPE ")]
    ba = [l for o in outs for l in o.splitlines() if l.startswith("BA ")]
    assert len(dense) == 2 and dense[0] == dense[1], dense
    # the FULL engine (StereoPipeline(mesh=…): rectify → matcher → speckle →
    # reproject) ran sharded across both processes with identical results
    assert len(pipe) == 2 and pipe[0] == pipe[1], pipe
    assert int(pipe[0].split()[2]) > 0
    assert len(ba) == 2 and ba[0] == ba[1], ba
    rms0, rms1 = (float(x) for x in ba[0].split()[1:3])
    assert rms1 < 0.1 * rms0   # distributed BA converged
    n_valid = int(dense[0].split()[2])
    assert n_valid > 0

    # record frames/s per process into the scaling artifact (VERDICT
    # round-2 item 6) — CPU-mesh numbers validate the machinery, not
    # hardware throughput
    import json

    fps = [float(l.split()[1]) for o in outs for l in o.splitlines()
           if l.startswith("FPS ")]
    assert len(fps) == 2 and all(f > 0 for f in fps), fps
    path = os.path.join(repo, "SCALING.json")
    data = json.load(open(path)) if os.path.exists(path) else {}
    data["multihost_2proc_cpu"] = {
        "note": "2 real processes x 4 virtual CPU devices, gloo collectives;"
                " sharded dense step (matcher + speckle)",
        "fps_per_process": [round(f, 2) for f in fps],
    }
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def test_host_local_rows_single_process():
    from ros_gpu_stereo_processor_tpu.parallel.multihost import (
        host_local_rows, put_row_sharded,
    )

    mesh = make_mesh(8, ("rows",))
    lo, hi = host_local_rows(mesh, "rows", 64)
    assert (lo, hi) == (0, 64)   # single process owns everything
    x = np.arange(64 * 8, dtype=np.float32).reshape(64, 8)
    arr = put_row_sharded(x[lo:hi], mesh, "rows", 64)
    assert arr.shape == (64, 8)
    np.testing.assert_array_equal(np.asarray(arr), x)
