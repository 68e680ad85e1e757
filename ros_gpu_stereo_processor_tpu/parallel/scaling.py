"""Scaling-efficiency measurement harness.

Measures the row-sharded dense frontend on sub-meshes of 1..N devices and
reports throughput and efficiency vs linear scaling.  It runs identically on
a virtual CPU mesh (CI; numbers are *not* hardware-representative there) and
on real multi-device hosts.
"""

from __future__ import annotations

import time
from typing import Dict, List

import jax
import jax.numpy as jnp
import numpy as np

from ros_gpu_stereo_processor_tpu.config import StereoBMConfig
from ros_gpu_stereo_processor_tpu.parallel.frontend import disparity_row_sharded
from ros_gpu_stereo_processor_tpu.parallel.mesh import make_mesh


def measure_scaling(
    height: int = 480,
    width: int = 752,
    cfg: StereoBMConfig = StereoBMConfig(
        num_disparities=64, block_size=15, texture_threshold=10
    ),
    device_counts: List[int] | None = None,
    batch: int = 4,
    iters: int = 3,
) -> Dict:
    """Throughput of the row-sharded matcher at each device count.

    Returns {"results": [{n, fps, ms_per_frame}], "efficiency": {n: e}}
    where e = fps(n) / (n · fps(1)), plus the wall-time ratio to the
    smallest device count (the meaningful signal on an oversubscribed
    virtual CPU mesh, where n devices add no hardware).
    """
    rng = np.random.default_rng(0)
    navail = len(jax.devices())
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16) if n <= navail]

    lefts = jnp.asarray(
        rng.integers(0, 255, (batch, height, width), np.uint8)
    )
    rights = jnp.asarray(
        rng.integers(0, 255, (batch, height, width), np.uint8)
    )

    def timed(run):
        jax.block_until_ready(run(lefts, rights))  # compile
        t0 = time.perf_counter()
        for _ in range(iters):
            jax.block_until_ready(run(lefts, rights))
        dt = (time.perf_counter() - t0) / iters
        return max(dt * 1e3, 1e-6) / batch

    results = []
    for n in device_counts:
        if height % n != 0:
            continue
        mesh = make_mesh(n, ("rows",))

        @jax.jit
        def run(ls, rs):
            def step(c, lr):
                d, v = disparity_row_sharded(lr[0], lr[1], cfg, mesh)
                return c, d.sum()

            return jax.lax.scan(step, 0, jnp.stack([ls, rs], 1))[1].sum()

        ms = timed(run)
        results.append({"n_devices": n, "ms_per_frame": round(ms, 3),
                        "fps": round(1e3 / ms, 2)})

    # baseline = the smallest measured device count (1 unless the
    # divisibility filter dropped it); eff(base) == 1.0 always
    base_entry = results[0] if results else None
    base = base_entry["fps"] if base_entry else 1.0
    base_n = base_entry["n_devices"] if base_entry else 1
    base_ms = base_entry["ms_per_frame"] if base_entry else 1.0
    eff = {
        r["n_devices"]: round(
            r["fps"] / ((r["n_devices"] / base_n) * base), 3)
        for r in results
    }
    return {"results": results, "efficiency": eff,
            f"wall_overhead_vs_{base_n}dev": {
                r["n_devices"]: round(r["ms_per_frame"] / base_ms, 3)
                for r in results}}
