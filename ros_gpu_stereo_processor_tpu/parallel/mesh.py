"""Device-mesh construction helpers.

The reference has no distributed backend at all (SURVEY.md §5.8): its
"communication" is ROS pub/sub.  This engine's communication layer is
`jax.sharding.Mesh` + shard_map with XLA collectives between devices (NVLink
between the cards of one host).  Axis vocabulary:

  * ``rows``  — image row-band data parallelism for the dense frontend
    (halo exchange via ppermute),
  * ``disp``  — disparity-slab sharding of the cost volume
    (argmin-reduce via pmin),
  * ``kf``    — keyframe/map-block partitioning for distributed BA.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Tuple[str, ...] = ("rows",),
    shape: Optional[Tuple[int, ...]] = None,
) -> Mesh:
    """Build a mesh over the first ``n_devices`` available devices.

    With one axis name the mesh is 1-D over all requested devices; pass
    ``shape`` for multi-axis meshes (e.g. ``(host, chip)`` ≙ ``("kf",
    "rows")``).
    """
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs):
        raise ValueError(f"requested {n_devices} devices, have {len(devs)}")
    devs = devs[:n_devices]
    if shape is None:
        shape = (n_devices,) + (1,) * (len(axis_names) - 1)
    arr = np.asarray(devs).reshape(shape)
    return Mesh(arr, axis_names)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def row_sharded(mesh: Mesh, axis: str = "rows") -> NamedSharding:
    """(H, W[, C]) arrays split along H."""
    return NamedSharding(mesh, P(axis))
