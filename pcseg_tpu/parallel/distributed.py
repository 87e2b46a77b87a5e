"""Multi-host (multi-process) execution support — BASELINE config 5.

The reference is single-threaded C++ with no distributed story (SURVEY.md
§5); this is the rebuild's novel mandate: the same column-sharded
segmentation step (parallel/sharded.py) running over a mesh that spans
*processes* (hosts), with halos riding the device interconnect within a
host and the network across hosts — all through the standard JAX runtime
(jax.distributed + global jax.Array), no custom transport.

Usage on each host of an N-host job::

    from pcseg_tpu.parallel import distributed, sharded
    distributed.initialize()                  # reads JAX_COORDINATOR etc.
    mesh = distributed.make_global_mesh()     # all devices, every host
    step = sharded.build_sharded_segment_step(mesh)
    pts_g = distributed.host_local_to_global(mesh, P(None, "space", None),
                                             pts_local_cols)
    out = step(pts_g, origin)                 # halos cross hosts

Tested with a 2-process CPU job over localhost (tests/test_multihost.py) —
the standard JAX trick for validating process-spanning meshes without a
cluster (SURVEY.md §4).
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Bring up the multi-process JAX runtime (idempotent).

    Arguments default from the standard env vars (JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID); on GPU hosts nothing infers them,
    so pass all three (the coordinator may be ``localhost:<port>``).
    Returns True when running multi-process after the call.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        env = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("JAX_PROCESS_ID")
        process_id = int(env) if env else None
    if coordinator_address is None and num_processes is None:
        # single-process run: nothing to bring up
        return False
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except RuntimeError as e:
        # idempotence: a second call in the same process is a no-op
        if "already" not in str(e) and "once" not in str(e):
            raise
    return jax.process_count() > 1


def make_global_mesh(axis_name: str = "space",
                     n_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over ALL devices of the job (every process), in device-id
    order — the multi-host generalization of sharded.make_mesh."""
    devs = sorted(jax.devices(), key=lambda d: d.id)
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]).reshape(n), (axis_name,))


def host_local_to_global(mesh: Mesh, spec: P, local_data) -> jax.Array:
    """Assemble a global jax.Array from each process's slice of the data.

    ``local_data`` is this process's contiguous chunk along the sharded
    axes (e.g. its columns of the [H, W] grid); the result is a global
    array laid out per ``spec`` over ``mesh`` that shard_map programs can
    consume directly.
    """
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_process_local_data(sharding, local_data)


def global_to_host_replicated(x) -> np.ndarray:
    """Fetch a (possibly process-spanning) jax.Array fully to every host.

    The sharded step's outputs are replicated (out_specs P()), which numpy
    can read directly on any host; sharded arrays take a cross-host
    allgather."""
    if jax.process_count() == 1 or getattr(x, "is_fully_replicated", True):
        return np.asarray(x)
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(x, tiled=True))
