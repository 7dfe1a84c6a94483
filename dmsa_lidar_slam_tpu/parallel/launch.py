"""Multi-process launch helpers.

One process can drive every card of a host: JAX sees all local GPUs, and
`Mesh`/`shard_map` collectives run over NCCL, on NVLink between the cards
of one host.  Several processes (one per host, or one per card) join one
runtime through `jax.distributed.initialize` with an explicit coordinator,
so `jax.devices()` spans them all.  The reference has no multi-host story
at all (single ROS process); here the distributed keyframe adjustment
(parallel.spatial) is the component that spans devices.
"""

import logging
import os
from typing import Optional

log = logging.getLogger("dmsa_launch")


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
):
    """Join a multi-process runtime from args or the standard env variables
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).

    Without a coordinator address the process stays single-process over
    its local devices: nothing is auto-detected, and a failure to join a
    given coordinator raises.
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    num_processes = num_processes or _int_env("JAX_NUM_PROCESSES")
    process_id = process_id if process_id is not None else _int_env("JAX_PROCESS_ID")

    if coordinator_address is None:
        log.info("single-process mode (%d local devices)", len(jax.local_devices()))
        return

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    log.info(
        "jax.distributed initialized: process %d/%d, %d global devices",
        jax.process_index(),
        jax.process_count(),
        len(jax.devices()),
    )


def _int_env(name):
    v = os.environ.get(name)
    return int(v) if v is not None else None


def global_keyframe_mesh(axis_name: str = "data"):
    """Mesh over ALL devices in the (possibly multi-host) runtime for the
    distributed keyframe adjustment."""
    import numpy as np

    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis_name,))
