"""Device mesh helpers."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("batch", "col"),
):
    """Build a Mesh over the available devices.

    ``shape=None`` puts all devices on the last ("col") axis — column-sharded
    pricing with a cross-device argmax combine; the "batch" axis shards
    independent LP scenarios.
    """
    import jax
    from jax.sharding import Mesh

    devices = jax.devices()
    n = len(devices)
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (n,)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not match {n} devices")
    mesh_devices = np.array(devices).reshape(shape)
    return Mesh(mesh_devices, tuple(axis_names))


def default_mesh():
    return make_mesh()


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize multi-host JAX (N>=2 hosts over DCN).

    Call once per process before building meshes; afterwards
    ``jax.devices()`` spans all hosts and :func:`make_mesh` shards across
    them — put the scenario-batch axis across hosts and the column axis
    within a host.  With no arguments, JAX must detect a cluster
    environment it knows (e.g. SLURM); elsewhere pass all three.
    """
    import jax

    if coordinator_address is None:
        jax.distributed.initialize()
    else:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
