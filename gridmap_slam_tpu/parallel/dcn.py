"""Multi-host initialization and mesh construction.

Single-host meshes scale particles/map-tiles over the host's device links
(NVLink); multi-host runs add the inter-host network (DCN, the data-center
network).  The layout rule for this workload (SURVEY.md §2.10): put the
PARTICLE axis on the host dimension — particle shards never exchange maps
outside resampling, and the distributed resampler's all_gather of
(pose, log-weight) rows is tiny — and keep map-tile axes ('m') inside a
host so blur halos and tile reads stay on the device links.

Usage (one process per host, standard JAX multi-process):

    from gridmap_slam_tpu.parallel import dcn
    dcn.initialize(coordinator="host0:1234", num_processes=2, process_id=i)
    mesh = dcn.make_multihost_mesh(map_shards=2)

The driver's single-process virtual-device testing path
(xla_force_host_platform_device_count) goes through the same
`make_multihost_mesh` since jax.devices() already spans all processes after
initialize().
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize with env-var fallbacks; no-op when already
    initialized or single-process.

    NB: must not touch jax.devices()/jax.process_count() before calling
    jax.distributed.initialize — those initialize the XLA backend and
    initialize() then refuses to run.  Already-initialized state is detected
    through the distributed client handle instead."""
    if jax.distributed.is_initialized():
        return                       # distributed service already up
    kwargs = {}
    if coordinator is not None:
        kwargs["coordinator_address"] = coordinator
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    try:
        jax.distributed.initialize(**kwargs)
    except ValueError:
        # already initialized (or single-process with no coordinator given)
        pass


def make_multihost_mesh(map_shards: int = 1) -> Mesh:
    """('p', 'm') mesh over ALL processes' devices with hosts mapped onto the
    leading (particle) axis: jax.devices() orders devices process-major, so
    reshaping to (n_total // map_shards, map_shards) keeps each host's
    devices contiguous along 'p' and confines 'm' within a host."""
    devices = np.asarray(jax.devices())
    n = len(devices)
    assert n % map_shards == 0, (n, map_shards)
    return Mesh(devices.reshape(n // map_shards, map_shards), ("p", "m"))
