"""Device mesh construction and sharding layouts.

The reference is single-threaded Java (SURVEY.md §2.10 — no parallelism of any
kind); its de-facto parallel axis is the 500-iteration particle loop.  Here:

- axis 'p' (particle parallelism, the DP analog): particles and their maps are
  sharded across devices; the per-particle update needs no communication at
  all, weight normalization/Neff are tiny all-reduces, and resampling is a
  gather whose cross-shard traffic XLA lowers onto the device links.
- axis 'm' (map-tile parallelism, the TP/SP analog): the map W dimension is
  sharded; the dense gather-free occupancy update is tile-local by
  construction (each cell's update depends only on pose+scan), the blur's
  shifted adds become 1-cell halo collective-permutes inserted by XLA.

Multi-host: the same mesh spans hosts via jax.distributed.initialize();
'p' should map to the host dimension (the inter-host network) since
particle shards never exchange maps outside resampling.  Within a host the
GPUs are joined all to all (NVLink), so the mesh follows the algorithm,
not a torus.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..types import SlamState


def make_mesh(n_devices: Optional[int] = None, map_shards: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Mesh with axes ('p', 'm'); map_shards divides the device count."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    assert n % map_shards == 0, (n, map_shards)
    arr = np.asarray(devices).reshape(n // map_shards, map_shards)
    return Mesh(arr, ("p", "m"))


def state_shardings(mesh: Mesh) -> SlamState:
    """NamedShardings for each SlamState leaf: particles over 'p', map W
    over 'm'; small leaves replicated."""
    return SlamState(
        poses=NamedSharding(mesh, P("p", None)),
        log_weights=NamedSharding(mesh, P("p")),
        logodds=NamedSharding(mesh, P("p", None, "m")),
        key=NamedSharding(mesh, P()),
        step=NamedSharding(mesh, P()),
    )


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())


def shard_state(state: SlamState, mesh: Mesh) -> SlamState:
    """Place an existing state onto the mesh."""
    sh = state_shardings(mesh)
    return jax.tree.map(jax.device_put, state, sh)
