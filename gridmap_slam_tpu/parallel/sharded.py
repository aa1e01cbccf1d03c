"""Multi-device SLAM step via GSPMD (jit + NamedSharding).

The single-chip RBPF.step is already one pure function of (state, frame); to
scale it across a mesh we annotate state shardings and let XLA partition the
program: the vmapped per-particle update parallelizes trivially over 'p',
weight normalization / Neff / argmax become all-reduces, and the
systematic-resampling gather becomes cross-shard collective traffic only for
the (rare) ancestor rows that cross shard boundaries.

This is the idiomatic first rung of the sharding ladder (GSPMD auto-
partitioning); the explicit-collective engines (shmap.py, tiled.py,
surface_sharded.py) build on the same mesh for map-tiled ('m' axis)
configurations.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh

from ..models.rbpf import RBPF
from ..types import SlamState
from .mesh import replicated, shard_state, state_shardings


def make_sharded_step(engine: RBPF, mesh: Mesh):
    """jit-compile engine.step with sharded state in/out."""
    sh = state_shardings(mesh)
    return jax.jit(
        engine.step,
        in_shardings=(sh, replicated(mesh)),
        out_shardings=(sh, replicated(mesh)),
    )


def init_sharded(engine: RBPF, key, mesh: Mesh) -> SlamState:
    """Initialize the particle state directly onto the mesh."""
    state = engine.init(key)
    return shard_state(state, mesh)
