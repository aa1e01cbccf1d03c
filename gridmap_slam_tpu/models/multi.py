"""Multi-robot SLAM: R robots mapping one shared world concurrently.

BASELINE config 5 groundwork ("city-scale multi-robot replay: map blocks +
particles sharded across hosts").  Each robot runs its own particle belief
(pose + weight per particle) against the SAME shared occupancy grid; per
tick, every robot consumes one frame from its own log.  The map fuses all
robots' observations — log-odds updates are additive, so R per-robot deltas
sum in one pass.

Axes: poses are (R, P, 3) — 'r' is the multi-robot analog of a data-parallel
replica group and shards cleanly over a mesh axis alongside 'p' (see
parallel/mesh.py); the shared map is replicated (or tiled for city-scale
grids in a later stage).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

from ..config import SlamConfig
from ..ops.geometry import deskew_scan
from ..ops.grid import gaussian_kernel, likelihood_field
from ..ops.matcher import correlative_match, log_likelihood_field
from ..ops.motion import apply_odometry, sample_motion
from ..ops.raycast import build_beam_lut, integrate_scan
from ..ops.resample import neff, systematic_indices, weighted_mean_pose
from ..types import Frame, pytree_dataclass


@pytree_dataclass
class MultiRobotState:
    """poses: (R, P, 3); log_weights: (R, P); logodds: (H, W) shared."""

    poses: jax.Array
    log_weights: jax.Array
    logodds: jax.Array
    key: jax.Array
    step: jax.Array


@pytree_dataclass
class MultiStepInfo:
    neff: jax.Array            # (R,)
    weighted_pose: jax.Array   # (R, 3)
    best_pose: jax.Array       # (R, 3)
    resampled: jax.Array       # (R,)


class MultiRobotSLAM:
    """R-robot shared-map SLAM for a fixed SlamConfig."""

    def __init__(self, config: SlamConfig, num_robots: int):
        self.config = config
        self.num_robots = num_robots
        m = config.map
        self.kernel = gaussian_kernel(m.likelihood_sigma, m.likelihood_radius)

    def init(self, key, poses: Sequence = None) -> MultiRobotState:
        """poses: (R, 3) start pose per robot (default all zeros)."""
        cfg = self.config
        r, p = self.num_robots, cfg.num_particles
        dtype = jnp.dtype(cfg.dtype)
        if poses is None:
            start = jnp.zeros((r, 1, 3), dtype)
        else:
            start = jnp.asarray(poses, dtype).reshape(r, 1, 3)
        return MultiRobotState(
            poses=jnp.broadcast_to(start, (r, p, 3)).copy(),
            log_weights=jnp.full((r, p), -math.log(p), dtype),
            logodds=jnp.zeros((cfg.map.cells_y, cfg.map.cells_x), dtype),
            key=key,
            step=jnp.asarray(0, jnp.int32),
        )

    def step(self, state: MultiRobotState, frames: Frame
             ) -> Tuple[MultiRobotState, MultiStepInfo]:
        """frames: a Frame pytree with leading axis R (one frame per robot)."""
        cfg = self.config
        origin = (float(cfg.map.origin[0]), float(cfg.map.origin[1]))
        res = float(cfg.map.resolution)

        # Shared LL field for everyone this tick.
        field, unknown = likelihood_field(state.logodds, self.kernel)
        llf = log_likelihood_field(field, unknown, cfg.matcher.z_hit,
                                   cfg.sensor.max_range)

        key, k_motion, k_resample = jax.random.split(state.key, 3)

        def robot_update(robot_poses, robot_lw, frame, k):
            scan = deskew_scan(frame.scan, frame.odom)
            odom = frame.odom
            keys = jax.random.split(k, cfg.num_particles)

            def particle(pose, pk):
                pose_s = sample_motion(pk, pose, odom, cfg.motion)
                return correlative_match(
                    llf, scan, pose_s, odom, matcher_cfg=cfg.matcher,
                    motion_cfg=cfg.motion, resolution=res, origin=origin,
                    max_range=cfg.sensor.max_range,
                    prior_center=apply_odometry(pose, odom))

            poses, scores = jax.vmap(particle)(robot_poses, keys)
            lw = scores + robot_lw if cfg.accumulate_weights else scores
            best_pose = poses[jnp.argmax(lw)]
            n_eff = neff(lw)
            # per-robot map delta at its strongest pose
            lut = build_beam_lut(scan, cfg.beam_lut_bins)
            keep = (jnp.abs(odom.d_theta)
                    <= math.radians(cfg.skip_update_dtheta_deg)
                    ).astype(state.logodds.dtype)
            delta = keep * integrate_scan(
                state.logodds, best_pose, scan, lut, resolution=res,
                origin=origin, l_free=cfg.sensor.l_free,
                l_occ=cfg.sensor.l_occ,
                tol_cells=cfg.sensor.hit_tolerance_cells)
            return poses, lw, best_pose, n_eff, delta

        k_robots = jax.random.split(k_motion, self.num_robots)
        poses, lw, best_poses, neffs, deltas = jax.vmap(robot_update)(
            state.poses, state.log_weights, frames, k_robots)

        logodds = state.logodds + jnp.sum(deltas, axis=0)

        # per-robot resampling
        do_rs = neffs < (cfg.num_particles * cfg.resample_fraction)
        rs_keys = jax.random.split(k_resample, self.num_robots)

        def robot_resample(do, k, p_r, lw_r):
            def yes(_):
                idx = systematic_indices(k, lw_r)
                new_lw = (jnp.zeros_like(lw_r) if cfg.accumulate_weights
                          else jnp.take(lw_r, idx))
                return jnp.take(p_r, idx, axis=0), new_lw
            return jax.lax.cond(do, yes, lambda _: (p_r, lw_r), None)

        poses, lw = jax.vmap(robot_resample)(do_rs, rs_keys, poses, lw)
        weighted = jax.vmap(weighted_mean_pose)(poses, lw)

        new_state = MultiRobotState(poses=poses, log_weights=lw,
                                    logodds=logodds, key=key,
                                    step=state.step + 1)
        info = MultiStepInfo(neff=neffs, weighted_pose=weighted,
                             best_pose=best_poses, resampled=do_rs)
        return new_state, info

    def replay(self, state, frames):
        """frames: Frame pytree with leading axes (T, R)."""
        def body(s, f):
            return self.step(s, f)
        return jax.lax.scan(body, state, frames)
