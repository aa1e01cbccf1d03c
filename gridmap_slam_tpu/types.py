"""Core pytree types.

The reference's object graph (slam/Pose.java, slam/Observation.java,
slam/Odometry.java, slam/TimeFrame.java) becomes fixed-shape JAX pytrees:
poses are (..., 3) arrays, a scan is a fixed-width structure-of-arrays with a
validity mask (replacing the variable-length `Observation`), and the full
particle-filter state is a single dataclass of arrays so the whole SLAM update
is one jittable function of (state, frame) -> state.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


def pytree_dataclass(cls):
    """Frozen dataclass registered as a JAX pytree: every field is a child,
    flattened in declaration order, and `.replace(**changes)` returns a
    copy with those fields swapped."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = dataclasses.replace
    return jax.tree_util.register_dataclass(cls)


@pytree_dataclass
class Scan:
    """One full LiDAR revolution, fixed width B (reference Observation).

    angle:  (B,) beam angle in the robot frame, radians.
    dist:   (B,) measured distance in meters (max_range when no hit).
    hit:    (B,) bool, True if the beam returned an echo.
    valid:  (B,) bool, False for padding entries.
    """

    angle: jax.Array
    dist: jax.Array
    hit: jax.Array
    valid: jax.Array

    @property
    def num_beams(self) -> int:
        return self.angle.shape[-1]

    @staticmethod
    def from_arrays(angle, dist, hit, max_beams: int,
                    max_range: float = 10.0) -> "Scan":
        """Pad/truncate variable-length beam arrays to fixed width."""
        angle = np.asarray(angle, np.float32)
        dist = np.asarray(dist, np.float32)
        hit = np.asarray(hit, bool)
        n = min(angle.shape[0], max_beams)
        pa = np.zeros((max_beams,), np.float32)
        pd = np.full((max_beams,), max_range, np.float32)
        ph = np.zeros((max_beams,), bool)
        pv = np.zeros((max_beams,), bool)
        pa[:n], pd[:n], ph[:n], pv[:n] = angle[:n], dist[:n], hit[:n], True
        return Scan(angle=jnp.asarray(pa), dist=jnp.asarray(pd),
                    hit=jnp.asarray(ph), valid=jnp.asarray(pv))


@pytree_dataclass
class Odom:
    """Relative odometry for one scan interval (reference Odometry).

    d_center: scalar forward motion of the wheel-base center, meters.
    d_theta:  scalar heading change, radians.
    """

    d_center: jax.Array
    d_theta: jax.Array

    @staticmethod
    def from_counts(left: int, right: int, robot) -> "Odom":
        """Encoder counts -> (d_center, d_theta) (slam/Odometry.java:41-55)."""
        d_left = left / robot.motor_steps_per_rev * np.pi * robot.wheel_diameter
        d_right = right / robot.motor_steps_per_rev * np.pi * robot.wheel_diameter
        return Odom(
            d_center=jnp.asarray((d_left + d_right) / 2.0, jnp.float32),
            d_theta=jnp.asarray((d_right - d_left) / robot.wheel_distance,
                                jnp.float32),
        )


@pytree_dataclass
class Frame:
    """One SLAM input: a scan plus the odometry accumulated since the previous
    scan (reference TimeFrame).  `t` is the recording timestamp in seconds."""

    scan: Scan
    odom: Odom
    t: jax.Array


@pytree_dataclass
class SlamState:
    """Full Rao-Blackwellized particle-filter state.

    poses:     (P, 3) particle poses (x, y, theta).
    log_weights: (P,) unnormalized log importance weights.
    logodds:   (P, H, W) per-particle occupancy grids, log-odds.
    key:       PRNG key.
    step:      scan counter.
    """

    poses: jax.Array
    log_weights: jax.Array
    logodds: jax.Array
    key: jax.Array
    step: jax.Array


@pytree_dataclass
class StepInfo:
    """Per-scan diagnostics (reference prints / ImGui readouts)."""

    neff: jax.Array            # effective sample size (slam/SLAM.java:180)
    weighted_pose: jax.Array   # (3,) weighted mean pose (slam/SLAM.java:165)
    best_pose: jax.Array       # (3,) strongest particle's pose
    best_index: jax.Array      # index of the strongest particle
    best_log_weight: jax.Array
    resampled: jax.Array       # bool, whether this step resampled
