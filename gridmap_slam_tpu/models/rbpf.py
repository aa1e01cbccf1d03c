"""Rao-Blackwellized particle-filter SLAM — the flagship model.

Reference behavior: slam/SLAM.java (orchestration), app/GridMapApp.java:133-212
(de-skew + auto-resample policy).  Per scan, every particle: samples the motion
model, rebuilds its likelihood field, refines its pose by scan matching,
weights itself by p(z|x,m), and integrates the scan into its own map (skipped
for |dTheta| > 30 deg); then weights are normalized, Neff computed, and the
filter resamples systematically when Neff < P/2.

Design: the reference's sequential 500-particle Java loop (slam/SLAM.java:88)
becomes one jittable function of (state, frame): the per-particle update is
vmapped, optionally in `lax.map` chunks to bound the scan-matcher's gather
workspace, and resampling is a lax.cond'ed gather over the particle axis.
The whole step compiles to a single XLA program per config.
"""

from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import SlamConfig
from ..ops.geometry import deskew_scan
from ..ops.grid import gaussian_kernel, likelihood_field
from ..ops.matcher import (correlative_match, log_likelihood_field,
                           resolve_impl, score_pose)
from ..ops.motion import apply_odometry, sample_motion
from ..ops.raycast import build_beam_lut, integrate_scan
from ..ops.resample import (neff, systematic_indices, weighted_mean_pose)
from ..types import Frame, SlamState, StepInfo


class RBPF:
    """Particle-filter SLAM engine for a fixed `SlamConfig`.

    `init` builds the state; `step` is pure/jittable and can be passed through
    jax.jit (done lazily by `step_jit`).
    """

    def __init__(self, config: SlamConfig):
        self.config = config
        m = config.map
        self.kernel = gaussian_kernel(m.likelihood_sigma, m.likelihood_radius)
        resolve_impl(config.matcher.impl)       # reject unknown impls early
        self._step_jit = None

    # ------------------------------------------------------------------ state
    def init(self, key, pose=(0.0, 0.0, 0.0)) -> SlamState:
        """All particles at `pose` with blank maps (slam/SLAM.java:65-77)."""
        cfg = self.config
        p = cfg.num_particles
        h, w = cfg.map.cells_y, cfg.map.cells_x
        dtype = jnp.dtype(cfg.dtype)
        return SlamState(
            poses=jnp.broadcast_to(jnp.asarray(pose, dtype), (p, 3)).copy(),
            log_weights=jnp.full((p,), -math.log(p), dtype),
            logodds=jnp.zeros((p, h, w), dtype),
            key=key,
            step=jnp.asarray(0, jnp.int32),
        )

    def init_from_map(self, key, logodds, pose=(0.0, 0.0, 0.0)) -> SlamState:
        """Start with every particle sharing a previously-built map — the
        engine-side half of the reference's map checkpoint loader
        (slam/GridMapLoader.java:105-135 + io/recording.read_map_checkpoint).
        Enables localization-in-known-map and checkpoint-resume mapping."""
        state = self.init(key, pose)
        lo = jnp.asarray(logodds, state.logodds.dtype)
        assert lo.shape == state.logodds.shape[1:], (
            f"map shape {lo.shape} != configured {state.logodds.shape[1:]}")
        return state.replace(
            logodds=jnp.broadcast_to(lo[None], state.logodds.shape).copy())

    # ------------------------------------------------------------------- step
    def step(self, state: SlamState, frame: Frame) -> Tuple[SlamState, StepInfo]:
        cfg = self.config
        mcfg = cfg.map
        origin = (float(mcfg.origin[0]), float(mcfg.origin[1]))
        res = float(mcfg.resolution)

        scan = deskew_scan(frame.scan, frame.odom)
        lut = build_beam_lut(scan, cfg.beam_lut_bins)
        odom = frame.odom

        # Large-rotation skip for map integration (slam/SLAM.java:82).
        keep = (jnp.abs(odom.d_theta) <= math.radians(cfg.skip_update_dtheta_deg)
                ).astype(state.logodds.dtype)
        if cfg.freeze_map:          # localization-only: map never changes
            keep = keep * 0.0

        def refine(llf, pose_s, pose_det):
            """Scan-match + weight for one particle given its LL field.
            The motion prior is centered at pose_det = x0 (+) u (the
            reference's BOBYQA objective, slam/GridMap.java:356)."""
            if cfg.matcher.enabled:
                return correlative_match(
                    llf, scan, pose_s, odom,
                    matcher_cfg=cfg.matcher, motion_cfg=cfg.motion,
                    resolution=res, origin=origin,
                    max_range=cfg.sensor.max_range, prior_center=pose_det)
            return pose_s, score_pose(
                llf, scan, pose_s, z_hit=cfg.matcher.z_hit, resolution=res,
                origin=origin, max_range=cfg.sensor.max_range)

        def chunk_update(poses_c, logodds_c, keys_c):
            """Update a (C, ...) particle block: per-particle field build,
            scan match and map update, each vmapped over the block."""
            pose_s = jax.vmap(
                lambda k, p: sample_motion(k, p, odom, cfg.motion))(
                    keys_c, poses_c)
            pose_det = apply_odometry(poses_c, odom)

            def ll_one(lo):
                field, unknown = likelihood_field(lo, self.kernel)
                return log_likelihood_field(
                    field, unknown, cfg.matcher.z_hit, cfg.sensor.max_range)

            with jax.named_scope("llfield"):
                llf = jax.vmap(ll_one)(logodds_c)
            with jax.named_scope("matcher"):
                best, score = jax.vmap(refine)(llf, pose_s, pose_det)
            with jax.named_scope("map_update"):
                delta = jax.vmap(lambda lo, p: integrate_scan(
                    lo, p, scan, lut, resolution=res, origin=origin,
                    l_free=cfg.sensor.l_free, l_occ=cfg.sensor.l_occ,
                    tol_cells=cfg.sensor.hit_tolerance_cells))(
                        logodds_c, best)
                new_lo = logodds_c + keep * delta
            return best, score, new_lo

        key, k_motion, k_resample = jax.random.split(state.key, 3)
        keys = jax.random.split(k_motion, cfg.num_particles)

        # Memory note: the chunked path reshapes the full (P, H, W) logodds
        # into (n_chunks, C, H, W) and back.  With donation (step_jit's
        # default) XLA aliases these reshapes in place, but WITHOUT donation
        # the reshape materializes a second copy of the dominant tensor —
        # at the margins where chunking is used at all, run via step_jit()
        # or budget 2x map residency.
        chunk = cfg.particle_chunk
        if chunk and cfg.num_particles > chunk:
            assert cfg.num_particles % chunk == 0, (
                "num_particles must be divisible by particle_chunk")
            n_chunks = cfg.num_particles // chunk

            def one_chunk(args):
                return chunk_update(*args)

            args = (state.poses.reshape(n_chunks, chunk, 3),
                    state.logodds.reshape((n_chunks, chunk) +
                                          state.logodds.shape[1:]),
                    keys.reshape((n_chunks, chunk) + keys.shape[1:]))
            poses, scores, logodds = jax.lax.map(one_chunk, args)
            poses = poses.reshape(cfg.num_particles, 3)
            scores = scores.reshape(cfg.num_particles)
            logodds = logodds.reshape(state.logodds.shape)
        else:
            poses, scores, logodds = chunk_update(state.poses, state.logodds,
                                                  keys)

        # Per-scan importance weights: the reference overwrites weights with
        # p(z|x,m) each update (slam/SLAM.java:99); with accumulate_weights
        # the filter multiplies them in (sequential importance sampling).
        log_weights = scores.astype(state.log_weights.dtype)
        if cfg.accumulate_weights:
            log_weights = log_weights + state.log_weights
        n_eff = neff(log_weights)

        best_index = jnp.argmax(log_weights)
        info_best_pose = poses[best_index]
        weighted = weighted_mean_pose(poses, log_weights)

        # Auto-resample when Neff < P/2 (app/GridMapApp.java:185-186).
        do_resample = n_eff < (cfg.num_particles * cfg.resample_fraction)

        def resample(args):
            poses, logodds, log_weights = args
            idx = systematic_indices(k_resample, log_weights)
            new_lw = (jnp.zeros_like(log_weights)
                      if cfg.accumulate_weights
                      else jnp.take(log_weights, idx, axis=0))
            return (jnp.take(poses, idx, axis=0),
                    jnp.take(logodds, idx, axis=0),
                    new_lw)

        poses, logodds, log_weights = jax.lax.cond(
            do_resample, resample, lambda a: a, (poses, logodds, log_weights))

        new_state = SlamState(poses=poses, log_weights=log_weights,
                              logodds=logodds, key=key, step=state.step + 1)
        info = StepInfo(neff=n_eff, weighted_pose=weighted,
                        best_pose=info_best_pose, best_index=best_index,
                        best_log_weight=log_weights.max(),
                        resampled=do_resample)
        return new_state, info

    # -------------------------------------------------------------- utilities
    def step_jit(self, donate: bool = True):
        """Jitted step; donates the input state's buffers (the per-particle
        map tensor dominates memory — donation lets XLA update it in place)."""
        if self._step_jit is None:
            self._step_jit = jax.jit(self.step,
                                     donate_argnums=(0,) if donate else ())
        return self._step_jit

    def replay(self, state: SlamState, frames: Frame):
        """Replay a whole stacked Frame batch in ONE compiled program
        (lax.scan over the frame axis).  Dispatch cost is paid once for the
        entire log — the device-side equivalent of the reference's frame-by-
        frame DataRecorder replay loop (app/DataRecorder.java:336-364).

        Returns (final_state, stacked StepInfo with leading frame axis).
        """

        def body(s, f):
            s2, info = self.step(s, f)
            return s2, info

        return jax.lax.scan(body, state, frames)

    def replay_jit(self):
        return jax.jit(self.replay, donate_argnums=(0,))

    def run_log(self, state: SlamState, frames, callback=None):
        """Replay a sequence of frames (python loop; each frame jitted).

        `frames` is an iterable of Frame pytrees.  Returns (state, infos).
        Use `replay` for the single-dispatch compiled version.
        """
        step = jax.jit(self.step)
        infos = []
        for f in frames:
            state, info = step(state, f)
            infos.append(info)
            if callback is not None:
                callback(state, info)
        return state, infos

    def best_map(self, state: SlamState):
        """Log-odds map of the strongest particle."""
        return state.logodds[jnp.argmax(state.log_weights)]

    def combined_occupancy(self, state: SlamState):
        """Cell-wise fused occupancy across particles:
        1 - prod_i(1 - p_i) (app/GridMapApp.java:439-458)."""
        from ..ops.grid import inv_log_odds
        p = inv_log_odds(state.logodds)
        return 1.0 - jnp.prod(1.0 - p, axis=0)
