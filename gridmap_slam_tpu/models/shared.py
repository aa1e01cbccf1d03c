"""Shared-map particle filter — the scalable mode for huge particle counts.

The reference gives EVERY particle its own occupancy grid (slam/SLAM.java:30-47),
which caps particle count by memory (500 x two 14,400-double arrays already
dominates its allocations; 1M such particles would need ~115 TB).  BASELINE
config 3 ("1M particles, tiled 200x200 m grid") is only feasible with the
map factored out of the per-particle state — the SURVEY §7 "hard parts"
design decision.

This model keeps ONE log-odds map; particles carry only (pose, log-weight).
Per scan: the LL field is built once, every particle scan-matches against it
(vmapped correlative search), weights/resampling run on poses alone (gather
of 3 floats per particle instead of two full maps), and the scan is
integrated once at the strongest particle's refined pose.  The per-particle
cost is pure matcher compute, so millions of particles vmap/shard cleanly;
the map cost is independent of P.

Trade-off vs the reference semantics (documented): map hypotheses are not
per-particle, so mapping errors are not marginalized over trajectories —
this is scan-to-map localization with a particle belief, appropriate when
P is huge and the map is large.  The per-particle-map `RBPF` remains the
reference-parity default.
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
from ..ops.resample import neff, systematic_indices, weighted_mean_pose
from ..types import Frame, StepInfo, pytree_dataclass


def surface_volume(cfg: SlamConfig, kernel, logodds, scan, center):
    """Build one scan's likelihood volume + trilinear-tap kwargs around
    `center` — the SINGLE implementation of surface-mode semantics (crop
    placement, crop-local field build, theta-bin grid incl. the
    full-circle wrap, FFT auto selection, packed-neighborhood taps),
    shared by SharedMapSLAM.step_surface and the distributed engines
    (parallel/shmap.py, parallel/surface_sharded.py).  Round-4 ADVICE: the
    shmap surface branch had drifted from step_surface (no odometry
    propagation, no wrap, no temp) because the logic was duplicated.

    The likelihood field is built ONLY over the crop plus the blur radius
    (round-5): the volume taps never read outside the crop (clamped taps
    hit the ll_outside pad), so building the field over the whole map was
    pure waste — at city scale (4000^2 map, 512 crop) the full-map
    threshold+blur dominated the step.  Including the kernel-radius halo
    in the extended slice makes the cropped build EXACT (crop-boundary
    cells see the same blur neighbors; a slice clamped at the world edge
    reproduces the reference blur's zero boundary, app/Util.java:396).

    `center` must already be the odometry-PROPAGATED cloud mean (callers
    apply apply_odometry; see step_surface's center comment).
    Returns (c_vol, tap_kw, kc): pass tap_kw to sample_surface /
    refine_on_surface; integrate with crop 2*kc + slack.
    """
    import math as _math

    from ..ops.geometry import scan_points
    from ..ops.matcher import log_likelihood_field
    from ..ops.surface import (crop_center_cells, pack_neighborhoods,
                               scan_surface, splat_endpoint_kernels)

    mc = cfg.matcher
    origin = (float(cfg.map.origin[0]), float(cfg.map.origin[1]))
    res = float(cfg.map.resolution)
    h, w = cfg.map.cells_y, cfg.map.cells_x

    # crop_cells == 0 means the FULL map (per the config docstring) — also
    # on non-square maps (round-5 fix: the old min(h, w) square silently
    # cropped global relocalization on corridor-shaped worlds)
    if mc.surface_crop_cells > 0:
        hc = min(mc.surface_crop_cells, h)
        wc = min(mc.surface_crop_cells, w)
    else:
        hc, wc = h, w
    iy0, ix0 = crop_center_cells(center[:2], (hc, wc), (h, w), res, origin)

    r = cfg.map.likelihood_radius
    hce, wce = hc + 2 * r, wc + 2 * r
    if hce <= h and wce <= w:
        # crop-local field build (extended by the blur radius, exact)
        ey0 = jnp.clip(iy0 - r, 0, h - hce)
        ex0 = jnp.clip(ix0 - r, 0, w - wce)
        lo_ext = jax.lax.dynamic_slice(logodds, (ey0, ex0), (hce, wce))
        field, unknown = likelihood_field(lo_ext, kernel)
        llf_ext = log_likelihood_field(field, unknown, mc.z_hit,
                                       cfg.sensor.max_range)
        llf_crop = jax.lax.dynamic_slice(llf_ext, (iy0 - ey0, ix0 - ex0),
                                         (hc, wc))
    else:
        field, unknown = likelihood_field(logodds, kernel)
        llf = log_likelihood_field(field, unknown, mc.z_hit,
                                   cfg.sensor.max_range)
        llf_crop = jax.lax.dynamic_slice(llf, (iy0, ix0), (hc, wc))

    nt = mc.surface_nt
    from ..ops.surface import theta_grid
    dtheta, wrap_theta, t_off = theta_grid(
        nt, _math.radians(mc.surface_theta_span_deg))
    theta0 = center[2] + t_off
    thetas = theta0 + dtheta * jnp.arange(nt, dtype=jnp.float32)

    px, py = scan_points(scan)
    wgt = (scan.valid & scan.hit).astype(llf_crop.dtype)
    # Kernel radius covers every possible hit endpoint (<= max_range), so
    # the splat's rim clamp never engages (see ops/surface.py).
    kc = int(_math.ceil(cfg.sensor.max_range / res)) + 2
    e_stack = splat_endpoint_kernels(px, py, wgt, thetas, kc, res)
    use_fft = (mc.surface_corr == "fft"
               or (mc.surface_corr == "auto"
                   and nt * (2 * kc + 1) ** 2 * hc * wc > 2e10))
    ll_outside = _math.log(1.0 / cfg.sensor.max_range)
    c_vol = scan_surface(llf_crop, e_stack, ll_outside,
                         bf16=mc.surface_bf16, fft=use_fft)
    tap_kw = dict(theta0=theta0, dtheta=dtheta, crop_iy0=iy0, crop_ix0=ix0,
                  resolution=res, origin=origin, wrap_theta=wrap_theta,
                  packed=pack_neighborhoods(c_vol, wrap_theta))
    return c_vol, tap_kw, kc


def surface_temper(mc, scan, scores):
    """Surface-mode weight temperature (config.MatcherConfig.
    surface_weight_temp: 0 = AUTO 1/sqrt(n_valid_hit_beams), 1 =
    reference raw-product semantics).  One implementation for
    step_surface and the distributed engines."""
    if mc.surface_weight_temp == 1.0:
        return scores
    if mc.surface_weight_temp > 0.0:
        return scores * mc.surface_weight_temp
    n_b = jnp.maximum(
        jnp.sum((scan.valid & scan.hit).astype(scores.dtype)), 1.0)
    return scores * jax.lax.rsqrt(n_b)


def recovery_update(cfg: SlamConfig, state, l_ref):
    """AMCL fast/slow EMA update (see _finalize's block comment for the
    max-weight + cap rationale).  `l_ref` must be the GLOBAL max
    log-weight (replicated in sharded layouts — the engines' weight-stat
    pmax).  Returns (recov', p_inject or None when disabled)."""
    mc = cfg.matcher
    a_slow, a_fast = mc.surface_reinject_slow, mc.surface_reinject_fast
    if not (a_slow > 0.0 and a_fast > 0.0):
        return state.recov, None
    alphas = jnp.asarray([a_slow, a_fast], state.recov.dtype)
    recov = jnp.where(state.step == 0, jnp.full((2,), l_ref),
                      state.recov + alphas * (l_ref - state.recov))
    p_inject = jnp.clip(1.0 - jnp.exp(recov[1] - recov[0]), 0.0, 0.3)
    return recov, p_inject


def inject_uniform(cfg: SlamConfig, key, poses, p_inject,
                   slot_offset=0):
    """Replace GLOBAL resample slots [0, p_inject * P) with uniform draws
    over map extent x full circle.  `poses` is this shard's (k, 3) slice
    of the resampled population; slot_offset its first global slot id
    (the systematic index order is already an unbiased permutation of
    ancestry, so slot choice carries no bias).  Returns (poses', mask)."""
    m = cfg.map
    k = poses.shape[0]
    u = jax.random.uniform(key, (k, 3), dtype=poses.dtype)
    uni = jnp.stack([
        m.origin[0] + u[:, 0] * m.width_m,
        m.origin[1] + u[:, 1] * m.height_m,
        (u[:, 2] * 2.0 - 1.0) * math.pi], axis=1)
    gslot = slot_offset + jnp.arange(k)
    take = gslot < p_inject * cfg.num_particles
    return jnp.where(take[:, None], uni, poses), take


def integration_pose(n_eff, num_particles: int, weighted, best_pose):
    """Pose the shared map is updated at: the argmax-weight particle,
    EXCEPT when the weights are near-uniform (Neff >= 0.95 P, e.g. the
    FIRST scan into an empty map), where argmax is an arbitrary
    motion-noise sample: integrating there gives the map a rotated
    birth frame that the filter then tracks consistently, reading as
    linear ATE drift (round-4 finding).
    Near-uniform weights -> the weighted mean (= the motion-prior
    mean)."""
    return jnp.where(n_eff >= 0.95 * num_particles, weighted,
                     best_pose)


@pytree_dataclass
class SharedMapState:
    """poses: (P, 3); log_weights: (P,); logodds: (H, W) single shared map.

    recov: (2,) [l_slow, l_fast] — slow/fast EMAs of the per-scan mean
    log-weight for AMCL recovery injection (config.surface_reinject_*);
    carried (and updated) even when injection is disabled so the state
    pytree is layout-stable across configs."""

    poses: jax.Array
    log_weights: jax.Array
    logodds: jax.Array
    key: jax.Array
    step: jax.Array
    recov: jax.Array


class SharedMapSLAM:
    """Shared-map particle filter for a fixed SlamConfig."""

    def __init__(self, config: SlamConfig):
        self.config = config
        m = config.map
        self.kernel = gaussian_kernel(m.likelihood_sigma, m.likelihood_radius)
        resolve_impl(config.matcher.impl)       # reject unknown impls early

    def init(self, key, pose=(0.0, 0.0, 0.0)) -> SharedMapState:
        cfg = self.config
        p = cfg.num_particles
        dtype = jnp.dtype(cfg.dtype)
        return SharedMapState(
            poses=jnp.broadcast_to(jnp.asarray(pose, dtype), (p, 3)).copy(),
            log_weights=jnp.full((p,), -math.log(p), dtype),
            logodds=jnp.zeros((cfg.map.cells_y, cfg.map.cells_x), dtype),
            key=key,
            step=jnp.asarray(0, jnp.int32),
            recov=jnp.zeros((2,), dtype),
        )

    def init_from_map(self, key, logodds, pose=(0.0, 0.0, 0.0)
                      ) -> SharedMapState:
        """Start from a previously-built shared map (localization /
        checkpoint-resume; the shared-map analog of RBPF.init_from_map,
        reference GridMapLoader slam/GridMapLoader.java:105-135)."""
        state = self.init(key, pose)
        lo = jnp.asarray(logodds, state.logodds.dtype)
        assert lo.shape == state.logodds.shape, (
            f"map shape {lo.shape} != configured {state.logodds.shape}")
        return state.replace(logodds=lo)

    def init_uniform(self, key, logodds) -> SharedMapState:
        """Kidnapped-robot initialization: particles uniform over the map
        extent x [-pi, pi) on a known map — the global-relocalization
        setup that justifies 1M-particle operation (surface mode scores
        any pose with ~8 taps regardless of cloud spread)."""
        cfg = self.config
        m = cfg.map
        key, ku = jax.random.split(key)
        u = jax.random.uniform(ku, (cfg.num_particles, 3),
                               dtype=jnp.dtype(cfg.dtype))
        poses = jnp.stack([
            m.origin[0] + u[:, 0] * m.width_m,
            m.origin[1] + u[:, 1] * m.height_m,
            (u[:, 2] * 2.0 - 1.0) * math.pi], axis=1)
        return self.init_from_map(key, logodds).replace(poses=poses)

    def step(self, state: SharedMapState, frame: Frame
             ) -> Tuple[SharedMapState, StepInfo]:
        cfg = self.config
        origin = (float(cfg.map.origin[0]), float(cfg.map.origin[1]))
        res = float(cfg.map.resolution)

        scan = deskew_scan(frame.scan, frame.odom)
        lut = build_beam_lut(scan, cfg.beam_lut_bins)
        odom = frame.odom
        keep = (jnp.abs(odom.d_theta)
                <= math.radians(cfg.skip_update_dtheta_deg)
                ).astype(state.logodds.dtype)
        if cfg.freeze_map:          # localization-only: map never changes
            keep = keep * 0.0

        # LL field built ONCE for the shared map.
        field, unknown = likelihood_field(state.logodds, self.kernel)
        llf = log_likelihood_field(field, unknown, cfg.matcher.z_hit,
                                   cfg.sensor.max_range)

        def particle(pose, key):
            pose_s = sample_motion(key, pose, odom, cfg.motion)
            if cfg.matcher.enabled:
                return correlative_match(
                    llf, scan, pose_s, odom,
                    matcher_cfg=cfg.matcher, motion_cfg=cfg.motion,
                    resolution=res, origin=origin,
                    max_range=cfg.sensor.max_range,
                    prior_center=apply_odometry(pose, odom))
            return pose_s, score_pose(
                llf, scan, pose_s, z_hit=cfg.matcher.z_hit, resolution=res,
                origin=origin, max_range=cfg.sensor.max_range)

        key, k_motion, k_resample = jax.random.split(state.key, 3)
        keys = jax.random.split(k_motion, cfg.num_particles)

        vm = jax.vmap(particle)
        chunk = cfg.particle_chunk
        if chunk and cfg.num_particles > chunk:
            assert cfg.num_particles % chunk == 0
            n_chunks = cfg.num_particles // chunk
            poses, scores = jax.lax.map(
                lambda a: vm(*a),
                (state.poses.reshape(n_chunks, chunk, 3),
                 keys.reshape((n_chunks, chunk) + keys.shape[1:])))
            poses = poses.reshape(cfg.num_particles, 3)
            scores = scores.reshape(cfg.num_particles)
        else:
            poses, scores = vm(state.poses, keys)

        return self._finalize(state, key, k_resample, poses, scores, scan,
                              lut, keep)

    def _finalize(self, state, key, k_resample, poses, scores, scan, lut,
                  keep, integrate_crop: int = 0, resample_fraction=None):
        """Shared tail of step/step_surface: weights, Neff, best-pose map
        integration, conditional systematic resampling.

        integrate_crop > 0 integrates into a crop of that many cells around
        the best pose (dynamic_slice + dynamic_update_slice) instead of the
        full grid — on city-scale maps the full-grid update's per-cell work
        dwarfs the scan's actual reach (<= max_range); the crop makes the
        update cost independent of map size.  Callers must pass a crop
        covering 2*max_range plus slack.  resample_fraction overrides the
        Neff gate threshold (surface mode passes its own — see
        config.surface_resample_fraction)."""
        cfg = self.config
        origin = (float(cfg.map.origin[0]), float(cfg.map.origin[1]))
        res = float(cfg.map.resolution)
        # Per-scan importance weights: the reference overwrites weights with
        # p(z|x,m) each update (slam/SLAM.java:99); with accumulate_weights
        # the filter multiplies them in (sequential importance sampling).
        log_weights = scores.astype(state.log_weights.dtype)
        if cfg.accumulate_weights:
            log_weights = log_weights + state.log_weights
        n_eff = neff(log_weights)
        best_index = jnp.argmax(log_weights)
        best_pose = poses[best_index]
        weighted = weighted_mean_pose(poses, log_weights)
        integ_pose = integration_pose(n_eff, cfg.num_particles, weighted,
                                      best_pose)

        # Integrate once at the strongest particle's pose.
        h, w = state.logodds.shape
        if 0 < integrate_crop < min(h, w):
            from ..ops.surface import crop_center_cells
            ic = integrate_crop
            iy0, ix0 = crop_center_cells(integ_pose[:2], (ic, ic), (h, w),
                                         res, origin)
            lo_crop = jax.lax.dynamic_slice(state.logodds, (iy0, ix0),
                                            (ic, ic))
            delta = integrate_scan(
                lo_crop, integ_pose, scan, lut, resolution=res,
                origin=(origin[0] + ix0 * res, origin[1] + iy0 * res),
                l_free=cfg.sensor.l_free, l_occ=cfg.sensor.l_occ,
                tol_cells=cfg.sensor.hit_tolerance_cells)
            logodds = jax.lax.dynamic_update_slice(
                state.logodds, lo_crop + keep * delta, (iy0, ix0))
        else:
            delta = integrate_scan(
                state.logodds, integ_pose, scan, lut, resolution=res,
                origin=origin, l_free=cfg.sensor.l_free,
                l_occ=cfg.sensor.l_occ,
                tol_cells=cfg.sensor.hit_tolerance_cells)
            logodds = state.logodds + keep * delta

        rf = (cfg.resample_fraction if resample_fraction is None
              else resample_fraction)
        do_resample = n_eff < (cfg.num_particles * rf)

        # ---- AMCL recovery tracking (Augmented MCL, table 8.3, with two
        # measured adaptations) ----
        # The textbook tracks the MEAN particle weight; with heavy
        # injection that is a death spiral (measured on the kidnap demo:
        # ~95 % of particles were uniform garbage every scan, which kept
        # the mean — and therefore the fast EMA — depressed, so the
        # filter re-injected forever and destroyed its own re-converged
        # cloud, err_best oscillating 0.02 <-> 47 m).  We track the MAX
        # log-weight instead: it crashes identically at a kidnap (the
        # whole cloud is bad) but recovers the moment ANY particle
        # re-acquires, which is exactly when injection should stop.  The
        # injection fraction is additionally capped at 0.3 so survivors
        # keep carrying the posterior while recovery seeds.
        recov, p_inject = recovery_update(cfg, state, jnp.max(log_weights))
        if p_inject is not None:
            # injection must force its own resample: a kidnap makes every
            # particle uniformly bad, so Neff RISES and the gate alone
            # would never fire
            do_resample = do_resample | (p_inject > 0.05)

        def resample(args):
            poses, log_weights = args
            idx = systematic_indices(k_resample, log_weights)
            new_lw = (jnp.zeros_like(log_weights)
                      if cfg.accumulate_weights
                      else jnp.take(log_weights, idx, axis=0))
            new_poses = jnp.take(poses, idx, axis=0)
            if p_inject is not None:
                new_poses, took = inject_uniform(
                    cfg, jax.random.fold_in(k_resample, 1), new_poses,
                    p_inject)
                new_lw = jnp.where(took, jnp.mean(new_lw), new_lw)
            return new_poses, new_lw

        poses, log_weights = jax.lax.cond(
            do_resample, resample, lambda a: a, (poses, log_weights))

        new_state = SharedMapState(poses=poses, log_weights=log_weights,
                                   logodds=logodds, key=key,
                                   step=state.step + 1, recov=recov)
        info = StepInfo(neff=n_eff, weighted_pose=weighted,
                        best_pose=best_pose, best_index=best_index,
                        best_log_weight=log_weights.max(),
                        resampled=do_resample)
        return new_state, info

    # ---------------------------------------------------------- surface step
    def step_surface(self, state: SharedMapState, frame: Frame
                     ) -> Tuple[SharedMapState, StepInfo]:
        """One SLAM update in SURFACE mode (ops/surface.py): the measurement
        likelihood is precomputed over (theta bins x cells) with one
        correlation, then every particle is weighted by ~8 trilinear taps
        and optionally hill-climb refined.  Cost per scan is O(volume) +
        O(P) tiny taps — the single-dispatch mode for 1M+ particles
        (BASELINE config 3), where per-particle candidate search is the
        wrong shape.  Same weighting/resampling/map-update tail as `step`.
        """
        import math as _math

        from ..ops.surface import refine_on_surface, sample_surface

        cfg = self.config
        mc = cfg.matcher

        scan = deskew_scan(frame.scan, frame.odom)
        lut = build_beam_lut(scan, cfg.beam_lut_bins)
        odom = frame.odom
        keep = (jnp.abs(odom.d_theta)
                <= _math.radians(cfg.skip_update_dtheta_deg)
                ).astype(state.logodds.dtype)
        if cfg.freeze_map:          # localization-only: map never changes
            keep = keep * 0.0

        # Volume center: the previous cloud's weighted mean PROPAGATED by
        # this frame's odometry — without the propagation the theta-bin
        # span is centered a full motion step behind the cloud, and a
        # 45 deg/scan turn puts the true heading outside +/-24 deg
        # entirely (round-4 finding: frozen-map localization error jumped
        # 0.005 -> 0.17 m exactly in the turn phase).
        center = apply_odometry(
            weighted_mean_pose(state.poses, state.log_weights), odom)
        # field build happens crop-locally inside surface_volume
        c_vol, kw, kc = surface_volume(cfg, self.kernel, state.logodds,
                                       scan, center)

        key, k_motion, k_resample = jax.random.split(state.key, 3)
        keys = jax.random.split(k_motion, cfg.num_particles)
        pose_s = jax.vmap(
            lambda k, p: sample_motion(k, p, odom, cfg.motion))(
                keys, state.poses)
        scores = sample_surface(c_vol, pose_s, **kw)
        poses, scores = refine_on_surface(
            c_vol, pose_s, scores, steps=mc.surface_refine_steps, **kw)
        scores = surface_temper(mc, scan, scores)

        # Integration only touches cells within max_range of the pose: crop
        # to 2*kc (+ slack) so the map-update cost is map-size independent.
        return self._finalize(
            state, key, k_resample, poses, scores, scan, lut, keep,
            integrate_crop=2 * kc + 8,
            resample_fraction=mc.surface_resample_fraction)

    def replay_surface(self, state, frames):
        return jax.lax.scan(lambda s, f: self.step_surface(s, f), state,
                            frames)

    def replay_surface_jit(self):
        return jax.jit(self.replay_surface, donate_argnums=(0,))

    def replay(self, state, frames):
        def body(s, f):
            return self.step(s, f)
        return jax.lax.scan(body, state, frames)

    def replay_jit(self):
        return jax.jit(self.replay, donate_argnums=(0,))

    def best_map(self, state: SharedMapState):
        """The (single, shared) log-odds map — interface parity with
        RBPF.best_map so app surfaces work with either engine."""
        return state.logodds
