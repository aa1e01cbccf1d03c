"""Explicit-collective distributed SLAM step (shard_map + psum/all_gather).

The GSPMD path (parallel/sharded.py) lets XLA infer collectives; this module
is the hand-scheduled equivalent for the scalable shared-map engine, where
every cross-device exchange is an explicit collective:

- particles (poses + log-weights) sharded over mesh axis 'p'; the shared map
  is replicated (64 MB even for a 200x200 m @ 5 cm grid — map *tiling* over
  a second axis is only needed for multi-host city-scale worlds);
- per-shard: motion sampling + correlative matching, zero communication;
- weight normalization / Neff / weighted pose: psum/pmax reductions;
- strongest particle: all_gather of per-shard (score, pose) maxima;
- distributed systematic resampling: all_gather of log-weights (P floats)
  and poses (P x 3) — cheap because the shared-map design keeps the
  per-particle state tiny — then every shard deterministically computes the
  same global ancestor indices (same PRNG key) and gathers its local slice;
- map integration: computed redundantly per shard from the globally-agreed
  best pose (replicated compute instead of a broadcast).

This is the SURVEY §2.10 "particle parallelism" design; scans/s should scale
linearly in devices until the replicated map update dominates.
"""

from __future__ import annotations

import math
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.shared import (SharedMapSLAM, SharedMapState,
                             inject_uniform, integration_pose,
                             recovery_update)
from ..ops.geometry import deskew_scan, wrap_angle
from ..ops.grid import likelihood_field
from ..ops.matcher import correlative_match, log_likelihood_field
from ..ops.motion import apply_odometry, sample_motion
from ..ops.raycast import build_beam_lut, integrate_scan
from ..ops.resample import systematic_indices
from ..types import Frame, StepInfo


def shared_state_shardings(mesh: Mesh) -> SharedMapState:
    return SharedMapState(
        poses=NamedSharding(mesh, P("p", None)),
        log_weights=NamedSharding(mesh, P("p")),
        logodds=NamedSharding(mesh, P()),
        key=NamedSharding(mesh, P()),
        step=NamedSharding(mesh, P()),
        recov=NamedSharding(mesh, P()),
    )


def make_shmap_step(engine: SharedMapSLAM, mesh: Mesh,
                    surface: bool = False):
    """Build the jitted shard_map step for a SharedMapSLAM engine.

    surface=True swaps the per-particle correlative matcher for the
    likelihood-volume path (models/shared.step_surface semantics): the
    volume is built REDUNDANTLY on every shard (replicated compute — one
    correlation each, no communication, like the map update) and each shard
    taps it for its local particles; weighting/resampling collectives are
    identical."""
    cfg = engine.config
    n_shards = mesh.shape["p"]

    assert cfg.num_particles % n_shards == 0
    p_loc = cfg.num_particles // n_shards
    origin = (float(cfg.map.origin[0]), float(cfg.map.origin[1]))
    res = float(cfg.map.resolution)

    def shard_fn(state: SharedMapState, frame: Frame):
        my = jax.lax.axis_index("p")
        scan = deskew_scan(frame.scan, frame.odom)
        lut = build_beam_lut(scan, cfg.beam_lut_bins)
        odom = frame.odom
        keep = (jnp.abs(odom.d_theta)
                <= math.radians(cfg.skip_update_dtheta_deg)
                ).astype(state.logodds.dtype)
        if cfg.freeze_map:          # localization-only: map never changes
            keep = keep * 0.0       # (round-4 ADVICE: was models/-only)

        key, k_motion, k_resample = jax.random.split(state.key, 3)
        k_local = jax.random.fold_in(k_motion, my)
        keys = jax.random.split(k_local, p_loc)

        if surface:
            from ..models.shared import surface_temper, surface_volume
            from ..ops.surface import refine_on_surface, sample_surface
            mc = cfg.matcher
            # global weighted mean of the PREVIOUS cloud, PROPAGATED by
            # this frame's odometry -> volume center (identical semantics
            # to models/shared.step_surface; the un-propagated center was
            # the round-4 ADVICE medium finding — 0.005 -> 0.17 m
            # turn-phase error on the sharded engine)
            m0 = jax.lax.pmax(jnp.max(state.log_weights), "p")
            e0 = jnp.exp(state.log_weights - m0)
            z0 = jax.lax.psum(jnp.sum(e0), "p")
            w0 = e0 / z0
            center = apply_odometry(jax.lax.psum(jnp.stack(
                [jnp.sum(state.poses[:, 0] * w0),
                 jnp.sum(state.poses[:, 1] * w0),
                 jnp.sum(wrap_angle(state.poses[:, 2]) * w0)]), "p"), odom)
            # volume built REDUNDANTLY per shard (replicated compute, no
            # communication); semantics shared with step_surface via
            # surface_volume (crop-local field build, wrap_theta, FFT
            # auto, packed taps included)
            c_vol, kw, _kc = surface_volume(cfg, engine.kernel,
                                            state.logodds, scan, center)
            pose_s = jax.vmap(
                lambda k, p_: sample_motion(k, p_, odom, cfg.motion))(
                    keys, state.poses)
            scores = sample_surface(c_vol, pose_s, **kw)
            poses, scores = refine_on_surface(
                c_vol, pose_s, scores, steps=mc.surface_refine_steps, **kw)
            scores = surface_temper(mc, scan, scores)
        else:
            field, unknown = likelihood_field(state.logodds, engine.kernel)
            llf = log_likelihood_field(field, unknown, cfg.matcher.z_hit,
                                       cfg.sensor.max_range)

            def particle(pose, k):
                pose_s = sample_motion(k, pose, odom, cfg.motion)
                return correlative_match(
                    llf, scan, pose_s, odom, matcher_cfg=cfg.matcher,
                    motion_cfg=cfg.motion, resolution=res, origin=origin,
                    max_range=cfg.sensor.max_range,
                    prior_center=apply_odometry(pose, odom))

            poses, scores = jax.vmap(particle)(state.poses, keys)
        lw = scores.astype(state.log_weights.dtype)          # (p_loc,)
        if cfg.accumulate_weights:   # SIS mode, same as models/rbpf.py
            lw = lw + state.log_weights

        # ---- global weight statistics over 'p' ----
        m = jax.lax.pmax(jnp.max(lw), "p")
        # AMCL recovery EMAs on the replicated global max log-weight
        # (models/shared.recovery_update; round-5)
        recov, p_inject = recovery_update(cfg, state, m)

        e = jnp.exp(lw - m)
        z = jax.lax.psum(jnp.sum(e), "p")
        w = e / z                                            # globally normed
        n_eff = 1.0 / jax.lax.psum(jnp.sum(w * w), "p")
        weighted = jax.lax.psum(
            jnp.stack([jnp.sum(poses[:, 0] * w), jnp.sum(poses[:, 1] * w),
                       jnp.sum(wrap_angle(poses[:, 2]) * w)]), "p")

        # ---- global strongest particle ----
        li = jnp.argmax(lw)
        cand = jnp.concatenate([lw[li][None], poses[li]])    # (4,)
        all_cand = jax.lax.all_gather(cand, "p")             # (n_shards, 4)
        gbest = jnp.argmax(all_cand[:, 0])
        best_pose = all_cand[gbest, 1:]
        best_lw = all_cand[gbest, 0]
        best_index = gbest * p_loc + jax.lax.psum(
            jnp.where(jax.lax.axis_index("p") == gbest, li, 0), "p")

        # ---- map update (redundant replicated compute) ----
        integ_pose = integration_pose(n_eff, cfg.num_particles, weighted,
                                      best_pose)
        delta = integrate_scan(
            state.logodds, integ_pose, scan, lut, resolution=res,
            origin=origin, l_free=cfg.sensor.l_free, l_occ=cfg.sensor.l_occ,
            tol_cells=cfg.sensor.hit_tolerance_cells)
        logodds = state.logodds + keep * delta

        # ---- distributed systematic resampling ----
        rf = (cfg.matcher.surface_resample_fraction if surface
              else cfg.resample_fraction)
        do_resample = n_eff < (cfg.num_particles * rf)
        if p_inject is not None:
            # a kidnap RAISES Neff (uniformly bad particles), so injection
            # must force its own resample
            do_resample = do_resample | (p_inject > 0.05)


        def resample(_):
            # the all_gathers live INSIDE the gated branch: 16 bytes per
            # particle of (pose, log-weight) traffic flows only on scans
            # that actually resample (n_eff is replicated, so every shard
            # takes the same branch) — with tempered weights this is the
            # difference between per-scan and occasional cross-host
            # traffic (round-5; see docs/scaling_cpu.md comm model).
            # Every shard computes the SAME global ancestor indices from
            # the shared key (systematic_indices: the sort-rank form) and
            # slices its segment.
            lw_all = jax.lax.all_gather(lw, "p", tiled=True)      # (P,)
            poses_all = jax.lax.all_gather(poses, "p", tiled=True)  # (P,3)
            idx_all = systematic_indices(k_resample, lw_all)
            idx = jax.lax.dynamic_slice(idx_all, (my * p_loc,), (p_loc,))
            new_lw = (jnp.zeros((p_loc,), lw_all.dtype)
                      if cfg.accumulate_weights else lw_all[idx])
            new_poses = poses_all[idx]
            if p_inject is not None:
                new_poses, took = inject_uniform(
                    cfg, jax.random.fold_in(k_resample, 1000 + my),
                    new_poses, p_inject, slot_offset=my * p_loc)
                gmean = (jax.lax.psum(jnp.sum(new_lw), "p")
                         / cfg.num_particles)
                new_lw = jnp.where(took, gmean, new_lw)
            return new_poses, new_lw

        poses, lw = jax.lax.cond(do_resample, resample,
                                 lambda _: (poses, lw), None)

        new_state = SharedMapState(poses=poses, log_weights=lw,
                                   logodds=logodds, key=key,
                                   step=state.step + 1,
                                   recov=recov)
        info = StepInfo(neff=n_eff, weighted_pose=weighted,
                        best_pose=best_pose, best_index=best_index,
                        best_log_weight=best_lw, resampled=do_resample)
        return new_state, info

    sh = shared_state_shardings(mesh)
    info_spec = StepInfo(neff=P(), weighted_pose=P(), best_pose=P(),
                         best_index=P(), best_log_weight=P(), resampled=P())
    state_spec = SharedMapState(poses=P("p", None), log_weights=P("p"),
                                logodds=P(), key=P(), step=P(),
                                recov=P())
    frame_spec = jax.tree.map(lambda _: P(), Frame(
        scan=None, odom=None, t=None), is_leaf=lambda x: x is None)

    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(state_spec, frame_spec),
        out_specs=(state_spec, info_spec),
        check_vma=False,
    )
    return jax.jit(fn)


def init_shmap(engine: SharedMapSLAM, key, mesh: Mesh) -> SharedMapState:
    # Produce the state THROUGH jit with out_shardings (rather than
    # device_put after the fact) so it also works in multi-process meshes,
    # where host-local arrays cannot be device_put onto non-addressable
    # shardings.
    init = jax.jit(engine.init,
                   out_shardings=shared_state_shardings(mesh))
    return init(key)
