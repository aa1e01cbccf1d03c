"""Map-sharded SURFACE-mode SLAM: the 1M-particle path composed with map
tiling.

Surface mode (one likelihood volume per scan, ~8 taps per particle)
replicates the FULL map and rebuilds the FULL volume on every shard in
parallel/shmap.py, while the map-tiled engine (parallel/tiled.py) serves
the per-particle matcher.  BASELINE config 5 (city-scale multi-robot)
needs both at once.  This module is that composition, on a ('p', 'm')
mesh:

- the log-odds map is sharded in COLUMN TILES over 'm' (same layout as
  parallel/tiled.py) and particles over 'p'; device (i, j) holds particle
  shard i and map tile j — per-device map memory is H*W/m cells, not H*W;
- the volume is computed over a CROP around the particle cloud (static
  size, dynamic center, as in models/shared.step_surface).  The RAW
  log-odds crop (extended by the blur radius) is assembled from the
  owning tiles by a masked column gather + one `psum` over 'm'
  (~(hc+2r) x (wc+2r) floats — ~1 MB for the city's 512^2 crop, vs
  64 MB to replicate the city map), and the likelihood field is built
  crop-locally and redundantly per device — no per-scan full-map work,
  no halo ppermutes;
- the correlation itself is sharded over 'm' BY THETA BIN: each map shard
  splats and correlates only its ceil(nt/m) bins against the assembled
  crop, then one `all_gather` over 'm' assembles the (nt, hc, wc) volume
  — the conv/FFT cost (the dominant per-scan term at city scale by its
  operation count) divides by m instead of being replicated;
- particle taps / hill-climb / weighting / distributed resampling run on
  the 'p' shards exactly as in parallel/shmap.py (volume semantics shared
  via models/shared.surface_volume's building blocks: theta_grid wrap,
  packed taps, weight temperature);
- map integration is tile-local: each tile updates only its (static-size)
  crop around the integration pose, so the update cost is bounded by the
  scan's reach (2*kc cells), not by tile size.  Cells outside every
  tile-crop are provably beyond max_range (delta = 0); the union of
  clamped tile-crops covers the scan's reach because each tile crop is
  >= 2*kc + 8 cells wide or the whole tile.

Per-device memory at BASELINE city scale (200x200 m @ 5 cm, crop 512,
nt 25, m = 8):  map tile 8 MB (was 64 MB replicated), assembled raw
crop + field ~1 MB each, volume 26 MB + packed tap neighborhoods 8x
~210 MB (all crop-sized — INDEPENDENT of map size; the packed array is
what makes each particle's trilinear sample one 8-wide gather).  Only
crop-sized state is replicated, so the design scales to arbitrarily large
maps.

Reference: none — new capability per SURVEY §2.10 (the reference is
single-threaded Java with one 6x6 m map).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..models.shared import (SharedMapSLAM, SharedMapState,
                             inject_uniform, integration_pose,
                             recovery_update, surface_temper)
from ..ops.geometry import deskew_scan, scan_points, wrap_angle
from ..ops.motion import apply_odometry, sample_motion
from ..ops.raycast import build_beam_lut, integrate_scan
from ..ops.resample import systematic_indices
from ..ops.surface import (crop_center_cells, pack_neighborhoods,
                           refine_on_surface, sample_surface, scan_surface,
                           splat_endpoint_kernels, theta_grid)
from ..ops.grid import likelihood_field
from ..ops.matcher import log_likelihood_field
from ..types import Frame, StepInfo
from .tiled import tiled_state_shardings

init_surface_sharded = None  # set below (shares init_tiled's layout)


def make_surface_sharded_step(engine: SharedMapSLAM, mesh: Mesh,
                              jit: bool = True):
    """Build the ('p', 'm') shard_map surface step (module docstring).
    Requires map width % m == 0; nt is padded up to a multiple of m for
    the bin sharding (the padded bins recompute bin 0's theta and are
    dropped after the gather).  jit=False returns the raw shard-mapped
    function for composition under lax.scan (single-dispatch replay,
    scripts/surface_sharded_bench.py)."""
    cfg = engine.config
    mc = cfg.matcher

    n_p = mesh.shape["p"]
    n_m = mesh.shape["m"]
    assert cfg.num_particles % n_p == 0
    h, w_total = cfg.map.cells_y, cfg.map.cells_x
    assert w_total % n_m == 0, (w_total, n_m)
    w_loc = w_total // n_m
    p_loc = cfg.num_particles // n_p
    origin = (float(cfg.map.origin[0]), float(cfg.map.origin[1]))
    res = float(cfg.map.resolution)

    # --- static surface-mode geometry (same derivations as
    # models/shared.surface_volume; kept static so every shard agrees) ---
    # crop_cells == 0 = FULL map, also non-square (models/shared semantics)
    if mc.surface_crop_cells > 0:
        hc = min(mc.surface_crop_cells, h)
        wc = min(mc.surface_crop_cells, w_total)
    else:
        hc, wc = h, w_total
    nt = mc.surface_nt
    dtheta, wrap_theta, t_off = theta_grid(
        nt, math.radians(mc.surface_theta_span_deg))
    kc = int(math.ceil(cfg.sensor.max_range / res)) + 2
    use_fft = (mc.surface_corr == "fft"
               or (mc.surface_corr == "auto"
                   and nt * (2 * kc + 1) ** 2 * hc * wc > 2e10))
    ll_outside = math.log(1.0 / cfg.sensor.max_range)
    # theta bins sharded over 'm', padded to a multiple (city: nt=25 on
    # m=8 -> 4 bins/shard, 7 padded bins dropped after the all_gather)
    nt_loc = -(-nt // n_m)
    # tile-local integration crop (>= scan reach 2*kc+1, or whole tile)
    ic = min(2 * kc + 8, h)
    icw = min(2 * kc + 8, w_loc)
    # raw-crop extension for the crop-local field build (blur radius halo
    # — same exactness argument as models/shared.surface_volume)
    r = cfg.map.likelihood_radius
    hce, wce = min(hc + 2 * r, h), min(wc + 2 * r, w_total)

    def shard_fn(state: SharedMapState, frame: Frame):
        my_p = jax.lax.axis_index("p")
        my_m = jax.lax.axis_index("m")
        scan = deskew_scan(frame.scan, frame.odom)
        lut = build_beam_lut(scan, cfg.beam_lut_bins)
        odom = frame.odom
        keep = (jnp.abs(odom.d_theta)
                <= math.radians(cfg.skip_update_dtheta_deg)
                ).astype(state.logodds.dtype)
        if cfg.freeze_map:          # localization-only: map never changes
            keep = keep * 0.0

        # ---- volume center: previous cloud's global weighted mean,
        # propagated by this frame's odometry (models/shared semantics) ----
        m0 = jax.lax.pmax(jnp.max(state.log_weights), "p")
        e0 = jnp.exp(state.log_weights - m0)
        z0 = jax.lax.psum(jnp.sum(e0), "p")
        w0 = e0 / z0
        center = apply_odometry(jax.lax.psum(jnp.stack(
            [jnp.sum(state.poses[:, 0] * w0),
             jnp.sum(state.poses[:, 1] * w0),
             jnp.sum(wrap_angle(state.poses[:, 2]) * w0)]), "p"), odom)

        # ---- raw log-odds crop assembly (extended by the blur radius):
        # masked column gather + one psum over 'm'.  The likelihood field
        # is then built CROP-LOCALLY, redundantly per device (a ~(crop +
        # 2r)^2 blur — trivial), instead of a full-map tiled blur + halo
        # exchanges whose cost grows with the map
        iy0, ix0 = crop_center_cells(center[:2], (hc, wc), (h, w_total),
                                     res, origin)
        ey0 = jnp.clip(iy0 - r, 0, h - hce)
        ex0 = jnp.clip(ix0 - r, 0, w_total - wce)
        rows = jax.lax.dynamic_slice(state.logodds, (ey0, jnp.int32(0)),
                                     (hce, w_loc))
        local_cols = ex0 + jnp.arange(wce, dtype=jnp.int32) - my_m * w_loc
        owned = (local_cols >= 0) & (local_cols < w_loc)
        piece = (jnp.take(rows, jnp.clip(local_cols, 0, w_loc - 1), axis=1)
                 * owned[None, :].astype(rows.dtype))
        lo_ext = jax.lax.psum(piece, "m")            # (hce, wce) replicated
        field, unknown = likelihood_field(lo_ext, engine.kernel)
        llf_ext = log_likelihood_field(field, unknown, mc.z_hit,
                                       cfg.sensor.max_range)
        llf_crop = jax.lax.dynamic_slice(llf_ext, (iy0 - ey0, ix0 - ex0),
                                         (hc, wc))

        # ---- bin-sharded correlation: my nt_loc bins only ----
        theta0 = center[2] + t_off
        bins = my_m * nt_loc + jnp.arange(nt_loc, dtype=jnp.int32)
        thetas = theta0 + dtheta * jnp.minimum(bins, nt - 1).astype(
            jnp.float32)                                 # pad bins recompute
        px, py = scan_points(scan)
        wgt = (scan.valid & scan.hit).astype(llf_crop.dtype)
        e_stack = splat_endpoint_kernels(px, py, wgt, thetas, kc, res)
        c_local = scan_surface(llf_crop, e_stack, ll_outside,
                               bf16=mc.surface_bf16, fft=use_fft)
        c_all = jax.lax.all_gather(c_local, "m", tiled=True)
        c_vol = c_all[:nt]                               # drop padded bins
        tap_kw = dict(theta0=theta0, dtheta=dtheta, crop_iy0=iy0,
                      crop_ix0=ix0, resolution=res, origin=origin,
                      wrap_theta=wrap_theta,
                      packed=pack_neighborhoods(c_vol, wrap_theta))

        # ---- particle taps + weighting on the 'p' shards ----
        key, k_motion, k_resample = jax.random.split(state.key, 3)
        keys = jax.random.split(jax.random.fold_in(k_motion, my_p), p_loc)
        pose_s = jax.vmap(
            lambda k, p_: sample_motion(k, p_, odom, cfg.motion))(
                keys, state.poses)
        scores = sample_surface(c_vol, pose_s, **tap_kw)
        poses, scores = refine_on_surface(
            c_vol, pose_s, scores, steps=mc.surface_refine_steps, **tap_kw)
        scores = surface_temper(mc, scan, scores)

        lw = scores.astype(state.log_weights.dtype)
        if cfg.accumulate_weights:
            lw = lw + state.log_weights

        # ---- global weight statistics over 'p' (parallel/shmap.py) ----
        m_ = jax.lax.pmax(jnp.max(lw), "p")
        # AMCL recovery EMAs on the replicated global max log-weight
        # (models/shared.recovery_update; round-5)
        recov, p_inject = recovery_update(cfg, state, m_)

        e = jnp.exp(lw - m_)
        z = jax.lax.psum(jnp.sum(e), "p")
        w_n = e / z
        n_eff = 1.0 / jax.lax.psum(jnp.sum(w_n * w_n), "p")
        weighted = jax.lax.psum(
            jnp.stack([jnp.sum(poses[:, 0] * w_n),
                       jnp.sum(poses[:, 1] * w_n),
                       jnp.sum(wrap_angle(poses[:, 2]) * w_n)]), "p")

        li = jnp.argmax(lw)
        cand = jnp.concatenate([lw[li][None], poses[li]])
        all_cand = jax.lax.all_gather(cand, "p")
        gbest = jnp.argmax(all_cand[:, 0])
        best_pose = all_cand[gbest, 1:]
        best_lw = all_cand[gbest, 0]
        best_index = gbest * p_loc + jax.lax.psum(
            jnp.where(jax.lax.axis_index("p") == gbest, li, 0), "p")

        # ---- tile-local crop integration ----
        integ_pose = integration_pose(n_eff, cfg.num_particles, weighted,
                                      best_pose)
        cx = (integ_pose[0] - origin[0]) / res
        cy = (integ_pose[1] - origin[1]) / res
        riy0 = jnp.clip(jnp.round(cy).astype(jnp.int32) - ic // 2, 0, h - ic)
        rix0 = jnp.clip(jnp.round(cx).astype(jnp.int32) - my_m * w_loc
                        - icw // 2, 0, w_loc - icw)
        lo_crop = jax.lax.dynamic_slice(state.logodds, (riy0, rix0),
                                        (ic, icw))
        tile_x0 = origin[0] + (my_m * w_loc + rix0) * res
        tile_y0 = origin[1] + riy0 * res
        delta = integrate_scan(
            lo_crop, integ_pose, scan, lut, resolution=res,
            origin=(tile_x0, tile_y0), l_free=cfg.sensor.l_free,
            l_occ=cfg.sensor.l_occ,
            tol_cells=cfg.sensor.hit_tolerance_cells)
        logodds = jax.lax.dynamic_update_slice(
            state.logodds, lo_crop + keep * delta, (riy0, rix0))

        # ---- distributed systematic resampling over 'p' (surface gate,
        # config.surface_resample_fraction) ----
        do_resample = n_eff < (cfg.num_particles
                               * cfg.matcher.surface_resample_fraction)
        if p_inject is not None:
            # a kidnap RAISES Neff (uniformly bad particles), so injection
            # must force its own resample
            do_resample = do_resample | (p_inject > 0.05)


        def resample(_):
            # gated all_gathers + shared-key global sort-rank indices
            # (see parallel/shmap.py)
            lw_all = jax.lax.all_gather(lw, "p", tiled=True)
            poses_all = jax.lax.all_gather(poses, "p", tiled=True)
            idx_all = systematic_indices(k_resample, lw_all)
            idx = jax.lax.dynamic_slice(idx_all, (my_p * p_loc,), (p_loc,))
            new_lw = (jnp.zeros((p_loc,), lw_all.dtype)
                      if cfg.accumulate_weights else lw_all[idx])
            new_poses = poses_all[idx]
            if p_inject is not None:
                new_poses, took = inject_uniform(
                    cfg, jax.random.fold_in(k_resample, 1000 + my_p),
                    new_poses, p_inject, slot_offset=my_p * p_loc)
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

    state_spec = SharedMapState(poses=P("p", None), log_weights=P("p"),
                                logodds=P(None, "m"), key=P(), step=P(),
                                recov=P())
    info_spec = StepInfo(neff=P(), weighted_pose=P(), best_pose=P(),
                         best_index=P(), best_log_weight=P(), resampled=P())
    fn = jax.shard_map(shard_fn, mesh=mesh,
                       in_specs=(state_spec, P()),
                       out_specs=(state_spec, info_spec),
                       check_vma=False)
    return jax.jit(fn) if jit else fn


def init_surface_sharded(engine: SharedMapSLAM, key,              # noqa: F811
                         mesh: Mesh) -> SharedMapState:
    """State init on the ('p', 'm') layout (same shardings as the tiled
    engine: poses over 'p', map columns over 'm')."""
    init = jax.jit(engine.init, out_shardings=tiled_state_shardings(mesh))
    return init(key)
