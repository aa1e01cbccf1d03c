"""Tiled-map distributed SLAM: map columns sharded over 'm', particles over
'p', every exchange an explicit collective.

The city-scale design (BASELINE configs 3/5): a grid too large to replicate
is split into column tiles, one per device along mesh axis 'm', while the
particle belief shards over axis 'p' (replicated across 'm', since every
particle's scan spans the whole map).  Device (i, j) holds particle shard i
and map tile j.

Communication structure per scan:
- blur halo exchange: the likelihood field's separable blur needs
  `radius` columns from each neighbor tile — two `ppermute` shifts along
  'm' (zero columns at the world edge, matching the reference blur's
  zero-padding, app/Util.java:396);
- LL halo: one extra column per side so bilinear corner gathers near tile
  boundaries stay local;
- scan-match scores: each tile scores ONLY the candidate-beam endpoints it
  owns (owner = tile of the bilinear base column; out-of-world beams are
  owned by tile 0) and the per-beam partial log-likelihoods are `psum`med
  over 'm' — a beam is counted exactly once;
- weight stats / resampling / strongest-particle election: same collectives
  as parallel/shmap.py, over 'p';
- map integration: cell-local by construction (the dense update needs no
  ray halo at all — SURVEY §7's "halo-correct tiled raycasting" problem
  vanishes in the gather formulation); each tile integrates its slice with
  its own world offset.

Requires map width % m == 0.
"""

from __future__ import annotations

import math
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.shared import (SharedMapSLAM, SharedMapState,
                             inject_uniform, integration_pose,
                             recovery_update)
from ..ops.geometry import deskew_scan, scan_points, wrap_angle
from ..ops.grid import threshold_occupancy
from ..ops.matcher import _argmax3, _prior_grid, resolve_impl
from ..ops.geometry import wrap_angle as _wrap
from ..ops.motion import apply_odometry, noise_scales, sample_motion
from ..ops.raycast import build_beam_lut, integrate_scan
from ..ops.resample import systematic_indices
from ..types import Frame, StepInfo


# ------------------------------------------------------------------ halo ops
def _halo_exchange_cols(tile, width: int, axis_name: str,
                        fill: float = 0.0):
    """Append `width` columns from the left/right neighbor tiles along
    `axis_name` (`fill` at the world edges: 0 for the blur's zero
    boundary, ll_outside for scoring frames whose clamped taps must read
    out-of-map).  tile: (H, Wt) -> (H, Wt + 2*width)."""
    n = jax.lax.axis_size(axis_name)
    # my right edge -> right neighbor's left halo
    right_going = [(i, (i + 1) % n) for i in range(n)]
    left_going = [(i, (i - 1) % n) for i in range(n)]
    from_left = jax.lax.ppermute(tile[:, -width:], axis_name, right_going)
    from_right = jax.lax.ppermute(tile[:, :width], axis_name, left_going)
    j = jax.lax.axis_index(axis_name)
    edge = jnp.full_like(from_left, fill)
    from_left = jnp.where(j == 0, edge, from_left)
    from_right = jnp.where(j == n - 1, edge, from_right)
    return jnp.concatenate([from_left, tile, from_right], axis=1)


def _blur_tiled(img_tile, kernel: np.ndarray, axis_name: str):
    """Separable blur of a column tile with halo exchange; zero boundary at
    the world edges (identical semantics to ops/grid.blur_separable)."""
    k = (len(kernel) - 1) // 2
    h, wt = img_tile.shape
    ext = _halo_exchange_cols(img_tile, k, axis_name)       # (H, Wt+2k)
    horiz = jnp.zeros_like(img_tile)
    for i, kv in enumerate(kernel):
        horiz = horiz + kv * ext[:, i:i + wt]
    pad = jnp.pad(horiz, ((k, k), (0, 0)))
    out = jnp.zeros_like(img_tile)
    for i, kv in enumerate(kernel):
        out = out + kv * pad[i:i + h, :]
    return out


def _ll_field_tiled(logodds_tile, kernel, z_hit, max_range, axis_name):
    """threshold -> tiled blur -> unknown detection -> log-likelihood, on a
    column tile (composition of ops/grid.likelihood_field +
    ops/matcher.log_likelihood_field with halo exchange)."""
    p1 = threshold_occupancy(logodds_tile)
    field = _blur_tiled(p1, kernel, axis_name)
    evid = (jnp.abs(p1 - 0.5) > 0.25).astype(logodds_tile.dtype)
    evidence = _blur_tiled(evid, kernel, axis_name)
    unknown = evidence <= 0.0
    uniform = 1.0 / max_range
    v_eq = (uniform - (1.0 - z_hit) * uniform) / z_hit
    v = jnp.where(unknown, v_eq, field)
    return jnp.log(z_hit * v + (1.0 - z_hit) * uniform)


# ------------------------------------------------------- tiled stage scoring
def _stage_scores_tiled(ll_ext, px, py, use, pose0, dxs, dys, dts, *,
                        resolution, origin, max_range, w_total, h,
                        tile_j, w_loc, ext):
    """Per-tile partial stage scores; summing over 'm' (done by the caller
    via psum) reproduces ops/matcher._stage_scores on the full map.

    ll_ext: (H, w_loc + 2*ext) LL tile extended by `ext` columns each side.
    tile_j: this tile's index along 'm'."""
    ll_outside = math.log(1.0 / max_range)

    theta = pose0[2] + dts
    c, s = jnp.cos(theta)[:, None], jnp.sin(theta)[:, None]
    rx = px[None, :] * c - py[None, :] * s
    ry = px[None, :] * s + py[None, :] * c
    wx = rx[:, None, :] + (pose0[0] + dxs)[None, :, None]   # (nt, nx, B)
    wy = ry[:, None, :] + (pose0[1] + dys)[None, :, None]   # (nt, ny, B)
    fx = (wx - origin[0]) / resolution - 0.5
    fy = (wy - origin[1]) / resolution - 0.5

    x0 = jnp.floor(fx).astype(jnp.int32)                    # (nt, nx, B)
    y0 = jnp.floor(fy).astype(jnp.int32)                    # (nt, ny, B)
    tx = (fx - x0)[:, None, :, :]                           # (nt,1,nx,B)
    ty = (fy - y0)[:, :, None, :]                           # (nt,ny,1,B)

    # ownership: tile of the base column; out-of-world west -> tile 0,
    # east -> last tile (clip).
    n_tiles = max(w_total // w_loc, 1)
    owner = jnp.clip(x0 // w_loc, 0, n_tiles - 1)
    mine = owner == tile_j                                  # (nt, nx, B)

    lx0 = x0 - (tile_j * w_loc - ext)                       # local ext coords
    we = w_loc + 2 * ext
    flat = ll_ext.reshape(-1)

    def corner(dx_c, dy_c):
        xi = lx0 + dx_c                                     # (nt, nx, B)
        yi = y0 + dy_c                                      # (nt, ny, B)
        # global-bounds test (world, not tile)
        gin_x = ((x0 + dx_c) >= 0) & ((x0 + dx_c) < w_total)
        gin_y = (yi >= 0) & (yi < h)
        xi = jnp.clip(xi, 0, we - 1)
        yi = jnp.clip(yi, 0, h - 1)
        idx = yi[:, :, None, :] * we + xi[:, None, :, :]    # (nt,ny,nx,B)
        val = flat[idx]
        inb = gin_y[:, :, None, :] & gin_x[:, None, :, :]
        return jnp.where(inb, val, ll_outside)

    v00 = corner(0, 0)
    v10 = corner(1, 0)
    v01 = corner(0, 1)
    v11 = corner(1, 1)
    ll = ((1 - tx) * (1 - ty) * v00 + tx * (1 - ty) * v10
          + (1 - tx) * ty * v01 + tx * ty * v11)
    mask = use[None, None, None, :] & mine[:, None, :, :]
    return jnp.sum(jnp.where(mask, ll, 0.0), axis=-1)       # (nt, ny, nx)


def _stage_scores_tiled_matmul(ll_ext, px, py, use, pose0, dxs, dys, dts, *,
                               resolution, origin, max_range, w_total, h,
                               tile_j, w_loc, ext, nearest=False,
                               bf16=False):
    """Matrix-contraction formulation of _stage_scores_tiled: same per-tile
    partial scores, zero random gathers (the tiled counterpart of
    ops/matcher_matmul.py).

    Bilinear taps become two-tap one-hot contractions against the
    2-cell ll_outside-banded tile frame (exact matcher_matmul semantics:
    clamped taps land in the band); tap ownership (the psum-exactly-once
    rule: owner = tile of the base column) is folded into the a_x one-hot
    weights.  Callers must build ll_ext with _halo_exchange_cols(...,
    fill=ll_outside) so world-edge halos read as out-of-map, not as the
    blur's zero boundary."""
    from ..ops.matcher_matmul import _taps

    pad = 2
    ll_outside = math.log(1.0 / max_range)
    fpad = jnp.pad(ll_ext, ((pad, pad), (pad, pad)),
                   constant_values=ll_outside)
    hp, wep = fpad.shape
    dtype = fpad.dtype
    inv_res = 1.0 / resolution

    theta = pose0[2] + dts
    c, s = jnp.cos(theta)[:, None], jnp.sin(theta)[:, None]
    rx = px[None, :] * c - py[None, :] * s
    ry = px[None, :] * s + py[None, :] * c
    fx_g = ((rx[:, None, :] + (pose0[0] + dxs)[None, :, None] - origin[0])
            * inv_res - 0.5)                                 # (nt, nx, B)
    fy = ((ry[:, None, :] + (pose0[1] + dys)[None, :, None] - origin[1])
          * inv_res - 0.5 + pad)                             # (nt, ny, B)

    n_tiles = max(w_total // w_loc, 1)
    x0g = jnp.floor(fx_g).astype(jnp.int32)
    mine = (jnp.clip(x0g // w_loc, 0, n_tiles - 1) == tile_j)
    fx_l = fx_g - (tile_j * w_loc - ext).astype(dtype) + pad

    wgt = use.astype(dtype)
    a_y = _taps(fy, hp, nearest, dtype) * wgt[None, None, :, None]
    a_x = _taps(fx_l, wep, nearest, dtype) * mine.astype(dtype)[..., None]
    if bf16:
        # range-center the band value out of the field first; the shift
        # adds f_shift * (sum of surviving tap mass) per candidate — with
        # ownership masking that mass is sum_b wgt_b * mine, which the
        # a_x row sums recover exactly (bilinear taps sum to 1).
        f_shift = -0.5 * ll_outside
        g = jax.lax.dot_general(
            a_y.reshape(-1, hp).astype(jnp.bfloat16),
            (fpad + f_shift).astype(jnp.bfloat16),
            (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32).reshape(a_y.shape[:-1]
                                                        + (wep,))
        srt = jnp.sum(g.astype(jnp.float32)[:, :, None]
                      * a_x.astype(jnp.float32)[:, None], axis=(-2, -1))
        mass = jnp.sum(a_x, axis=-1)                         # (nt, nx, B)
        mass = jnp.sum(mass * wgt[None, None, :], axis=-1)   # (nt, nx)
        return srt - f_shift * mass[:, None, :]
    g = jnp.einsum("tybh,hw->tybw", a_y, fpad,
                   precision=jax.lax.Precision.HIGHEST)
    return jnp.sum(g[:, :, None] * a_x[:, None], axis=(-2, -1))


def _match_tiled(ll_ext, scan, pose0, odom, *, mcfg, motion_cfg, resolution,
                 origin, max_range, w_total, h, tile_j, w_loc, ext,
                 axis_name, prior_center=None):
    """Correlative match with per-tile partial scores psum'd over 'm'."""
    px, py = scan_points(scan)
    use = scan.valid & scan.hit
    sd_c, sd_t = noise_scales(odom, motion_cfg)
    if prior_center is None:
        bias = None
    else:
        bias = (pose0[0] - prior_center[0], pose0[1] - prior_center[1],
                _wrap(pose0[2] - prior_center[2]))
    wt_rad = math.radians(mcfg.window_theta_deg)
    kw = dict(resolution=resolution, origin=origin, max_range=max_range,
              w_total=w_total, h=h, tile_j=tile_j, w_loc=w_loc, ext=ext)
    impl = resolve_impl(mcfg.impl)
    if impl == "matmul":
        def _scores(pxx, pyy, uss, p0, dxs_, dys_, dts_, **kw2):
            return _stage_scores_tiled_matmul(
                ll_ext, pxx, pyy, uss, p0, dxs_, dys_, dts_,
                bf16=bool(getattr(mcfg, "matmul_bf16", False)), **kw2)
    else:
        def _scores(pxx, pyy, uss, p0, dxs_, dys_, dts_, **kw2):
            return _stage_scores_tiled(ll_ext, pxx, pyy, uss, p0, dxs_,
                                       dys_, dts_, **kw2)

    c_dxs = jnp.asarray(np.linspace(-mcfg.window_xy, mcfg.window_xy,
                                    mcfg.coarse_nxy), jnp.float32)
    c_dts = jnp.asarray(np.linspace(-wt_rad, wt_rad, mcfg.coarse_nt),
                        jnp.float32)
    # coarse-stage beam thinning (ops/matcher.correlative_match does the
    # same; refine stages rescore every beam)
    stride = max(int(mcfg.coarse_beam_stride), 1)
    px_c, py_c, use_c = px[::stride], py[::stride], use[::stride]
    n_all = jnp.maximum(jnp.sum(use.astype(jnp.float32)), 1.0)
    n_c = jnp.maximum(jnp.sum(use_c.astype(jnp.float32)), 1.0)
    meas = jax.lax.psum(
        _scores(px_c, py_c, use_c, pose0, c_dxs, c_dxs, c_dts, **kw),
        axis_name)
    total = meas + (n_c / n_all) * _prior_grid(c_dxs, c_dxs, c_dts, sd_c,
                                               sd_t, mcfg.prior_weight, bias)
    fx, fy, ft, flat = _argmax3(total, c_dxs, c_dxs, c_dts)
    meas_best = (n_all / n_c) * meas.reshape(-1)[flat]

    step_xy = 2.0 * mcfg.window_xy / max(mcfg.coarse_nxy - 1, 1)
    step_t = 2.0 * wt_rad / max(mcfg.coarse_nt - 1, 1)
    for _ in range(1 + mcfg.extra_refine_stages):
        off_xy = jnp.asarray(np.linspace(-step_xy, step_xy, mcfg.fine_nxy),
                             jnp.float32)
        off_t = jnp.asarray(np.linspace(-step_t, step_t, mcfg.fine_nt),
                            jnp.float32)
        r_dxs, r_dys, r_dts = fx + off_xy, fy + off_xy, ft + off_t
        meas_r = jax.lax.psum(
            _scores(px, py, use, pose0, r_dxs, r_dys, r_dts, **kw),
            axis_name)
        total_r = meas_r + _prior_grid(r_dxs, r_dys, r_dts, sd_c, sd_t,
                                       mcfg.prior_weight, bias)
        fx, fy, ft, flat = _argmax3(total_r, r_dxs, r_dys, r_dts)
        meas_best = meas_r.reshape(-1)[flat]
        step_xy = 2.0 * step_xy / max(mcfg.fine_nxy - 1, 1)
        step_t = 2.0 * step_t / max(mcfg.fine_nt - 1, 1)

    best_pose = jnp.stack([pose0[0] + fx, pose0[1] + fy, pose0[2] + ft])
    return best_pose, meas_best


# ----------------------------------------------------------------- the step
def tiled_state_shardings(mesh: Mesh) -> SharedMapState:
    return SharedMapState(
        poses=NamedSharding(mesh, P("p", None)),
        log_weights=NamedSharding(mesh, P("p")),
        logodds=NamedSharding(mesh, P(None, "m")),
        key=NamedSharding(mesh, P()),
        step=NamedSharding(mesh, P()),
        recov=NamedSharding(mesh, P()),
    )


def make_tiled_step(engine: SharedMapSLAM, mesh: Mesh):
    """shard_map step: particles over 'p', map columns over 'm'."""
    cfg = engine.config
    n_p = mesh.shape["p"]

    n_m = mesh.shape["m"]
    assert cfg.num_particles % n_p == 0
    w_total, h = cfg.map.cells_x, cfg.map.cells_y
    assert w_total % n_m == 0, (w_total, n_m)
    w_loc = w_total // n_m
    p_loc = cfg.num_particles // n_p
    origin = (float(cfg.map.origin[0]), float(cfg.map.origin[1]))
    res = float(cfg.map.resolution)
    ext = 1                                  # LL halo for bilinear corners

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
            keep = keep * 0.0       # (round-4 ADVICE: was models/-only)

        # tiled LL field + 1-column halo for bilinear
        ll_tile = _ll_field_tiled(state.logodds, engine.kernel,
                                  cfg.matcher.z_hit, cfg.sensor.max_range,
                                  "m")
        ll_ext = _halo_exchange_cols(
            ll_tile, ext, "m",
            fill=math.log(1.0 / cfg.sensor.max_range))

        key, k_motion, k_resample = jax.random.split(state.key, 3)
        keys = jax.random.split(jax.random.fold_in(k_motion, my_p), p_loc)

        def particle(pose, k):
            pose_s = sample_motion(k, pose, odom, cfg.motion)
            return _match_tiled(
                ll_ext, scan, pose_s, odom, mcfg=cfg.matcher,
                motion_cfg=cfg.motion, resolution=res, origin=origin,
                max_range=cfg.sensor.max_range, w_total=w_total, h=h,
                tile_j=my_m, w_loc=w_loc, ext=ext, axis_name="m",
                prior_center=apply_odometry(pose, odom))

        poses, scores = jax.vmap(particle)(state.poses, keys)
        lw = scores.astype(state.log_weights.dtype)
        if cfg.accumulate_weights:   # SIS mode, same as models/rbpf.py
            lw = lw + state.log_weights

        # weight stats over 'p' (scores already global after the 'm' psum)
        m_ = jax.lax.pmax(jnp.max(lw), "p")
        # AMCL recovery EMAs on the replicated global max log-weight
        # (models/shared.recovery_update; round-5)
        recov, p_inject = recovery_update(cfg, state, m_)

        e = jnp.exp(lw - m_)
        z = jax.lax.psum(jnp.sum(e), "p")
        w = e / z
        n_eff = 1.0 / jax.lax.psum(jnp.sum(w * w), "p")
        weighted = jax.lax.psum(
            jnp.stack([jnp.sum(poses[:, 0] * w), jnp.sum(poses[:, 1] * w),
                       jnp.sum(wrap_angle(poses[:, 2]) * w)]), "p")

        li = jnp.argmax(lw)
        cand = jnp.concatenate([lw[li][None], poses[li]])
        all_cand = jax.lax.all_gather(cand, "p")
        gbest = jnp.argmax(all_cand[:, 0])
        best_pose = all_cand[gbest, 1:]
        best_lw = all_cand[gbest, 0]
        best_index = gbest * p_loc + jax.lax.psum(
            jnp.where(jax.lax.axis_index("p") == gbest, li, 0), "p")

        # tile-local integration: shift the origin by the tile's offset
        tile_origin = (origin[0] + my_m * w_loc * res, origin[1])
        integ_pose = integration_pose(n_eff, cfg.num_particles, weighted,
                                      best_pose)
        delta = integrate_scan(
            state.logodds, integ_pose, scan, lut, resolution=res,
            origin=tile_origin, l_free=cfg.sensor.l_free,
            l_occ=cfg.sensor.l_occ,
            tol_cells=cfg.sensor.hit_tolerance_cells)
        logodds = state.logodds + keep * delta

        # resampling over 'p'
        do_resample = n_eff < (cfg.num_particles * cfg.resample_fraction)
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
    return jax.jit(fn)


def init_tiled(engine: SharedMapSLAM, key, mesh: Mesh) -> SharedMapState:
    # jit-with-out-shardings instead of device_put: works on multi-process
    # meshes where shardings are not host-addressable (see init_shmap).
    init = jax.jit(engine.init, out_shardings=tiled_state_shardings(mesh))
    return init(key)
