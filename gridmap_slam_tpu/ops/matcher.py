"""Correlative scan matcher.

Reference behavior: slam/GridMap.java:319-369.  The reference refines each
particle's pose with a BOBYQA derivative-free optimizer (<=500 sequential
objective evaluations of p(z|x,m) * p(x|x0,u)); its older brute-force variant
searched a +/-0.20 m, +/-15 deg window.

Design: a multi-stage dense correlative search (coarse grid over the full
window, then halving refinement grids around the running argmax).  All
candidate poses for all beams are scored in batched gathers from the
likelihood field plus a log-sum reduction — no data-dependent control flow,
embarrassingly parallel across particles under vmap, and strictly stronger
than a local optimizer against multi-modal likelihood fields.

Two deliberate upgrades over the reference lookup (documented divergences):

1. **Bilinear interpolation** of the likelihood field instead of
   floor-to-cell lookup (slam/GridMap.java:273-277).  Nearest-cell lookup
   makes the score piecewise constant, so a dense argmax parks at plateau
   corners and drifts systematically; bilinear sampling gives a smooth
   sub-cell landscape.
2. **Out-of-map and unknown cells score the uniform likelihood
   1/max_range** (the reference *skips* out-of-map beams — an implicit
   likelihood of 1 that a global argmax would exploit by pushing beams off
   the map).  Both cases are folded into one "effective field" value
   v_eq = (1/max_range - z_rand/max_range) / z_hit so a single fused formula
   log(z_hit * v + z_rand/max_range) covers explored, unknown, and
   out-of-map lookups (and reproduces the reference's exact uniform value
   for unknown cells, slam/GridMap.java:285-288).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from ..types import Odom, Scan
from .geometry import scan_points
from .motion import noise_scales


def effective_field(field, unknown, z_hit: float, max_range: float):
    """Fold the unknown-cell uniform case into the field values so scoring is
    a single fused formula (see module docstring)."""
    uniform = 1.0 / max_range
    v_eq = (uniform - (1.0 - z_hit) * uniform) / z_hit
    return jnp.where(unknown, v_eq, field).astype(field.dtype)


def log_likelihood_field(field, unknown, z_hit: float, max_range: float):
    """Per-cell log measurement likelihood, precomputed ONCE per particle:
    LL = log(z_hit * v' + (1-z_hit)/max_range) with v' the effective field.

    The matcher then samples LL bilinearly for every candidate — one
    transcendental per map cell (14.4k for the reference map) instead of one
    per candidate-beam pair (~170k per particle per scan), and the fine
    stages interpolate a smoother surface.  (Bilinear-of-log vs
    log-of-bilinear is a documented divergence from the reference's
    floor-cell product, slam/GridMap.java:261-294.)"""
    uniform = 1.0 / max_range
    v = effective_field(field, unknown, z_hit, max_range)
    return jnp.log(z_hit * v + (1.0 - z_hit) * uniform)


def _bilinear(vfield, fx, fy, v_outside):
    """Bilinearly sample vfield (H, W) at fractional cell-center coords
    (fx, fy); out-of-map corners contribute `v_outside`."""
    h, w = vfield.shape
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = fx - x0
    ty = fy - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    flat = vfield.reshape(-1)

    def corner(xi, yi):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = jnp.clip(yi, 0, h - 1) * w + jnp.clip(xi, 0, w - 1)
        return jnp.where(inb, flat[idx], v_outside)

    v00 = corner(x0i, y0i)
    v10 = corner(x0i + 1, y0i)
    v01 = corner(x0i, y0i + 1)
    v11 = corner(x0i + 1, y0i + 1)
    return ((1 - tx) * (1 - ty) * v00 + tx * (1 - ty) * v10
            + (1 - tx) * ty * v01 + tx * ty * v11)


def _nearest(vfield, fx, fy, v_outside):
    """Nearest-cell sample of vfield (H, W) at fractional cell-center
    coords — 1 gather instead of bilinear's 4 (coarse-stage fast path;
    also the reference's own lookup, slam/GridMap.java:273-277)."""
    h, w = vfield.shape
    xi = jnp.round(fx).astype(jnp.int32)
    yi = jnp.round(fy).astype(jnp.int32)
    inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    idx = jnp.clip(yi, 0, h - 1) * w + jnp.clip(xi, 0, w - 1)
    return jnp.where(inb, vfield.reshape(-1)[idx], v_outside)


def _stage_scores(llfield, px, py, use, pose0, dxs, dys, dts, *,
                  resolution, origin, z_hit, max_range, nearest=False):
    """Score all (dt, dy, dx) pose offsets around pose0.

    llfield: (H, W) precomputed log-likelihood field (log_likelihood_field);
    px/py/use: (B,) beam endpoints in the robot frame and the hit&valid
    mask.  Returns (nt, ny, nx) measurement log-likelihood log p(z|x,m)
    (slam/GridMap.java:261-294 in log space, with the divergences in the
    module docstring).  nearest=True uses nearest-cell lookups (coarse
    stages; 4x less gather traffic).
    """
    ll_outside = math.log(1.0 / max_range)

    theta = pose0[2] + dts                       # (nt,)
    c, s = jnp.cos(theta)[:, None], jnp.sin(theta)[:, None]
    rx = px[None, :] * c - py[None, :] * s       # (nt, B)
    ry = px[None, :] * s + py[None, :] * c

    # Fractional cell-center coordinates: cell (i, j) center sits at
    # origin + (i + 0.5) * res, so subtract the half-cell.
    wx = rx[:, None, :] + (pose0[0] + dxs)[None, :, None]   # (nt, nx, B)
    wy = ry[:, None, :] + (pose0[1] + dys)[None, :, None]   # (nt, ny, B)
    fx = (wx - origin[0]) / resolution - 0.5
    fy = (wy - origin[1]) / resolution - 0.5

    sample = _nearest if nearest else _bilinear
    ll = sample(llfield,
                fx[:, None, :, :].astype(jnp.float32),
                fy[:, :, None, :].astype(jnp.float32),
                ll_outside)                                  # (nt, ny, nx, B)
    return jnp.sum(jnp.where(use[None, None, None, :], ll, 0.0), axis=-1)


def _prior_grid(dxs, dys, dts, sd_c, sd_t, weight=1.0, bias=None):
    """Motion log-prior over the offset grid.

    `bias` (3,) shifts the prior's center: candidates live at
    pose0 + offset, and the prior penalizes deviation from the
    DETERMINISTIC odometry pose x0 (+) u (the reference's BOBYQA objective
    evaluates p(x | x0, u) there, slam/GridMap.java:356 ->
    slam/Odometry.java:99), so the deviation is bias + offset with
    bias = pose0 - (x0 (+) u) — the motion noise this particle sampled.
    Without a bias the prior is centered at pose0 itself."""
    if bias is None:
        bx = by = bt = 0.0
    else:
        bx, by, bt = bias[0], bias[1], bias[2]
    d2 = (dys + by)[:, None] ** 2 + (dxs + bx)[None, :] ** 2     # (ny, nx)
    pt = -((dts + bt) ** 2) / (2.0 * sd_t * sd_t)                # (nt,)
    return weight * (pt[:, None, None] - d2[None] / (2.0 * sd_c * sd_c))


def _argmax3(scores, dxs, dys, dts):
    flat = jnp.argmax(scores.reshape(-1))
    nt, ny, nx = scores.shape
    it = flat // (ny * nx)
    iy = (flat % (ny * nx)) // nx
    ix = flat % nx
    return dxs[ix], dys[iy], dts[it], flat


def score_pose(llfield, scan: Scan, pose, *, z_hit, resolution, origin,
               max_range):
    """Measurement log-likelihood of a single pose (no search)."""
    px, py = scan_points(scan)
    use = scan.valid & scan.hit
    zero = jnp.zeros((1,), jnp.float32)
    meas = _stage_scores(llfield, px, py, use, pose, zero, zero, zero,
                         resolution=resolution, origin=origin, z_hit=z_hit,
                         max_range=max_range)
    return meas.reshape(())


MATCHER_IMPLS = ("auto", "gather", "splat", "matmul")


def resolve_impl(impl: str) -> str:
    """The scoring backend `matcher.impl` selects ("auto" is "gather";
    choosing among the backends by measurement is open work)."""
    if impl not in MATCHER_IMPLS:
        raise ValueError(f"matcher.impl must be one of {MATCHER_IMPLS}; "
                         f"got {impl!r}")
    return "gather" if impl == "auto" else impl


def correlative_match(llfield, scan: Scan, pose0, odom: Odom, *,
                      matcher_cfg, motion_cfg, resolution, origin, max_range,
                      prior_center=None):
    """Find the pose maximizing log p(z|x,m) + prior_weight * log p(x|x0,u)
    near pose0.  Dispatches to the matcher implementation selected by
    matcher_cfg.impl ("splat" = gather-free streaming formulation,
    ops/matcher_splat.py; "gather" = batched bilinear lookups below).

    `prior_center` is the pose the motion prior is centered at — the
    DETERMINISTIC odometry propagation x0 (+) u (reference:
    slam/GridMap.java:356 evaluates u.probabiliyOf(startPose, candidate)).
    pose0 (the search center) is typically the noise-SAMPLED pose; passing
    prior_center pulls candidates back toward odometry by the noise the
    particle drew, matching the reference objective.  Default None centers
    the prior at pose0 itself.

    Returns (best_pose (3,), meas_logscore scalar) where meas_logscore is the
    measurement-only log-likelihood at the best pose — the reference uses
    p(z|x,m) alone as the particle weight (slam/SLAM.java:99).
    """
    mc = matcher_cfg
    impl = resolve_impl(mc.impl)
    if impl == "splat":
        from .matcher_splat import correlative_match_splat
        return correlative_match_splat(
            llfield, scan, pose0, odom, matcher_cfg=mc,
            motion_cfg=motion_cfg, resolution=resolution, origin=origin,
            max_range=max_range, prior_center=prior_center)
    px, py = scan_points(scan)
    use = scan.valid & scan.hit

    if impl == "matmul":
        # Same candidate schedule + scores as the gather path below, with
        # every stage's lookups computed as one-hot matrix contractions
        # instead of random gathers (ops/matcher_matmul.py).
        from .matcher_matmul import pad_llfield, stage_scores_matmul
        _pad = 2
        ll_outside = math.log(1.0 / max_range)
        fpad = pad_llfield(llfield, _pad, ll_outside)
        use_bf16 = bool(getattr(mc, "matmul_bf16", False))
        # center the LL range [ll_outside, ~0] around zero for bf16
        shift = -0.5 * ll_outside if use_bf16 else 0.0

        def _stages(px_, py_, use_, pose0_, dxs, dys, dts, *, nearest=False,
                    **_kw):
            return stage_scores_matmul(
                fpad, px_, py_, use_.astype(fpad.dtype), pose0_, dxs, dys,
                dts, resolution=resolution, origin=origin, pad=_pad,
                nearest=nearest, bf16=use_bf16, f_shift=shift)
    else:
        def _stages(px_, py_, use_, pose0_, dxs, dys, dts, *, nearest=False,
                    **kw2):
            return _stage_scores(llfield, px_, py_, use_, pose0_, dxs, dys,
                                 dts, nearest=nearest, **kw2)
    # Half-resolution coarse basin stage (matcher_cfg.coarse_halfres): the
    # coarse grid only selects the basin the fine stages rescore at full
    # resolution, so it can run on a 2x2-mean-pooled field — ~4x less
    # coarse work in every dense backend.
    coarse_stages = _stages
    if getattr(mc, "coarse_halfres", False) and impl != "splat":
        ll_out_v = math.log(1.0 / max_range)
        h_, w_ = llfield.shape
        lle = jnp.pad(llfield, ((0, h_ & 1), (0, w_ & 1)),
                      constant_values=ll_out_v)
        hll = lle.reshape(lle.shape[0] // 2, 2, lle.shape[1] // 2,
                          2).mean((1, 3))
        coarse_res = 2.0 * resolution
        if impl == "matmul":
            fpad_h = pad_llfield(hll, _pad, ll_out_v)

            def coarse_stages(px_, py_, use_, pose0_, dxs, dys, dts, *,
                              nearest=False, **_kw):
                return stage_scores_matmul(
                    fpad_h, px_, py_, use_.astype(fpad_h.dtype), pose0_,
                    dxs, dys, dts, resolution=coarse_res, origin=origin,
                    pad=_pad, nearest=False, bf16=use_bf16, f_shift=shift)
        else:

            def coarse_stages(px_, py_, use_, pose0_, dxs, dys, dts, *,
                              nearest=False, **kw2):
                kw3 = dict(kw2)
                kw3["resolution"] = coarse_res
                return _stage_scores(hll, px_, py_, use_, pose0_, dxs,
                                     dys, dts, nearest=False, **kw3)

    sd_c, sd_t = noise_scales(odom, motion_cfg)
    if prior_center is None:
        bias = None
    else:
        from .geometry import wrap_angle
        bias = (pose0[0] - prior_center[0], pose0[1] - prior_center[1],
                wrap_angle(pose0[2] - prior_center[2]))

    # Coarse-stage thinning: the coarse grid only needs to find the right
    # basin, so it can score every `stride`-th beam with nearest-cell
    # lookups (the reference's own lookup kind) — the refine stages rescore
    # with ALL beams bilinearly.  Cuts the dominant gather traffic ~4x per
    # unit stride with no effect on the refined optimum in practice.
    stride = max(int(mc.coarse_beam_stride), 1)
    px_c, py_c, use_c = px[::stride], py[::stride], use[::stride]

    wt = math.radians(mc.window_theta_deg)
    c_dxs = jnp.asarray(np.linspace(-mc.window_xy, mc.window_xy, mc.coarse_nxy),
                        jnp.float32)
    c_dts = jnp.asarray(np.linspace(-wt, wt, mc.coarse_nt), jnp.float32)

    kw = dict(resolution=resolution, origin=origin, z_hit=mc.z_hit,
              max_range=max_range)

    meas = coarse_stages(px_c, py_c, use_c, pose0, c_dxs, c_dxs,
                         c_dts, nearest=mc.coarse_nearest, **kw)
    # prior in per-used-beam units must not change with the beam subset:
    # scale the coarse prior by the coarse beam fraction.
    n_all = jnp.maximum(jnp.sum(use.astype(jnp.float32)), 1.0)
    n_c = jnp.maximum(jnp.sum(use_c.astype(jnp.float32)), 1.0)
    total = meas + (n_c / n_all) * _prior_grid(
        c_dxs, c_dxs, c_dts, sd_c, sd_t, mc.prior_weight, bias)
    fx, fy, ft, flat = _argmax3(total, c_dxs, c_dxs, c_dts)
    meas_best = (n_all / n_c) * meas.reshape(-1)[flat]

    # Refinement stages: halve the span around the running argmax.
    step_xy = 2.0 * mc.window_xy / max(mc.coarse_nxy - 1, 1)
    step_t = 2.0 * wt / max(mc.coarse_nt - 1, 1)
    for _ in range(1 + mc.extra_refine_stages):
        off_xy = jnp.asarray(np.linspace(-step_xy, step_xy, mc.fine_nxy),
                             jnp.float32)
        off_t = jnp.asarray(np.linspace(-step_t, step_t, mc.fine_nt),
                            jnp.float32)
        r_dxs = fx + off_xy
        r_dys = fy + off_xy
        r_dts = ft + off_t
        meas_r = _stages(px, py, use, pose0, r_dxs, r_dys, r_dts, **kw)
        total_r = meas_r + _prior_grid(r_dxs, r_dys, r_dts, sd_c, sd_t,
                                       mc.prior_weight, bias)
        fx, fy, ft, flat = _argmax3(total_r, r_dxs, r_dys, r_dts)
        meas_best = meas_r.reshape(-1)[flat]
        step_xy = 2.0 * step_xy / max(mc.fine_nxy - 1, 1)
        step_t = 2.0 * step_t / max(mc.fine_nt - 1, 1)

    best_pose = jnp.stack([pose0[0] + fx, pose0[1] + fy, pose0[2] + ft])
    return best_pose, meas_best
