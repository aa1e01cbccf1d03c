"""Splat-correlation scan matcher: the gather-free formulation.

Mathematically IDENTICAL scores to ops/matcher.correlative_match's bilinear
lookups, reorganized for devices whose random gathers are slow: this
formulation touches memory only in streaming patterns:

    score(dt, dy, dx) = sum_b bilinear(llf)(p_b(dt) + (dx, dy))
                      = sum_{h,w} E_dt_frac[h, w] * llf_pad[h + dy_i, w + dx_i]

where E is the scan's endpoint image, BILINEARLY SPLATTED (each endpoint
contributes its 4 corner weights — built with one-hot einsums, no
scatter), the candidate offset's FRACTIONAL part is folded into the
splat (so sub-cell refinement stays exact), and the integer offsets become
statically shifted elementwise dot products (streaming at memory
bandwidth).  Out-of-map lookups read a constant ll_outside border baked
into the padded field, reproducing the gather path's clamping semantics
for any endpoint within `pad` cells of the map; endpoints beyond that are
clamped to the border (where the field is constant ll_outside anyway).

The number of distinct fractional offsets per refinement stage is tiny
(stage spacing 2^-s cells => 2^s fracs), so the splat cost stays ~B*(H+W)
while all candidate scoring is streaming.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..types import Odom, Scan
from .geometry import scan_points, wrap_angle
from .motion import noise_scales


def _pad_field(llfield, pad: int, ll_outside: float):
    return jnp.pad(llfield, ((pad, pad), (pad, pad)),
                   constant_values=ll_outside)


def _splat(px, py, wgt, theta, dx_frac, dy_frac, *, hp, wp, pad,
           resolution, origin, pose_xy):
    """Bilinearly-splatted endpoint image E (hp, wp) for beam endpoints
    rotated by `theta` and shifted by the FRACTIONAL offset
    (dx_frac, dy_frac) in meters; `wgt` (B,) carries the beam mask.

    E[h, w] = sum_b wgt_b * corner-weight so that
    sum_hw E[h,w] * F[h+dy, w+dx] == sum_b wgt_b * bilinear(F)(p_b + d).
    """
    c, s = jnp.cos(theta), jnp.sin(theta)
    rx = px * c - py * s + pose_xy[0] + dx_frac
    ry = px * s + py * c + pose_xy[1] + dy_frac
    fx = (rx - origin[0]) / resolution - 0.5 + pad
    fy = (ry - origin[1]) / resolution - 0.5 + pad
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = (fx - x0).astype(jnp.float32)
    ty = (fy - y0).astype(jnp.float32)
    # clamp into the padded frame (beyond-pad endpoints read the constant
    # ll_outside border, matching the gather path's out-of-map value)
    x0i = jnp.clip(x0.astype(jnp.int32), 0, wp - 2)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, hp - 2)

    iy = jnp.arange(hp, dtype=jnp.int32)
    ix = jnp.arange(wp, dtype=jnp.int32)
    # two-tap one-hot rows: A_y[b, h] in {1-ty, ty} at y0, y0+1
    a_y = (jnp.where(iy[None, :] == y0i[:, None], 1.0 - ty[:, None], 0.0)
           + jnp.where(iy[None, :] == y0i[:, None] + 1, ty[:, None], 0.0))
    a_x = (jnp.where(ix[None, :] == x0i[:, None], 1.0 - tx[:, None], 0.0)
           + jnp.where(ix[None, :] == x0i[:, None] + 1, tx[:, None], 0.0))
    a_y = a_y * wgt[:, None]
    # E = sum_b outer(a_y[b], a_x[b])  — one (hp, B) x (B, wp) matmul.
    # HIGHEST: at DEFAULT precision a device may round the fractional tap
    # weights to bf16 or TF32, breaking this backend's exact-equality
    # contract with the gather path.
    return jax.lax.dot(a_y.T, a_x, precision=jax.lax.Precision.HIGHEST)


def _window_scores(field_pad, e_img, offs_y, offs_x, *, he, we, margin):
    """S[k] = sum_ab e_img[a, b] * field_pad[a + margin + offs_y[k],
                                             b + margin + offs_x[k]]
    with STATIC integer offsets in [-margin, margin] — unrolled shifted
    elementwise dots (streaming; no gathers).  e_img: (he, we);
    field_pad: (he + 2*margin, we + 2*margin), same map alignment."""
    outs = []
    for oy, ox in zip(offs_y, offs_x):
        win = jax.lax.dynamic_slice(
            field_pad, (margin + oy, margin + ox), (he, we))
        outs.append(jnp.vdot(e_img, win,
                             precision=jax.lax.Precision.HIGHEST))
    return jnp.stack(outs)


def correlative_match_splat(llfield, scan: Scan, pose0, odom: Odom, *,
                            matcher_cfg, motion_cfg, resolution, origin,
                            max_range, prior_center=None):
    """Drop-in replacement for ops/matcher.correlative_match (same
    signature/return), scoring via splat-correlation instead of gathers.

    Search schedule: a coarse integer-cell (dx, dy) window x coarse theta
    grid, then halving refinement stages whose sub-cell offsets fold their
    fractional part into the splat — every stage's scores equal the gather
    path's bilinear lookups to float precision.
    """
    mc = matcher_cfg
    h, w = llfield.shape
    res = float(resolution)
    ll_outside = math.log(1.0 / max_range)
    # window in cells (coarse grid at one-cell spacing like the reference's
    # brute-force matcher; mc.window_xy rounded to whole cells)
    wx_cells = max(int(round(mc.window_xy / res)), 1)
    pad = wx_cells + 2                   # splat frame margin
    hp, wp = h + 2 * pad, w + 2 * pad    # E frame
    margin = wx_cells                    # extra field margin for the shifts
    fpad = _pad_field(llfield, pad + margin, ll_outside)

    px, py = scan_points(scan)
    use = (scan.valid & scan.hit)
    stride = max(int(mc.coarse_beam_stride), 1)
    wgt_all = use.astype(jnp.float32)
    wgt_coarse = wgt_all[::stride]
    n_all = jnp.maximum(jnp.sum(wgt_all), 1.0)
    n_c = jnp.maximum(jnp.sum(wgt_coarse), 1.0)

    sd_c, sd_t = noise_scales(odom, motion_cfg)
    if prior_center is None:
        bias = jnp.zeros(3, jnp.float32)
    else:
        bias = jnp.stack([pose0[0] - prior_center[0],
                          pose0[1] - prior_center[1],
                          wrap_angle(pose0[2] - prior_center[2])])

    wt = math.radians(mc.window_theta_deg)
    c_dts = np.linspace(-wt, wt, mc.coarse_nt)
    offs = [(oy, ox) for oy in range(-wx_cells, wx_cells + 1)
            for ox in range(-wx_cells, wx_cells + 1)]
    offs_y = [o[0] for o in offs]
    offs_x = [o[1] for o in offs]
    n_xy = len(offs)

    def prior(dx_m, dy_m, dt_r, weight_scale):
        d2 = (dx_m + bias[0]) ** 2 + (dy_m + bias[1]) ** 2
        pt = -((dt_r + bias[2]) ** 2) / (2.0 * sd_t * sd_t)
        return weight_scale * mc.prior_weight * (
            pt - d2 / (2.0 * sd_c * sd_c))

    # ---- coarse stage: all integer offsets x coarse theta grid ----
    def coarse_one(dt):
        e = _splat(px[::stride], py[::stride], wgt_coarse, pose0[2] + dt,
                   0.0, 0.0, hp=hp, wp=wp, pad=pad, resolution=res,
                   origin=origin, pose_xy=(pose0[0], pose0[1]))
        return _window_scores(fpad, e, offs_y, offs_x, he=hp, we=wp,
                              margin=margin)

    meas_c = jax.vmap(coarse_one)(jnp.asarray(c_dts, jnp.float32))  # (nt,nxy)
    dxm = jnp.asarray([ox * res for ox in offs_x], jnp.float32)
    dym = jnp.asarray([oy * res for oy in offs_y], jnp.float32)
    dtm = jnp.asarray(c_dts, jnp.float32)
    total_c = meas_c + prior(dxm[None, :], dym[None, :], dtm[:, None],
                             n_c / n_all)
    flat = jnp.argmax(total_c.reshape(-1))
    it, ixy = flat // n_xy, flat % n_xy
    fx = dxm[ixy]
    fy = dym[ixy]
    ft = dtm[it]
    meas_best = (n_all / n_c) * meas_c.reshape(-1)[flat]

    # ---- refinement: halving stages; frac offsets folded into the splat
    step_xy = res
    step_t = 2.0 * wt / max(mc.coarse_nt - 1, 1)
    n_stages = 1 + mc.extra_refine_stages
    r_off = (-1.0, 0.0, 1.0)              # x step in each refined axis
    for _ in range(n_stages):
        step_xy *= 0.5
        step_t *= 0.5

        def fine_one(args):
            dt, dxf, dyf = args
            e = _splat(px, py, wgt_all, pose0[2] + dt, dxf, dyf,
                       hp=hp, wp=wp, pad=pad, resolution=res, origin=origin,
                       pose_xy=(pose0[0], pose0[1]))
            # E already contains the full candidate offset (incl. integer
            # part folded via dxf/dyf in meters): score at zero shift
            return _window_scores(fpad, e, [0], [0], he=hp, we=wp,
                                  margin=margin)[0]

        cand = [(ft + ot * step_t, fx + ox * step_xy, fy + oy * step_xy)
                for ot in r_off for oy in r_off for ox in r_off]
        dts = jnp.stack([c[0] for c in cand])
        dxs = jnp.stack([c[1] for c in cand])
        dys = jnp.stack([c[2] for c in cand])
        meas_r = jax.vmap(fine_one)((dts, dxs, dys))           # (27,)
        total_r = meas_r + prior(dxs, dys, dts, 1.0)
        k = jnp.argmax(total_r)
        fx, fy, ft = dxs[k], dys[k], dts[k]
        meas_best = meas_r[k]

    best_pose = jnp.stack([pose0[0] + fx, pose0[1] + fy, pose0[2] + ft])
    return best_pose, meas_best
