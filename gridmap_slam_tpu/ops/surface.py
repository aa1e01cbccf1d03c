"""Scan-likelihood surface: the measurement model evaluated EVERYWHERE once.

At huge particle counts the per-particle correlative matcher is the wrong
shape: a million particles x hundreds of candidates each re-reads the same
shared likelihood field.  This module inverts the loop — per scan it
precomputes the correlation volume

    C[it, iy, ix] = sum_b w_b * bilinear(LLF)(R(theta_it) p_b + cell(iy, ix))

over a theta-bin grid x every integer cell translation (one convolution per
scan, cost independent of particle count), after which ANY pose's
measurement log-likelihood is a trilinear sample of C (8 taps / particle).
This is the classic likelihood-field MCL precomputation, organized for a
data-parallel device: endpoint kernels are built with one-hot matmuls (no
scatter) and the correlation runs as `lax.conv_general_dilated` (or an FFT
for large crops).

Exactness: at integer cell translations and exact bin angles, C equals the
matcher backends' scores to float precision (the splat identity:
bilinearly-splatted endpoints correlated at integer shifts reproduce
bilinear lookups).  Between samples the trilinear interpolation smooths by
at most one extra (cell, cell, bin) tent — documented divergence, negligible
against the field's own Gaussian blur (sigma ~1 cell).

The volume is built over a CROP of the field (static crop size, dynamic
center), so city-scale maps (BASELINE config 3: 200x200 m) pay only for the
region the particle cloud can reach, not for H*W.

Reference behavior covered: p(z|x,m) particle weighting
(slam/SLAM.java:99, slam/GridMap.java:261-294); the hill-climb refinement
stands in for the reference's per-particle BOBYQA pose polish
(slam/GridMap.java:348-369) at +/-1-cell granularity per step.
"""

from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp


def crop_center_cells(center_xy, crop_hw: Tuple[int, int],
                      full_hw: Tuple[int, int], resolution: float, origin):
    """Top-left cell index (iy0, ix0) of a (Hc, Wc) crop centered as close
    to world-point `center_xy` as the map allows (clamped inside)."""
    hc, wc = crop_hw
    h, w = full_hw
    cx = (center_xy[0] - origin[0]) / resolution
    cy = (center_xy[1] - origin[1]) / resolution
    ix0 = jnp.clip(jnp.round(cx).astype(jnp.int32) - wc // 2, 0, w - wc)
    iy0 = jnp.clip(jnp.round(cy).astype(jnp.int32) - hc // 2, 0, h - hc)
    return iy0, ix0


def theta_grid(nt: int, span_rad: float):
    """Static theta-bin grid parameters: (dtheta, wrap_theta, offset) with
    bin t at center_theta + offset + t * dtheta.  span >= pi selects the
    FULL-CIRCLE wrapping grid (global relocalization); smaller spans a
    clamped window centered on the cloud heading.  Single source of truth
    for models/shared.surface_volume and parallel/surface_sharded.py."""
    wrap_theta = span_rad >= math.pi - 1e-9
    if wrap_theta:
        return 2.0 * math.pi / nt, True, -math.pi
    return 2.0 * span_rad / max(nt - 1, 1), False, -span_rad


def splat_endpoint_kernels(px, py, wgt, thetas, k_cells: int,
                           resolution: float):
    """(nt, K, K) stack of bilinearly-splatted endpoint images, one per
    theta bin; K = 2*k_cells + 1 covers endpoints within k_cells of the
    robot.  Beams beyond the kernel radius clamp to the rim (they would
    read the constant outside value anyway when the crop covers the map).

    Built with two-tap one-hot matmuls (no scatter):
    E = A_y^T A_x with A_* the bilinear corner weights.
    """
    k = 2 * k_cells + 1
    iy = jnp.arange(k, dtype=jnp.int32)
    ix = jnp.arange(k, dtype=jnp.int32)

    def one(theta):
        c, s = jnp.cos(theta), jnp.sin(theta)
        ex = (px * c - py * s) / resolution + k_cells   # kernel-frame coords
        ey = (px * s + py * c) / resolution + k_cells
        x0 = jnp.clip(jnp.floor(ex), 0, k - 2)
        y0 = jnp.clip(jnp.floor(ey), 0, k - 2)
        tx = (ex - x0).astype(jnp.float32)
        ty = (ey - y0).astype(jnp.float32)
        x0i, y0i = x0.astype(jnp.int32), y0.astype(jnp.int32)
        a_y = (jnp.where(iy[None, :] == y0i[:, None], 1.0 - ty[:, None], 0.0)
               + jnp.where(iy[None, :] == y0i[:, None] + 1, ty[:, None], 0.0))
        a_x = (jnp.where(ix[None, :] == x0i[:, None], 1.0 - tx[:, None], 0.0)
               + jnp.where(ix[None, :] == x0i[:, None] + 1, tx[:, None], 0.0))
        # HIGHEST: tap weights are fractional, and endpoint images feed
        # both correlation modes — splats rounded to a reduced-precision
        # matmul input format (bf16 / TF32 at DEFAULT precision) would
        # perturb every downstream score.
        return jax.lax.dot((a_y * wgt[:, None]).T, a_x,
                           precision=jax.lax.Precision.HIGHEST)  # (K, K)

    return jax.vmap(one)(thetas)


def _fft_size(n: int) -> int:
    """FFT length for one axis: the exact linear-correlation length `n`
    rounded UP to a size FFT libraries plan well.  Lengths with large prime
    factors (the city preset's 916 = 4*229) get slow plans, while blanket
    power-of-two padding inflates lengths that are already smooth (524 ->
    1024).  Policy: the next 5-smooth length (2^a 3^b 5^c: 524 -> 540,
    916 -> 960), except when that lands within ~12 % of the next power of
    two, where the pure radix-2 plan is taken.  Which lengths are fast on
    a given FFT library is open to measurement.  Zero-padding past the
    exact length only adds zeros outside the kept correlation window —
    output unchanged."""
    p2 = 1 << max(n - 1, 1).bit_length()
    s5 = p2
    v3 = 1
    while v3 < p2:
        v35 = v3
        while v35 < p2:
            v = v35
            while v < n:
                v *= 2
            if n <= v < s5:
                s5 = v
            v35 *= 5
        v3 *= 3
    return p2 if s5 >= 0.875 * p2 else s5


def scan_surface(llf_crop, e_stack, ll_outside: float, bf16: bool = False,
                 fft: bool = False):
    """Correlate the cropped LL field with every theta bin's endpoint image.

    llf_crop: (Hc, Wc); e_stack: (nt, K, K) with K = 2*kc + 1.
    Returns C: (nt, Hc, Wc) where C[t, iy, ix] scores the pose whose
    position is cell (iy, ix) of the crop at theta bin t.  The field is
    padded by kc with ll_outside so endpoints past the crop read the
    out-of-map constant (matching the matcher backends).

    bf16=True runs the correlation with bf16 inputs (f32 accumulate) with
    the field range centered around zero; the exact shift
    mass (sum of each bin's endpoint weights, computed in f32 before the
    cast) is subtracted back, leaving only ~1e-2 quantization noise on the
    log-scores — negligible against particle weighting noise at the scales
    this mode serves.
    """
    kc = (e_stack.shape[-1] - 1) // 2
    fpad = jnp.pad(llf_crop, ((kc, kc), (kc, kc)),
                   constant_values=ll_outside)
    if fft:
        # Linear cross-correlation via FFT: the direct conv is
        # O(nt * K^2 * Hc * Wc) (~2 TFLOP for the city preset's 405^2
        # kernel over a 512^2 crop); the FFT form is O(nt * N log N) with
        # N = (Hc + K - 1)^2 — ~3 orders of magnitude fewer flops.  The
        # padded frame height Hc + 2*kc = Hc + K - 1 is exactly the linear
        # correlation length, so no extra zero-padding and no circular
        # wrap-around in the kept [0, Hc) x [0, Wc) output window.  The
        # transform lengths round up to smooth sizes (_fft_size).
        h2, w2 = _fft_size(fpad.shape[0]), _fft_size(fpad.shape[1])
        f_hat = jnp.fft.rfft2(fpad, s=(h2, w2))
        e_hat = jnp.fft.rfft2(e_stack, s=(h2, w2))
        out = jnp.fft.irfft2(f_hat[None] * jnp.conj(e_hat), s=(h2, w2))
        return out[:, :llf_crop.shape[0], :llf_crop.shape[1]].astype(
            jnp.float32)
    if bf16:
        shift = -0.5 * ll_outside
        mass = jnp.sum(e_stack, axis=(-2, -1))          # (nt,) = sum_b w_b
        out = jax.lax.conv_general_dilated(
            (fpad + shift).astype(jnp.bfloat16)[None, None, :, :],
            e_stack.astype(jnp.bfloat16)[:, None, :, :],
            window_strides=(1, 1), padding="VALID",
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            preferred_element_type=jnp.float32)
        return out[0] - shift * mass[:, None, None]
    # conv_general_dilated cross-correlates when the kernel is unflipped:
    # out[t, y, x] = sum_{dy,dx} fpad[y+dy, x+dx] * E[t, dy, dx].
    # HIGHEST keeps the f32 mode honestly f32 (at DEFAULT precision a
    # device may round conv inputs to bf16 or TF32 — that's what bf16=True
    # is for).
    out = jax.lax.conv_general_dilated(
        fpad[None, None, :, :], e_stack[:, None, :, :],
        window_strides=(1, 1), padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)
    return out[0]                                       # (nt, Hc, Wc)


def pack_neighborhoods(c_vol, wrap_theta: bool = False):
    """(nt, hc, wc) -> flattened ((nt+1)*(hc+1)*(wc+1), 8) array holding
    every base cell's full 2x2x2 tap neighborhood, edge-padded (wrap along
    theta for full-circle grids) so clamped taps read the same values as
    _tap's index clipping.

    Purpose: a trilinear sample becomes ONE contiguous 8-wide gather
    instead of 8 scalar gathers.  The packed array is 8x the volume's
    memory, built once per scan with static slices.
    """
    nt, hc, wc = c_vol.shape
    v = jnp.pad(c_vol, ((0, 0), (1, 1), (1, 1)), mode="edge")
    if wrap_theta:
        v = jnp.concatenate([v[-1:], v, v[:1]], axis=0)
    else:
        v = jnp.concatenate([v[:1], v, v[-1:]], axis=0)
    slices = []
    for dt in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                slices.append(v[dt:dt + nt + 1, dy:dy + hc + 1,
                               dx:dx + wc + 1])
    return jnp.stack(slices, axis=-1).reshape(-1, 8)


def _tap(c_vol, it, iy, ix, wrap_theta=False):
    nt, hc, wc = c_vol.shape
    # full-circle bin grids wrap (relocalization: theta spans +/- pi);
    # partial spans clamp (the matcher-window case)
    it = (it % nt) if wrap_theta else jnp.clip(it, 0, nt - 1)
    iy = jnp.clip(iy, 0, hc - 1)
    ix = jnp.clip(ix, 0, wc - 1)
    flat = (it * hc + iy) * wc + ix
    return c_vol.reshape(-1)[flat]


def sample_surface(c_vol, poses, *, theta0, dtheta, crop_iy0, crop_ix0,
                   resolution: float, origin, wrap_theta: bool = False,
                   packed=None):
    """Trilinear sample of C at `poses` (..., 3) -> measurement log-lik.

    theta0/dtheta define the bin grid (bin t is at theta0 + t*dtheta);
    theta distance is evaluated on the circle so bins never wrap badly for
    spans < pi.  Positions clamp to the crop (out-of-crop particles read
    rim values — by construction low-likelihood territory)."""
    x, y, th = poses[..., 0], poses[..., 1], poses[..., 2]
    fx = (x - origin[0]) / resolution - 0.5 - crop_ix0
    fy = (y - origin[1]) / resolution - 0.5 - crop_iy0
    # circular theta -> bin coordinate; with wrap_theta the grid covers the
    # whole circle (bin t at theta0 + t*dtheta, t*dtheta spanning 2*pi), so
    # the coordinate lives in [0, nt) and taps wrap modulo nt
    dt = (th - theta0 + math.pi) % (2.0 * math.pi) - math.pi
    if wrap_theta:
        dt = (th - theta0) % (2.0 * math.pi)
    ft = dt / dtheta

    x0 = jnp.floor(fx); y0 = jnp.floor(fy); t0 = jnp.floor(ft)
    tx = (fx - x0).astype(c_vol.dtype)
    ty = (fy - y0).astype(c_vol.dtype)
    tt = (ft - t0).astype(c_vol.dtype)
    x0i = x0.astype(jnp.int32); y0i = y0.astype(jnp.int32)
    t0i = t0.astype(jnp.int32)

    if packed is not None:
        # one 8-wide contiguous gather from the pack_neighborhoods array
        nt, hc, wc = c_vol.shape
        if wrap_theta:
            t_b = jnp.clip(t0i, 0, nt - 1) + 1     # ft in [0, nt) by constr.
        else:
            t_b = jnp.clip(t0i, -1, nt - 1) + 1
        y_b = jnp.clip(y0i, -1, hc - 1) + 1
        x_b = jnp.clip(x0i, -1, wc - 1) + 1
        flat = (t_b * (hc + 1) + y_b) * (wc + 1) + x_b
        g = jnp.take(packed, flat, axis=0)         # (..., 8)
        w8 = jnp.stack([(1 - tt) * (1 - ty) * (1 - tx),
                        (1 - tt) * (1 - ty) * tx,
                        (1 - tt) * ty * (1 - tx),
                        (1 - tt) * ty * tx,
                        tt * (1 - ty) * (1 - tx),
                        tt * (1 - ty) * tx,
                        tt * ty * (1 - tx),
                        tt * ty * tx], axis=-1)
        return jnp.sum(g * w8, axis=-1)
    out = 0.0
    for ot, wt in ((0, 1.0 - tt), (1, tt)):
        for oy, wy in ((0, 1.0 - ty), (1, ty)):
            for ox, wx in ((0, 1.0 - tx), (1, tx)):
                out = out + wt * wy * wx * _tap(c_vol, t0i + ot, y0i + oy,
                                                x0i + ox,
                                                wrap_theta=wrap_theta)
    return out


def refine_on_surface(c_vol, poses, scores, *, steps: int, theta0, dtheta,
                      crop_iy0, crop_ix0, resolution: float, origin,
                      wrap_theta: bool = False, packed=None):
    """Greedy hill-climb on C: per step, try +/-1 cell / +/-1 bin moves along
    each axis (6 neighbors) and take the best improvement.  The cheap
    stand-in for per-particle matcher refinement at huge P (6 extra taps per
    particle per step instead of hundreds of candidates)."""
    if steps <= 0:
        return poses, scores
    moves = jnp.asarray([[resolution, 0, 0], [-resolution, 0, 0],
                         [0, resolution, 0], [0, -resolution, 0],
                         [0, 0, 1.0], [0, 0, -1.0]], jnp.float32)
    moves = moves.at[:, 2].multiply(dtheta)

    def body(_, carry):
        poses, scores = carry
        cand = poses[..., None, :] + moves            # (..., 6, 3)
        s = sample_surface(c_vol, cand, theta0=theta0, dtheta=dtheta,
                           crop_iy0=crop_iy0, crop_ix0=crop_ix0,
                           resolution=resolution, origin=origin,
                           wrap_theta=wrap_theta, packed=packed)
        k = jnp.argmax(s, axis=-1)
        s_best = jnp.take_along_axis(s, k[..., None], axis=-1)[..., 0]
        p_best = jnp.take_along_axis(cand, k[..., None, None], axis=-2)[
            ..., 0, :]
        better = s_best > scores
        poses = jnp.where(better[..., None], p_best, poses)
        scores = jnp.where(better, s_best, scores)
        return poses, scores

    return jax.lax.fori_loop(0, steps, body, (poses, scores))
