"""Matmul scan-matcher stage scorer: bilinear lookups as matrix contractions.

Third scoring backend for ops/matcher.correlative_match (impl="matmul"),
producing EXACTLY the gather backend's stage-score tensor (same candidate
schedule, same clamping semantics, float-precision-identical values) while
touching memory only through matrix multiplies:

    bilinear(F)(y, x) = a_y(y)^T  F  a_x(x)

where a_y / a_x are two-tap rows ((1-t, t) at floor(y), floor(y)+1).  For a
stage grid of (ny x nx) translation offsets and B beams, all lookups become

    G[oy, b, :] = A_y[oy, b, :] @ F_pad          # ((ny*B), Hp) x (Hp, Wp)
    S[oy, ox]   = sum_{b,w} G[oy, b, w] * A_x[ox, b, w]   # (ny, B*Wp) x ...

— two contractions per theta instead of ny*nx*B*4 random gathers, for
devices whose random gathers are slow next to their matrix units.  The
one-hot operands inflate the arithmetic well beyond the lookups they
replace, so whether this beats the gather backend is a question for
measurement on each device.  Versus the splat backend
(ops/matcher_splat.py) this scores only the (ny*B*Hp) taps that exist
instead of dense frame dots over a >=99%-zero endpoint image.

Out-of-map semantics match the gather backend exactly: the field is padded
with a constant ll_outside band (>= 2 cells) and tap indices clamp into the
padded frame; every tap that falls outside the REAL map region — whether in
the band or clamped to its edge — reads ll_outside, which is precisely the
gather path's per-corner `inb ? F : ll_outside` value (slam/GridMap.java:
273-291 semantics with the documented divergences of ops/matcher.py).

Reference behavior being accelerated: slam/GridMap.java:319-369 (pose
scoring over a search window).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def pad_llfield(llfield, pad: int, ll_outside: float):
    """Constant-pad the log-likelihood field; pad >= 2 keeps clamped taps in
    the constant band (see module docstring)."""
    return jnp.pad(llfield, ((pad, pad), (pad, pad)),
                   constant_values=ll_outside)


def _taps(fs, n: int, nearest: bool, dtype):
    """One-hot tap matrix for positions `fs` (..., B) over an axis of size n.

    Bilinear: two taps (1-t, t) at floor/floor+1; nearest: one tap at round.
    Returns (..., B, n).  Clamping puts out-of-frame taps on the constant
    pad band (callers guarantee pad >= 2)."""
    idx = jnp.arange(n, dtype=jnp.int32)
    if nearest:
        i0 = jnp.clip(jnp.round(fs).astype(jnp.int32), 0, n - 1)
        return (idx == i0[..., None]).astype(dtype)
    f0 = jnp.floor(fs)
    t = (fs - f0).astype(dtype)[..., None]
    i0 = jnp.clip(f0.astype(jnp.int32), 0, n - 2)[..., None]
    return (jnp.where(idx == i0, 1.0 - t, 0.0)
            + jnp.where(idx == i0 + 1, t, 0.0))


def stage_scores_matmul(fpad, px, py, wgt, pose0, dxs, dys, dts, *,
                        resolution, origin, pad: int, nearest: bool = False,
                        bf16: bool = False, f_shift: float = 0.0):
    """Measurement log-likelihood over the (dts, dys, dxs) offset grid.

    Drop-in equal to ops/matcher._stage_scores (same (nt, ny, nx) result)
    given fpad = pad_llfield(llfield, pad, ll_outside) and wgt = the beam
    hit&valid mask as floats.

    Every (theta, dy) candidate row shares this particle's field, so ALL of
    them fold into the M dimension of ONE (nt*ny*B, Hp) x (Hp, Wp) GEMM
    instead of nt tiny batched GEMMs.  The final contraction over (b, w)
    has tiny ny/nx output dims, which a matrix unit would pad to full tiles,
    so it stays a broadcast-multiply-reduce, which XLA fuses into the
    reduction without materializing the product."""
    hp, wp = fpad.shape[-2], fpad.shape[-1]
    dtype = fpad.dtype
    inv_res = 1.0 / resolution

    c = jnp.cos(pose0[2] + dts)[:, None]                      # (nt, 1)
    s = jnp.sin(pose0[2] + dts)[:, None]
    rx = px[None, :] * c - py[None, :] * s + pose0[0]         # (nt, B)
    ry = px[None, :] * s + py[None, :] * c + pose0[1]
    fx = (rx - origin[0]) * inv_res - 0.5 + pad
    fy = (ry - origin[1]) * inv_res - 0.5 + pad
    fys = fy[:, None, :] + (dys * inv_res)[None, :, None]     # (nt, ny, B)
    fxs = fx[:, None, :] + (dxs * inv_res)[None, :, None]     # (nt, nx, B)
    a_y = _taps(fys, hp, nearest, dtype) * wgt[None, None, :, None]
    a_x = _taps(fxs, wp, nearest, dtype)                      # (nt, nx, B, wp)
    if bf16:
        # bf16 operands, f32 accumulation.  Center the
        # field's range around zero first (f_shift) so bf16's 8-bit
        # mantissa lands on the small values; since each beam's bilinear
        # tap weights sum to exactly 1, the shift adds exactly
        # f_shift * n_used to every candidate and cancels in the argmax
        # (we still subtract it to keep absolute scores comparable).
        g = jax.lax.dot_general(
            (a_y.reshape(-1, hp)).astype(jnp.bfloat16),
            (fpad + f_shift).astype(jnp.bfloat16),
            (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32).reshape(a_y.shape[:-1] + (wp,))
        # Store the two big intermediates at bf16 and upcast in-register for
        # the final f32 reduction: the stage moves more bytes than it
        # computes, so halving the g / a_x bytes halves its traffic.
        # Quantization: one bf16 rounding
        # of each stored value (|g| <~ 3 post-shift, |a_x| <= 1) — inside
        # this mode's documented 0.1-0.2 log-score noise.
        g16 = g.astype(jnp.bfloat16)
        ax16 = a_x.astype(jnp.bfloat16)
        s = jnp.sum(g16[:, :, None].astype(jnp.float32)
                    * ax16[:, None].astype(jnp.float32), axis=(-2, -1))
        return s - f_shift * jnp.sum(wgt)
    # HIGHEST keeps this mode honestly f32: at DEFAULT precision a device
    # may round f32 inputs (tap weights AND field values) to bf16 or TF32,
    # which is what the dedicated bf16 mode above does — minus its
    # range-centering.
    g = jnp.einsum("tybh,hw->tybw", a_y, fpad,
                   precision=jax.lax.Precision.HIGHEST)       # one GEMM
    return jnp.sum(g[:, :, None] * a_x[:, None], axis=(-2, -1))
