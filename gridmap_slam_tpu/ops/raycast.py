"""Dense beam-endpoint occupancy-grid update.

Reference behavior: slam/GridMap.java:173-228 walks a DDA ray per beam
(slam/RayIterator.java) and accumulates log-odds from the inverse sensor model
(slam/SensorModel.java:31-41) into each visited cell, with hitTolerance=2 cells
and 2 extra wall-thickness steps past the endpoint.

Design: instead of serial, data-dependent ray walks with scatter-adds (the
reference's hot loop #3, SURVEY.md §3.3), every grid cell computes its own
update in parallel from the scan — a *gather* formulation:

  1. Each cell finds its bearing phi and range r from the pose.
  2. A per-scan bearing->nearest-beam lookup table (built once, shared by all
     particles) maps phi to the beam b whose ray passes nearest to the cell.
  3. The cell is "on the ray" iff its perpendicular offset from beam b's ray
     is within the ray's 1-cell-wide footprint (|r sin(dphi)| <= half the
     cell's extent projected across the ray direction — exactly the cell set a
     DDA traversal visits, up to sub-cell rounding).
  4. On-ray cells apply the inverse sensor model by range: free before the
     measured distance minus one cell, occupied within +/-1 cell of it
     (hit beams), nothing beyond.

This is O(H*W) fully-vectorized work per particle with two tiny gathers,
no scatter, no data-dependent control flow — and map tiles update
independently (a cell's update depends only on pose+scan), which removes the
halo problem for sharded maps entirely.

Known divergence from the reference (documented, see SURVEY.md §7 "hard
parts"): cells near the sensor are crossed by many beams and the reference
accumulates one inverse-sensor-model update per crossing beam, while this
formulation applies exactly one update per cell per scan (the nearest beam).
Cell *classification* (free/occupied sign) is preserved; only the
accumulation magnitude near the robot differs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..types import Scan
from .geometry import wrap_angle

_TWO_PI = 6.283185307179586


def build_beam_lut(scan: Scan, n_bins: int):
    """Bearing -> beam-index lookup table, shared across particles.

    Bins cover (-pi, pi]; each bin stores the index of the valid beam with the
    nearest angle (circular distance).  Invalid (padding) beams are never
    selected.  Returns (lut, any_valid) with lut: (n_bins,) int32.
    """
    ang = jnp.where(scan.valid, wrap_angle(scan.angle), jnp.inf)
    order = jnp.argsort(ang)
    sorted_ang = ang[order]
    n_valid = jnp.maximum(jnp.sum(scan.valid.astype(jnp.int32)), 1)

    centers = -jnp.pi + (jnp.arange(n_bins, dtype=jnp.float32) + 0.5) * (
        _TWO_PI / n_bins)
    pos = jnp.searchsorted(sorted_ang, centers)
    left = (pos - 1) % n_valid
    right = pos % n_valid
    d_left = jnp.abs(wrap_angle(centers - sorted_ang[left]))
    d_right = jnp.abs(wrap_angle(centers - sorted_ang[right]))
    pick = jnp.where(d_left <= d_right, left, right)
    return order[pick].astype(jnp.int32)


def bearing_to_beam(lut, phi):
    """Look up nearest beam indices for bearings phi (any shape)."""
    n_bins = lut.shape[0]
    b = jnp.floor((wrap_angle(phi) + jnp.pi) * (n_bins / _TWO_PI)).astype(jnp.int32)
    b = jnp.clip(b, 0, n_bins - 1)
    return lut[b]


# Cell-count threshold for the one-hot GEMM beam-value path: above this the
# (cells, 64) one-hot operand's memory outweighs the gather savings.
_GEMM_CELLS_MAX = 1 << 18


def _beam_values_for_cells(scan: Scan, lut, phi, one_hot=None):
    """Per-cell (alpha, dist, hit, valid) of each cell's nearest beam.

    phi: (H, W) bearings in the robot frame.  The naive formulation is 5
    random gathers per cell (lut + four scan fields).  Instead the bin
    tables are built ONCE per scan (2048 tiny gathers, particle-independent)
    and the per-cell table read becomes a two-level one-hot contraction:
    bin = hi*LO + lo, so

        vals[c] = sum_lo OH_lo[c, lo] * (OH_hi @ T2)[c, lo, :]

    with OH_hi: (cells, HI) one-hot in a matrix product and the
    lo-reduction fused elementwise — zero per-cell gathers.  The other
    branch is ONE packed per-cell gather of the (n_bins, 4) table (4x fewer
    gather rows than the naive path); both give bit-identical values.
    one_hot=None takes the contraction up to _GEMM_CELLS_MAX cells (huge
    shared maps gather); True/False force a branch.  Which formulation is
    faster on a given device is open to measurement.
    """
    n_bins = lut.shape[0]
    h, w = phi.shape
    table = jnp.stack([scan.angle[lut], scan.dist[lut],
                       scan.hit[lut].astype(jnp.float32),
                       scan.valid[lut].astype(jnp.float32)], axis=-1)
    b = jnp.floor((wrap_angle(phi) + jnp.pi) * (n_bins / _TWO_PI))
    b = jnp.clip(b.astype(jnp.int32), 0, n_bins - 1)

    hi_n = 64 if n_bins % 64 == 0 else 0
    if one_hot is None:
        one_hot = h * w <= _GEMM_CELLS_MAX
    if hi_n and one_hot:
        lo_n = n_bins // hi_n
        cells = h * w
        bf = b.reshape(cells)
        hi = bf // lo_n
        lo = bf % lo_n
        oh_hi = (jnp.arange(hi_n, dtype=jnp.int32)[None, :]
                 == hi[:, None]).astype(jnp.float32)          # (cells, HI)
        t2 = table.reshape(hi_n, lo_n * 4)
        # At DEFAULT precision a device may round f32 matmul inputs to
        # bf16 or TF32 — which would round the table's distances/angles and
        # shift occupied bands by up to a cell.  The one-hot side is exact
        # in any format (0/1), so one-sided HIGHEST keeps the selection
        # BIT-EXACT while letting the one-hot operand stay narrow.
        m2 = jax.lax.dot(
            oh_hi, t2,
            precision=(jax.lax.Precision.DEFAULT,
                       jax.lax.Precision.HIGHEST)).reshape(cells, lo_n, 4)
        oh_lo = (jnp.arange(lo_n, dtype=jnp.int32)[None, :]
                 == lo[:, None]).astype(jnp.float32)          # (cells, LO)
        vals = jnp.sum(oh_lo[:, :, None] * m2, axis=1)        # fused
        vals = vals.reshape(h, w, 4)
    else:
        vals = jnp.take(table, b, axis=0)                     # (H, W, 4)
    return (vals[..., 0], vals[..., 1], vals[..., 2] > 0.5,
            vals[..., 3] > 0.5)


def integrate_scan(logodds, pose, scan: Scan, lut, *, resolution: float,
                   origin, l_free: float, l_occ: float,
                   tol_cells: float = 2.0, cone_fill: bool = False):
    """Dense per-cell log-odds update for one particle.

    logodds: (H, W); pose: (3,); returns the log-odds *delta* (H, W) so the
    caller can mask the large-rotation skip (slam/SLAM.java:82) with a simple
    multiply.

    cone_fill=False (default) restricts updates to the ~1-cell-wide ray
    footprint — the cell set the reference's DDA visits
    (slam/RayIterator.java), required for map-building parity.
    cone_fill=True instead carves the full angular wedge owned by each beam
    (the scan's visibility polygon): every cell whose nearest-beam range
    bounds it is updated.  Use for single-scan local maps (loop-closure
    verification), where thin rays leave the field dominated by blurred
    unknown and nearly uninformative.
    """
    h, w = logodds.shape
    ix = jnp.arange(w, dtype=jnp.float32)
    iy = jnp.arange(h, dtype=jnp.float32)
    cx = origin[0] + (ix[None, :] + 0.5) * resolution
    cy = origin[1] + (iy[:, None] + 0.5) * resolution

    dx = cx - pose[0]
    dy = cy - pose[1]
    r = jnp.sqrt(dx * dx + dy * dy)
    phi = jnp.arctan2(dy, dx) - pose[2]     # bearing in robot frame

    alpha, m, hit, valid = _beam_values_for_cells(scan, lut, phi)

    dphi = wrap_angle(phi - alpha)
    # Ray footprint: a unit cell is crossed by a line at angle `wba` iff the
    # perpendicular distance from its center is <= (|cos|+|sin|)/2 cells.
    wba = pose[2] + alpha
    # The 1.001 guard keeps cells whose centers sit exactly on the ray's
    # footprint boundary (e.g. an axis-aligned beam from a cell-edge pose)
    # from flickering in/out on float rounding.
    halfw = 0.5005 * (jnp.abs(jnp.cos(wba)) + jnp.abs(jnp.sin(wba))) * resolution
    perp = r * jnp.sin(dphi)
    if cone_fill:
        on_ray = (jnp.cos(dphi) > 0.0) & valid
    else:
        on_ray = (jnp.abs(perp) <= halfw) & (jnp.cos(dphi) > 0.0) & valid

    tol_m = 0.5 * tol_cells * resolution    # hitTolerance/2 in meters
    free_hit = r < (m - tol_m)
    occ_band = (r >= (m - tol_m)) & (r <= (m + tol_m))
    delta_hit = jnp.where(free_hit, l_free, jnp.where(occ_band, l_occ, 0.0))
    delta_miss = jnp.where(r < m, l_free, 0.0)
    delta = jnp.where(on_ray, jnp.where(hit, delta_hit, delta_miss), 0.0)
    return delta.astype(logodds.dtype)
