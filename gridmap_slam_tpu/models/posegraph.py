"""Pose-graph backend: keyframes, loop closure, Gauss-Newton optimization.

The reference has no pose-graph/loop-closure capability — this is the
capability extension required by the north star (BASELINE.json: "pose-graph
backend with loop closure refined by sparse bundle adjustment").

Design: residuals and Jacobians for all constraints are computed in one
vmapped batch; the normal equations are assembled with scatter-adds into block
structure and solved densely (Cholesky) — appropriate for up to a few thousand
keyframes on one chip.  Edges are fixed-width (padded with zero-information
rows) so the whole optimize step jits once.  Loop-closure candidates are
verified with the same correlative matcher used for scan-to-map alignment,
scoring a scan against a local grid built from the paired keyframe's scan.

The distributed Schur-complement path (multi-host BA over psum collectives)
builds on `normal_equations`; see parallel/ba.py.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.geometry import wrap_angle
from ..types import pytree_dataclass


@pytree_dataclass
class PoseGraph:
    """nodes: (K, 3) SE(2) poses; edges i->j with relative measurements.

    edge_i/edge_j: (E,) int32 node indices.
    edge_z:        (E, 3) measured relative pose of j in i's frame.
    edge_w:        (E, 3) diagonal information (weights) per residual
                   dimension; 0 rows are padding and contribute nothing.
    """

    nodes: jax.Array
    edge_i: jax.Array
    edge_j: jax.Array
    edge_z: jax.Array
    edge_w: jax.Array


def odometry_edges(poses: np.ndarray, w_xy: float = 100.0,
                   w_t: float = 400.0):
    """Build sequential edges from a trajectory of keyframe poses."""
    k = len(poses)
    i = np.arange(k - 1)
    j = i + 1
    z = np.stack([_relative_np(poses[a], poses[b]) for a, b in zip(i, j)])
    w = np.tile(np.asarray([w_xy, w_xy, w_t]), (k - 1, 1))
    return i.astype(np.int32), j.astype(np.int32), z.astype(np.float32), \
        w.astype(np.float32)


def _relative_np(a, b):
    c, s = math.cos(a[2]), math.sin(a[2])
    dx, dy = b[0] - a[0], b[1] - a[1]
    dt = math.atan2(math.sin(b[2] - a[2]), math.cos(b[2] - a[2]))
    return np.asarray([c * dx + s * dy, -s * dx + c * dy, dt])


def residuals_and_jacobians(nodes, edge_i, edge_j, edge_z):
    """Batched SE(2) edge residuals e = [R_i^T (t_j - t_i) - z_t,
    wrap(th_j - th_i - z_th)] and their 3x3 Jacobians wrt nodes i and j."""
    pi = nodes[edge_i]                       # (E, 3)
    pj = nodes[edge_j]
    c, s = jnp.cos(pi[:, 2]), jnp.sin(pi[:, 2])
    dx = pj[:, 0] - pi[:, 0]
    dy = pj[:, 1] - pi[:, 1]
    ex = c * dx + s * dy - edge_z[:, 0]
    ey = -s * dx + c * dy - edge_z[:, 1]
    et = wrap_angle(pj[:, 2] - pi[:, 2] - edge_z[:, 2])
    e = jnp.stack([ex, ey, et], -1)          # (E, 3)

    zeros = jnp.zeros_like(c)
    ones = jnp.ones_like(c)
    # d e / d (xi, yi, thi)
    ji = jnp.stack([
        jnp.stack([-c, -s, -s * dx + c * dy], -1),
        jnp.stack([s, -c, -c * dx - s * dy], -1),
        jnp.stack([zeros, zeros, -ones], -1),
    ], -2)                                    # (E, 3, 3)
    # d e / d (xj, yj, thj)
    jj = jnp.stack([
        jnp.stack([c, s, zeros], -1),
        jnp.stack([-s, c, zeros], -1),
        jnp.stack([zeros, zeros, ones], -1),
    ], -2)
    return e, ji, jj


def normal_equations(nodes, edge_i, edge_j, edge_z, edge_w):
    """Dense Gauss-Newton normal equations of an edge set: (H (3K, 3K),
    b (3K,), chi2), assembled with scatter-adds.  The per-edge products run
    at HIGHEST precision: at DEFAULT an accelerator may round f32 matmul
    inputs to bf16 or TF32.  parallel/ba.py psums these over edge shards."""
    k = nodes.shape[0]
    e, ji, jj = residuals_and_jacobians(nodes, edge_i, edge_j, edge_z)
    w = edge_w                                         # (E, 3)
    chi2 = jnp.sum(w * e * e)

    wji = w[:, :, None] * ji                           # (E, 3, 3) row-scaled
    wjj = w[:, :, None] * jj
    hp = jax.lax.Precision.HIGHEST
    h_ii = jnp.einsum("eab,eac->ebc", ji, wji, precision=hp)
    h_jj = jnp.einsum("eab,eac->ebc", jj, wjj, precision=hp)
    h_ij = jnp.einsum("eab,eac->ebc", ji, wjj, precision=hp)
    b_i = jnp.einsum("eab,ea->eb", ji, w * e, precision=hp)
    b_j = jnp.einsum("eab,ea->eb", jj, w * e, precision=hp)

    hb = jnp.zeros((k, k, 3, 3), nodes.dtype)
    hb = hb.at[edge_i, edge_i].add(h_ii)
    hb = hb.at[edge_j, edge_j].add(h_jj)
    hb = hb.at[edge_i, edge_j].add(h_ij)
    hb = hb.at[edge_j, edge_i].add(jnp.swapaxes(h_ij, -1, -2))
    b = jnp.zeros((k, 3), nodes.dtype)
    b = b.at[edge_i].add(b_i)
    b = b.at[edge_j].add(b_j)
    return hb.transpose(0, 2, 1, 3).reshape(3 * k, 3 * k), b.reshape(3 * k), \
        chi2


def gauss_newton_step(graph: PoseGraph, damping: float = 1e-6,
                      anchor_w: float = 1e6):
    """One damped Gauss-Newton update of all node poses.

    Assembles the dense normal equations H dx = -b from all edges and
    solves by Cholesky; node 0 is anchored with a strong prior (gauge
    fixing).  Returns (new_graph, chi2).
    """
    nodes = graph.nodes
    k = nodes.shape[0]
    h, b, chi2 = normal_equations(nodes, graph.edge_i, graph.edge_j,
                                  graph.edge_z, graph.edge_w)
    # gauge anchor on node 0 + Levenberg damping
    diag = jnp.concatenate([jnp.full((3,), anchor_w, nodes.dtype),
                            jnp.full((3 * (k - 1),), damping, nodes.dtype)])
    h = h + jnp.diag(diag)

    dx = jax.scipy.linalg.solve(h, -b, assume_a="pos").reshape(k, 3)
    new_nodes = nodes + dx
    new_nodes = new_nodes.at[:, 2].set(wrap_angle(new_nodes[:, 2]))
    return graph.replace(nodes=new_nodes), chi2


def optimize(graph: PoseGraph, iterations: int = 10,
             damping: float = 1e-6) -> Tuple[PoseGraph, jax.Array]:
    """Run fixed-iteration Gauss-Newton (jittable; lax.scan over iters).

    Matmul precision is pinned to f32: at DEFAULT precision an accelerator
    may run f32 matmuls with reduced-precision inputs (bf16 or TF32), and
    at a couple hundred nodes normal equations assembled that way can lose
    positive definiteness — Cholesky then yields NaN chi2."""

    def body(g, _):
        g, chi2 = gauss_newton_step(g, damping)
        return g, chi2

    with jax.default_matmul_precision("float32"):
        graph, chi2s = jax.lax.scan(body, graph, None, length=iterations)
    return graph, chi2s


# --------------------------------------------------------------- loop closure
class ClosureProposals(NamedTuple):
    pairs: np.ndarray          # (C, 2) keyframe index pairs (i < j)


def propose_closures(poses: np.ndarray, min_gap: int = 10,
                     max_dist: float = 1.0, max_candidates: int = 64
                     ) -> ClosureProposals:
    """Host-side candidate generation: keyframe pairs that are spatially close
    but temporally distant (odometry says 'near', the graph hasn't linked
    them).  When the candidate set exceeds `max_candidates` the LATEST pairs
    are kept (late closures span the most drift and are the valuable ones)
    and the truncation is logged."""
    p = np.asarray(poses)
    k = len(p)
    pairs = []
    for j in range(k):
        d = np.linalg.norm(p[:j - min_gap + 1, :2] - p[j, :2], axis=1) \
            if j - min_gap + 1 > 0 else np.empty((0,))
        for i in np.nonzero(d < max_dist)[0]:
            pairs.append((i, j))
    if len(pairs) > max_candidates:
        import logging
        logging.getLogger(__name__).warning(
            "propose_closures: %d candidates > max_candidates=%d; keeping "
            "the latest %d", len(pairs), max_candidates, max_candidates)
        pairs = pairs[-max_candidates:]
    return ClosureProposals(
        pairs=np.asarray(pairs, np.int32).reshape(-1, 2))


def verify_closure(scan_i, scan_j, rel_guess, *, map_cfg, matcher_cfg,
                   motion_cfg, sensor_cfg, kernel, beam_lut_bins=2048):
    """Score candidate closure (i, j): build a local grid from scan_i at the
    origin, correlatively match scan_j starting from the odometry-implied
    relative pose.  Returns (refined_rel (3,), mean_beam_loglik) where
    mean_beam_loglik is the measurement log-likelihood at the best pose
    *per used beam* — normalizing makes the acceptance threshold independent
    of beam count; the uniform (no-information) level is log(1/max_range).

    Jittable; vmap over candidates for batch verification."""
    from ..ops.grid import likelihood_field
    from ..ops.matcher import correlative_match, log_likelihood_field
    from ..ops.raycast import build_beam_lut, integrate_scan
    from ..types import Odom

    h, w = map_cfg.cells_y, map_cfg.cells_x
    origin = (float(map_cfg.origin[0]), float(map_cfg.origin[1]))
    res = float(map_cfg.resolution)
    lut = build_beam_lut(scan_i, beam_lut_bins)
    zero_pose = jnp.zeros(3, jnp.float32)
    # cone_fill: a single scan's 1-cell-wide rays leave the local field
    # dominated by blurred unknown (uninformative, ~every alignment scores
    # alike); carving the full visibility polygon makes free space free.
    delta = integrate_scan(jnp.zeros((h, w), jnp.float32), zero_pose, scan_i,
                           lut, resolution=res, origin=origin,
                           l_free=sensor_cfg.l_free, l_occ=sensor_cfg.l_occ,
                           tol_cells=sensor_cfg.hit_tolerance_cells,
                           cone_fill=True)
    field, unknown = likelihood_field(delta, kernel)
    # correlative_match's contract is a LOG-likelihood field
    # (ops/matcher.log_likelihood_field) — raw probabilities would mix
    # [0, 1] in-map values with log-scale out-of-map penalties.
    llf = log_likelihood_field(field, unknown, matcher_cfg.z_hit,
                               sensor_cfg.max_range)
    odom = Odom(d_center=jnp.float32(0.0), d_theta=jnp.float32(0.0))
    rel, logscore = correlative_match(
        llf, scan_j, rel_guess, odom,
        matcher_cfg=matcher_cfg, motion_cfg=motion_cfg,
        resolution=res, origin=origin, max_range=sensor_cfg.max_range)
    n_used = jnp.maximum(jnp.sum((scan_j.valid & scan_j.hit)
                                 .astype(jnp.float32)), 1.0)
    return rel, logscore / n_used


def _se2_inverse(rel):
    c, s = jnp.cos(rel[2]), jnp.sin(rel[2])
    return jnp.stack([-(c * rel[0] + s * rel[1]),
                      -(-s * rel[0] + c * rel[1]),
                      -rel[2]])


def verify_closure_bidirectional(scan_i, scan_j, rel_guess, *, map_cfg,
                                 matcher_cfg, motion_cfg, sensor_cfg, kernel,
                                 beam_lut_bins=2048):
    """Two-way closure verification: match j against i's local map, then i
    against j's map starting from the inverse of the forward result.

    Returns (rel_fwd (3,), min_score, consistency_m):
      min_score      - the worse of the two per-beam mean log-likelihoods
                       (a false match rarely scores well both ways);
      consistency_m  - | rel_fwd o rel_rev | translation magnitude; a true
                       closure composes to ~identity, while perceptual
                       aliasing (symmetric rooms) shows up as a large
                       forward/backward disagreement even when both scores
                       look good.

    Jittable; vmap over candidates."""
    kw = dict(map_cfg=map_cfg, matcher_cfg=matcher_cfg, motion_cfg=motion_cfg,
              sensor_cfg=sensor_cfg, kernel=kernel,
              beam_lut_bins=beam_lut_bins)
    rel_f, s_f = verify_closure(scan_i, scan_j, rel_guess, **kw)
    rel_r, s_r = verify_closure(scan_j, scan_i, _se2_inverse(rel_f), **kw)
    c, s = jnp.cos(rel_f[2]), jnp.sin(rel_f[2])
    dx = rel_f[0] + c * rel_r[0] - s * rel_r[1]
    dy = rel_f[1] + s * rel_r[0] + c * rel_r[1]
    return rel_f, jnp.minimum(s_f, s_r), jnp.sqrt(dx * dx + dy * dy)
