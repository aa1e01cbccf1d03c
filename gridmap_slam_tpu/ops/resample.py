"""Particle weights and low-variance (systematic) resampling.

Reference behavior: slam/SLAM.java:120-153 and slam/ParticleFilter.java:59-82
("Probabilistic Robotics p.110"): draw r ~ U[0, 1/N), take U_m = r + (m-1)/N
and select the first particle whose cumulative weight exceeds U_m; the
selected particle is deep-copied (pose + both map arrays).

Design: weights live in log space (the reference multiplies ~180 raw
probabilities in double precision; float32 needs log-sum form).  The
"while U > c" walk becomes cumsum + searchsorted, and the deep copy becomes a
single gather over the particle axis of the (P, H, W) map tensor.  Under a
sharded particle axis XLA lowers the gather to collective-permute traffic.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def normalized_weights(log_weights):
    """exp-normalize log weights to a probability vector."""
    lw = log_weights - jnp.max(log_weights)
    w = jnp.exp(lw)
    return w / jnp.sum(w)


def neff(log_weights):
    """Effective sample size 1 / sum(w^2) (slam/SLAM.java:180-190)."""
    w = normalized_weights(log_weights)
    return 1.0 / jnp.sum(w * w)


def _rank_indices(cum, u, n):
    """idx_j = #{i : cum_i < u_j} via ONE variadic merge-sort instead of
    searchsorted's ~20 rounds of random gathers per query.  Both cum and u
    are ascending; u entries are placed
    FIRST in the concat so the stable sort keeps them before equal cum
    values (searchsorted side='left' strictness)."""
    key = jnp.concatenate([u, cum])
    tag = jnp.concatenate([jnp.ones((n,), jnp.int32),
                           jnp.zeros((n,), jnp.int32)])
    _, stag = jax.lax.sort((key, tag), dimension=0, is_stable=True,
                           num_keys=1)
    ranks = jnp.cumsum(stag)                   # inclusive #u at-or-before
    pos = jnp.arange(2 * n, dtype=jnp.int32)
    idx_at = pos - ranks + 1                   # #cum strictly before
    # u_j is the j-th u in merged order (u ascending): scatter to j
    out = jnp.zeros((n,), jnp.int32).at[
        jnp.where(stag == 1, ranks - 1, n)].set(idx_at, mode="drop")
    return out


def _bitonic_merge_rank(cum, u, n):
    """Same ranks as _rank_indices, via a BITONIC MERGE instead of a full
    sort: both inputs are already sorted, so the concatenation
    [u ascending | pad | cum descending] is bitonic and log2(m)
    compare-exchange stages of contiguous reshaped min/max sort it —
    zero gathers and no O(m log^2 m) sorting network.  Each stage is one
    fused elementwise pass over a single int32 array, so the whole merge
    is ~21 streaming passes at 1M particles.

    searchsorted-left tie semantics are EXACT by construction: keys are
    bitcast to int32 (order-preserving for non-negative floats; all
    values < 2.0, so bits < 2^30) and the u/cum tag is packed into the
    LSB with u = 0 — on an exact u == cum f32 tie the u element sorts
    first, i.e. the cum element counts as NOT-before, exactly like
    jnp.searchsorted(..., side='left').

    The merge is HYBRID: slicing min/max stages while k >= 8192, then one
    batched lax.sort over the now-bitonic inter-ordered 8192-blocks (the
    short-k stages are where a native sort does better).  The block size
    and the choice against searchsorted or one lax.sort are open to
    measurement on each device."""
    block = 8192
    m = 1 << (2 * n - 1).bit_length()
    pad = m - 2 * n
    key = jnp.concatenate(
        [u, jnp.full((pad,), 1.999, u.dtype), cum[::-1]])
    is_u = jnp.concatenate([jnp.ones((n,), jnp.int32),
                            jnp.zeros((pad + n,), jnp.int32)])
    bits = jax.lax.bitcast_convert_type(key.astype(jnp.float32), jnp.int32)
    comp = (bits << 1) | (1 - is_u)
    k = m // 2
    while k >= block and k >= 1:
        cr = comp.reshape(-1, 2, k)
        lo, hi = cr[:, 0], cr[:, 1]
        comp = jnp.stack([jnp.minimum(lo, hi), jnp.maximum(lo, hi)],
                         axis=1).reshape(m)
        k //= 2
    if m > block:
        # every `block`-sized run is bitonic and runs are inter-ordered:
        # finish with one batched small sort
        comp = jax.lax.sort(comp.reshape(-1, block), dimension=1,
                            is_stable=False).reshape(m)
    else:
        comp = jax.lax.sort(comp, dimension=0, is_stable=False)
    tag = 1 - (comp & 1)                       # u elements after the merge
    ranks = jnp.cumsum(tag)                    # inclusive #u at-or-before
    pos = jnp.arange(m, dtype=jnp.int32)
    idx_at = pos - ranks + 1                   # #cum strictly before
    out = jnp.zeros((n,), jnp.int32).at[
        jnp.where(tag == 1, ranks - 1, n)].set(idx_at, mode="drop")
    return out


def systematic_indices(key, log_weights):
    """Systematic resampling ancestor indices (slam/SLAM.java:133-153)."""
    n = log_weights.shape[0]
    w = normalized_weights(log_weights)
    cum = jnp.cumsum(w)
    r = jax.random.uniform(key, (), minval=0.0, maxval=1.0 / n)
    u = r + jnp.arange(n, dtype=w.dtype) / n
    if n >= (1 << 16):
        # huge-P fast path (identical indices up to float ties, which the
        # continuous r makes measure-zero; small P keeps searchsorted for
        # bit-parity with the oracle comparisons)
        idx = _bitonic_merge_rank(cum, u, n)
    else:
        idx = jnp.searchsorted(cum, u)
    return jnp.clip(idx, 0, n - 1).astype(jnp.int32)


def weighted_mean_pose(poses, log_weights):
    """Weighted mean pose; theta averaged after wrapping to (-pi, pi]
    (slam/SLAM.java:165-178 — the reference averages constrained angles
    linearly, which we reproduce)."""
    from .geometry import wrap_angle
    w = normalized_weights(log_weights)
    x = jnp.sum(poses[:, 0] * w)
    y = jnp.sum(poses[:, 1] * w)
    t = jnp.sum(wrap_angle(poses[:, 2]) * w)
    return jnp.stack([x, y, t])
