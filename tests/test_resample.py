"""Resampling / weight statistics tests (slam/SLAM.java:133-190 semantics)."""

import jax
import jax.numpy as jnp
import numpy as np

from gridmap_slam_tpu.ops import resample as R
from gridmap_slam_tpu.oracle import numpy_ref as O


def test_neff_matches_oracle():
    w = np.asarray([0.5, 0.25, 0.125, 0.125])
    lw = jnp.log(jnp.asarray(w))
    got = float(jax.jit(R.neff)(lw))
    want = 1.0 / np.sum(w ** 2)
    assert abs(got - want) < 1e-4


def test_neff_uniform_is_n():
    lw = jnp.zeros(64) - 3.0
    assert abs(float(jax.jit(R.neff)(lw)) - 64.0) < 1e-3


def test_systematic_indices_proportional():
    # counts of each ancestor must match systematic-resampling guarantees:
    # floor(N*w) <= count <= ceil(N*w)
    w = np.asarray([0.4, 0.3, 0.2, 0.05, 0.05])
    n = len(w)
    lw = jnp.log(jnp.asarray(w))
    f = jax.jit(R.systematic_indices)
    for seed in range(5):
        idx = np.asarray(f(jax.random.key(seed), lw))
        counts = np.bincount(idx, minlength=n)
        for i in range(n):
            assert np.floor(n * w[i]) <= counts[i] <= np.ceil(n * w[i]), (
                seed, i, counts)


def test_systematic_matches_oracle_given_same_r():
    # With the same start offset r, cumsum-searchsorted must equal the
    # oracle's while-loop walk.
    w = np.asarray([0.15, 0.1, 0.3, 0.05, 0.25, 0.15])
    n = len(w)
    for r in [0.0, 0.01, 0.123 / n, 0.9999 / n]:
        cum = np.cumsum(w)
        u = r + np.arange(n) / n
        ours = np.clip(np.searchsorted(cum, u), 0, n - 1)

        class FakeRng:
            def uniform(self, a, b):
                return r
        oracle = O.systematic_resample(FakeRng(), w)
        np.testing.assert_array_equal(ours, oracle)


def test_weighted_mean_pose():
    poses = jnp.asarray([[1.0, 0.0, 0.1], [3.0, 2.0, -0.1]])
    lw = jnp.log(jnp.asarray([0.25, 0.75]))
    out = np.asarray(jax.jit(R.weighted_mean_pose)(poses, lw))
    np.testing.assert_allclose(out, [2.5, 1.5, -0.05], atol=1e-5)


def test_log_weight_shift_invariance():
    lw = jnp.asarray([-1000.0, -1001.0, -999.5])
    w1 = np.asarray(jax.jit(R.normalized_weights)(lw))
    w2 = np.asarray(jax.jit(R.normalized_weights)(lw + 500.0))
    np.testing.assert_allclose(w1, w2, atol=1e-6)
    assert abs(w1.sum() - 1.0) < 1e-6


def test_rank_indices_matches_searchsorted_big_p():
    """The huge-P sorted-merge rank path (used for n >= 2^16 in place of
    searchsorted's per-query binary search) produces searchsorted's exact
    indices."""
    import jax.numpy as jnp
    from gridmap_slam_tpu.ops.resample import _rank_indices
    rng = np.random.RandomState(0)
    n = 1 << 16
    w = rng.dirichlet(np.full(n, 0.2)).astype(np.float32)
    cum = jnp.cumsum(jnp.asarray(w))
    r = 0.3 / n
    u = r + jnp.arange(n, dtype=jnp.float32) / n
    want = jnp.searchsorted(cum, u)
    got = _rank_indices(cum, u, n)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_bitonic_merge_rank_matches_searchsorted_exactly():
    """The hybrid bitonic-merge rank (round 5, the huge-P resampling path)
    must be INDEX-EXACT vs searchsorted-left — including on exact f32
    u == cum ties, which spiky weights make common (~0.1 % of rows at
    2^16; the LSB tag-packing is what breaks them correctly)."""
    import jax
    import jax.numpy as jnp
    from gridmap_slam_tpu.ops.resample import _bitonic_merge_rank

    rng = np.random.RandomState(7)
    for n, alpha in ((1 << 16, 0.3), (70_000, 0.01), (100_000, 5.0)):
        w = rng.dirichlet(np.full(n, alpha)).astype(np.float64)
        cum = np.cumsum(w).astype(np.float32)
        r = rng.uniform(0, 1.0 / n)
        u = (r + np.arange(n) / n).astype(np.float32)
        got = np.asarray(jax.jit(_bitonic_merge_rank, static_argnums=2)(
            jnp.asarray(cum), jnp.asarray(u), n))
        want = np.searchsorted(cum, u)
        np.testing.assert_array_equal(got, want)
