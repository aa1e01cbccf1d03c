"""Correlative scan matcher tests: recovery of a known pose offset."""

import math

import jax
import jax.numpy as jnp
import numpy as np

from gridmap_slam_tpu.config import MatcherConfig, MotionConfig, SlamConfig
from gridmap_slam_tpu.ops.grid import gaussian_kernel, likelihood_field
from gridmap_slam_tpu.ops.matcher import (correlative_match,
                                          log_likelihood_field, score_pose)
from gridmap_slam_tpu.ops.raycast import build_beam_lut, integrate_scan
from gridmap_slam_tpu.oracle.numpy_ref import OracleGridMap
from gridmap_slam_tpu.types import Odom, Scan

RES = 0.05
ORIGIN = (-3.0, -3.0)


def _make_scan(n=90, seed=0):
    rng = np.random.RandomState(seed)
    angles = np.linspace(-np.pi, np.pi, n, endpoint=False)
    dists = 1.0 + 1.2 * np.abs(np.cos(2 * angles)) + rng.uniform(0, 0.05, n)
    return Scan.from_arrays(angles, dists, np.ones(n, bool), max_beams=128)


def _llfield_from_scan(scan, pose):
    """Integrate the scan at `pose`, build the effective likelihood field."""
    lut = build_beam_lut(scan, 2048)
    delta = integrate_scan(jnp.zeros((120, 120), jnp.float32),
                           jnp.asarray(pose, jnp.float32), scan, lut,
                           resolution=RES, origin=ORIGIN,
                           l_free=math.log(0.3 / 0.7),
                           l_occ=math.log(0.9 / 0.1))
    kernel = gaussian_kernel(1.0, 3)
    field, unknown = likelihood_field(delta, kernel)
    return log_likelihood_field(field, unknown, 0.9, 10.0)


def test_matcher_recovers_offset():
    """Build a map from a scan at the true pose, then start the matcher from
    a perturbed pose: it must recover the truth within ~a cell."""
    scan = _make_scan()
    true_pose = [0.1, -0.2, 0.15]

    @jax.jit
    def run(start):
        llfield = _llfield_from_scan(scan, true_pose)
        odom = Odom(d_center=jnp.float32(0.0), d_theta=jnp.float32(0.0))
        return correlative_match(
            llfield, scan, start, odom,
            matcher_cfg=MatcherConfig(prior_weight=0.0),
            motion_cfg=MotionConfig(),
            resolution=RES, origin=ORIGIN, max_range=10.0)

    for dx, dy, dt in [(0.1, -0.08, 0.1), (-0.12, 0.1, -0.12), (0.0, 0.0, 0.0)]:
        start = jnp.asarray([true_pose[0] + dx, true_pose[1] + dy,
                             true_pose[2] + dt], jnp.float32)
        best, score = run(start)
        best = np.asarray(best)
        assert abs(best[0] - true_pose[0]) < 0.06, (dx, dy, dt, best)
        assert abs(best[1] - true_pose[1]) < 0.06, (dx, dy, dt, best)
        assert abs(best[2] - true_pose[2]) < 0.05, (dx, dy, dt, best)


def test_score_higher_at_true_pose():
    scan = _make_scan()
    true_pose = [0.0, 0.0, 0.0]

    @jax.jit
    def scores():
        llfield = _llfield_from_scan(scan, true_pose)
        kw = dict(z_hit=0.9, resolution=RES, origin=ORIGIN, max_range=10.0)
        s_true = score_pose(llfield, scan, jnp.asarray(true_pose, jnp.float32),
                            **kw)
        s_off = score_pose(llfield, scan,
                           jnp.asarray([0.3, 0.25, 0.3], jnp.float32), **kw)
        return s_true, s_off

    s_true, s_off = scores()
    assert float(s_true) > float(s_off) + 10.0


def test_unknown_map_scores_uniform():
    """On a fully-unknown map every hit beam scores exactly 1/max_range
    (slam/GridMap.java:285-288)."""
    scan = _make_scan(n=40)

    @jax.jit
    def run():
        kernel = gaussian_kernel(1.0, 3)
        field, unknown = likelihood_field(jnp.zeros((120, 120), jnp.float32),
                                          kernel)
        llfield = log_likelihood_field(field, unknown, 0.9, 10.0)
        return score_pose(llfield, scan, jnp.zeros(3, jnp.float32),
                          z_hit=0.9, resolution=RES, origin=ORIGIN,
                          max_range=10.0)

    got = float(run())
    want = 40 * math.log(1.0 / 10.0)
    assert abs(got - want) < 1e-2


def test_matcher_impl_auto_and_pallas_resolution(monkeypatch):
    """impl resolution policy: 'auto' is the gather backend whatever the
    platform (no backend test), and the removed 'pallas' impl is refused
    by name — by the resolver and by every engine's constructor — instead
    of silently running another backend."""
    import jax
    import pytest as _pytest
    from gridmap_slam_tpu.config import SlamConfig
    from gridmap_slam_tpu.models.rbpf import RBPF
    from gridmap_slam_tpu.models.shared import SharedMapSLAM
    from gridmap_slam_tpu.ops.matcher import MATCHER_IMPLS, resolve_impl

    for platform in ("cpu", "gpu"):
        monkeypatch.setattr(jax, "default_backend", lambda p=platform: p)
        assert resolve_impl("auto") == "gather"
    for impl in ("gather", "splat", "matmul"):
        assert resolve_impl(impl) == impl
    assert "pallas" not in MATCHER_IMPLS

    cfg = SlamConfig(num_particles=4).with_overrides(
        {"matcher.impl": "pallas"})
    for make in (resolve_impl, RBPF, SharedMapSLAM):
        arg = "pallas" if make is resolve_impl else cfg
        with _pytest.raises(ValueError, match="gather.*splat.*matmul"):
            make(arg)
