"""Shared-map SLAM mode tests."""

import numpy as np
import jax
import pytest

from gridmap_slam_tpu.config import MapConfig, SlamConfig
from gridmap_slam_tpu.models.shared import SharedMapSLAM
from gridmap_slam_tpu.io import frames_to_device, frame_at
from gridmap_slam_tpu.io.synthetic import (SimParams, default_world,
                                           simulate_log,
                                           square_path_controls)
from gridmap_slam_tpu.utils.metrics import ate_rmse


@pytest.fixture(scope="module")
def log():
    params = SimParams(beams_per_rev=90)
    return simulate_log(default_world(), square_path_controls(8),
                        params=params, seed=5)


def test_shared_map_replay(log):
    frames, gt = log
    cfg = SlamConfig(num_particles=64, max_beams=96, particle_chunk=32)
    eng = SharedMapSLAM(cfg)
    state = eng.init(jax.random.key(0))
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range)
    step = jax.jit(eng.step)
    traj = []
    for i in range(len(frames)):
        state, info = step(state, frame_at(batch, i))
        traj.append(np.asarray(info.weighted_pose))
    traj = np.stack(traj)
    assert np.isfinite(traj).all()
    ate = ate_rmse(traj, gt)
    assert ate < 0.3, ate
    m = np.asarray(state.logodds)
    assert m.shape == (120, 120)
    assert (m > 0).sum() > 50 and (m < 0).sum() > 1000


def test_shared_map_replay_scan(log):
    """lax.scan replay compiles and matches the python loop."""
    frames, gt = log
    cfg = SlamConfig(num_particles=16, max_beams=96)
    eng = SharedMapSLAM(cfg)
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range)

    s1 = eng.init(jax.random.key(3))
    step = jax.jit(eng.step)
    for i in range(len(frames)):
        s1, _ = step(s1, frame_at(batch, i))

    s2, infos = eng.replay_jit()(eng.init(jax.random.key(3)), batch)
    np.testing.assert_allclose(np.asarray(s1.poses), np.asarray(s2.poses),
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(s1.logodds),
                                  np.asarray(s2.logodds))


def test_shared_map_memory_independent_of_particles():
    """State size scales with P only through poses/weights."""
    c1 = SlamConfig(num_particles=10)
    c2 = SlamConfig(num_particles=1000)
    s1 = SharedMapSLAM(c1).init(jax.random.key(0))
    s2 = SharedMapSLAM(c2).init(jax.random.key(0))
    assert s1.logodds.shape == s2.logodds.shape == (120, 120)
    assert s2.poses.shape == (1000, 3)


def test_amcl_recovery_injection_detects_kidnap():
    """Mid-run kidnap: the AMCL fast/slow weight EMAs must detect the
    likelihood collapse (Neff cannot — uniformly-bad particles RAISE it)
    and resampling must re-inject uniform particles; without the feature
    the cloud stays stranded at the old pose."""
    import jax
    import jax.numpy as jnp
    from gridmap_slam_tpu import SlamConfig
    from gridmap_slam_tpu.config import MapConfig, SensorConfig
    from gridmap_slam_tpu.io import frame_at, frames_to_device
    from gridmap_slam_tpu.io.synthetic import (SimParams, multi_room_world,
                                               simulate_log)
    from gridmap_slam_tpu.models.shared import SharedMapSLAM
    from gridmap_slam_tpu.ops.raycast import build_beam_lut, integrate_scan
    from gridmap_slam_tpu.ops.geometry import deskew_scan

    params = SimParams(beams_per_rev=90)
    world = multi_room_world(2, 1, room=6.0)
    base = SlamConfig(
        num_particles=3000, max_beams=96, freeze_map=True,
        sensor=SensorConfig(max_range=5.0),
        map=MapConfig(width_m=14.0, height_m=8.0, resolution=0.1,
                      origin=(-7.0, -4.0)),
    ).with_overrides({"matcher.surface_nt": 16,
                      "matcher.surface_theta_span_deg": 180.0,
                      "matcher.surface_corr": "fft",
                      "map.likelihood_sigma_cells": 2.0,
                      "matcher.surface_refine_steps": 2})

    # known map from a coverage pass at GT poses.  Segment A must STAY in
    # room 1 (the first test draft drove it into room 2 and the "kidnap"
    # was a 0.5 m hop): slow creep, 6 revolutions.
    fa, ga = simulate_log(world, [(0.1, 0.0)] * 6, params=params, seed=0,
                          start_pose=(-3.0, 0.0, 0.0))
    fm, gm = simulate_log(world, [(0.5, 0.0)] * 20, params=params, seed=1,
                          start_pose=(-6.0, 0.0, 0.0))
    lo = jnp.zeros((base.map.cells_y, base.map.cells_x), jnp.float32)
    batch_m = frames_to_device(fm, base.max_beams, base.sensor.max_range)

    @jax.jit
    def add(lo, frame, pose):
        scan = deskew_scan(frame.scan, frame.odom)
        lut = build_beam_lut(scan, base.beam_lut_bins)
        return lo + integrate_scan(
            lo, pose, scan, lut, resolution=0.1, origin=(-7.0, -4.0),
            l_free=base.sensor.l_free, l_occ=base.sensor.l_occ,
            tol_cells=base.sensor.hit_tolerance_cells)
    for i in range(len(fm)):
        lo = add(lo, frame_at(batch_m, i), jnp.asarray(gm[i], jnp.float32))

    # segment B from the OTHER room = the kidnap.  Near-stationary: the
    # odometry stream propagates EVERY particle with the robot's motion,
    # so a driving B would carry even a stranded cloud across rooms and
    # make the room histogram meaningless.
    fb, gb = simulate_log(world, [(0.05, 0.0)] * 10, params=params, seed=2,
                          start_pose=(3.2, 0.5, 0.4))
    frames = fa + fb

    def run(reinject):
        cfg = base
        if reinject:
            cfg = cfg.with_overrides(
                {"matcher.surface_reinject_slow": 0.05,
                 "matcher.surface_reinject_fast": 0.6})
        eng = SharedMapSLAM(cfg)
        state = eng.init_from_map(jax.random.key(5), lo,
                                  pose=tuple(ga[0]))
        step = jax.jit(eng.step_surface)
        batch = frames_to_device(frames, cfg.max_beams,
                                 cfg.sensor.max_range)
        gaps = []
        for i in range(len(frames)):
            state, info = step(state, frame_at(batch, i))
            gaps.append(float(state.recov[1] - state.recov[0]))
        x = np.asarray(state.poses[:, 0])
        return state, gaps, x

    s0, gaps0, x0 = run(False)
    s1, gaps1, x1 = run(True)
    # detection: post-kidnap the fast EMA collapses below the slow one
    assert min(gaps1[len(fa):]) < -1.0, gaps1
    # without recovery, the cloud never reaches the true room (x > 0)
    assert (x0 > 0.5).mean() < 0.05, (x0 > 0.5).mean()
    # with recovery, a substantial particle mass reaches the true room
    assert (x1 > 0.5).mean() > 0.2, (x1 > 0.5).mean()
