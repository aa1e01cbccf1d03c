"""Global relocalization (kidnapped robot) on a known map — surface mode.

The capability that justifies huge particle counts (round-3 VERDICT): a
uniform-over-the-map cloud with full-circle theta bins must converge to the
true pose.  CPU-sized here (scripts/reloc_demo.py runs it at 1M
particles).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np

from gridmap_slam_tpu import SlamConfig
from gridmap_slam_tpu.config import MapConfig
from gridmap_slam_tpu.io import frame_at, frames_to_device
from gridmap_slam_tpu.io.synthetic import (SimParams, box, multi_room_world,
                                           simulate_log,
                                           square_path_controls)
from gridmap_slam_tpu.models.shared import SharedMapSLAM
from gridmap_slam_tpu.ops.geometry import deskew_scan, wrap_angle
from gridmap_slam_tpu.ops.raycast import build_beam_lut, integrate_scan


def _world(r=5.0):
    return np.concatenate([
        multi_room_world(2, 2, room=r),
        np.asarray(box(-r * 0.8, -r * 0.75, -r * 0.45, -r * 0.55)),
        np.asarray(box(r * 0.25, -r * 0.2, r * 0.4, r * 0.3)),
        np.asarray(box(-r * 0.3, r * 0.55, r * 0.1, r * 0.7)),
    ])


def test_kidnapped_robot_converges():
    # the validated envelope (scripts/reloc_demo.py CPU run): 2x2 rooms of
    # 6 m, 50k particles, 72 full-circle bins, 2 refine steps, 10 scans
    r = 6.0
    extent = 2 * r + 2.0
    cfg = SlamConfig(
        num_particles=50_000, max_beams=192, freeze_map=True,
        map=MapConfig(width_m=extent, height_m=extent, resolution=0.05,
                      origin=(-extent / 2, -extent / 2)),
    ).with_overrides({
        "matcher.surface_nt": 72,
        "matcher.surface_theta_span_deg": 180.0,
        "matcher.surface_crop_cells": 0,
        "matcher.surface_corr": "fft",
        "matcher.surface_refine_steps": 2,
    })
    frames, gt = simulate_log(
        _world(r), square_path_controls(10, v=0.2, side_revs=6),
        params=SimParams(beams_per_rev=180), seed=0,
        start_pose=(-r / 2, -r / 2, 0.3))
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range)

    res = float(cfg.map.resolution)
    origin = (float(cfg.map.origin[0]), float(cfg.map.origin[1]))

    @jax.jit
    def add(lo, frame, pose):
        scan = deskew_scan(frame.scan, frame.odom)
        lut = build_beam_lut(scan, cfg.beam_lut_bins)
        return lo + integrate_scan(
            lo, pose, scan, lut, resolution=res, origin=origin,
            l_free=cfg.sensor.l_free, l_occ=cfg.sensor.l_occ,
            tol_cells=cfg.sensor.hit_tolerance_cells)

    lo = jnp.zeros((cfg.map.cells_y, cfg.map.cells_x), jnp.float32)
    for i in range(len(frames)):
        lo = add(lo, frame_at(batch, i), jnp.asarray(gt[i], jnp.float32))

    lo_np = np.asarray(lo)      # snapshot BEFORE donation eats the buffer
    eng = SharedMapSLAM(cfg)
    state = eng.init_uniform(jax.random.key(1), lo)
    # uniform cloud actually spans the map
    assert float(jnp.std(state.poses[:, 0])) > 0.2 * extent
    step = jax.jit(eng.step_surface, donate_argnums=(0,))
    for i in range(len(frames)):
        state, info = step(state, frame_at(batch, i))

    g = gt[-1]
    best = np.asarray(info.best_pose)
    err = math.hypot(best[0] - g[0], best[1] - g[1])
    err_th = abs(float(wrap_angle(jnp.asarray(best[2] - g[2]))))
    assert err < 0.15, (err, best, g)
    assert err_th < 0.2, err_th
    # the map was frozen: still the ground-truth map bit-for-bit
    np.testing.assert_array_equal(np.asarray(state.logodds), lo_np)
