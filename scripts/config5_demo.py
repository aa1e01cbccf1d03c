"""BASELINE config 5 demo: multi-robot shared-map SLAM + cross-robot loop
closure + distributed BA, sharded over the (virtual) device mesh.

Two robots start in different rooms of a multi-room world and both traverse
the shared middle area.  The pipeline:

  1. per-robot synthetic logs (reference recording semantics, skewed scans,
     encoder-noise odometry) from different start poses;
  2. MultiRobotSLAM (models/multi.py): each robot's particle belief matches
     against the ONE shared grid; per-robot map deltas sum (log-odds adds
     commute); the (R, P) particle axes are GSPMD-sharded over the mesh's
     'p' axis;
  3. both robots' trajectories feed one pose-graph frontend; closure
     detection runs over the COMBINED keyframe set, so spatially-near,
     temporally-far pairs include CROSS-ROBOT matches (the inter-robot
     alignment constraint of a multi-robot system);
  4. the joint graph (per-robot odometry chains, seam edge dropped via
     optimize(chain_breaks=...)) is optimized by the mesh-distributed BA
     (parallel/ba.py: edge-sharded, psum-reduced normal equations).

On real hardware the same code spans hosts via parallel/dcn.initialize
(tests/test_dcn.py exercises the 2-process path); this script runs on the
8-virtual-device CPU mesh and writes docs/config5_demo.json + a map PNG.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from gridmap_slam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402


def run(num_revs: int = 20, particles: int = 32, out_json=None,
        out_png=None):
    from gridmap_slam_tpu.config import MapConfig, SensorConfig, SlamConfig
    from gridmap_slam_tpu.io import frames_to_device
    from gridmap_slam_tpu.io.synthetic import (SimParams, multi_room_world,
                                               simulate_log)
    from gridmap_slam_tpu.models.frontend import FrontendConfig, PoseGraphSLAM
    from gridmap_slam_tpu.models.multi import MultiRobotSLAM
    from gridmap_slam_tpu.ops.geometry import deskew_scan
    from gridmap_slam_tpu.parallel.ba import make_distributed_optimizer
    from gridmap_slam_tpu.parallel.mesh import make_mesh
    from gridmap_slam_tpu.utils.metrics import ate_rmse

    world = multi_room_world(rooms_x=2, rooms_y=1, room=6.0, door=1.4)
    cfg = SlamConfig(
        num_particles=particles, max_beams=96,
        sensor=SensorConfig(max_range=8.0),
        map=MapConfig(width_m=14.0, height_m=8.0, resolution=0.1,
                      origin=(-7.0, -4.0)),
    )
    # noisier encoders than default so per-robot dead reckoning drifts
    # visibly over the run — the error BA must fix
    params = SimParams(beams_per_rev=90, encoder_noise_sd=6.0)
    # straight runs through the connecting door in opposite directions —
    # the corridors overlap, so cross-robot closures are geometrically
    # available around the middle
    starts = [(-5.2, -0.3, 0.0), (5.2, 0.3, np.pi)]
    controls = [(0.25, 0.0)] * num_revs
    logs = [simulate_log(world, controls, params=params, seed=11 + i,
                         start_pose=starts[i])
            for i in range(2)]
    frames_r = [frames_to_device(f, cfg.max_beams, cfg.sensor.max_range)
                for f, _ in logs]
    gts = [gt for _, gt in logs]
    batch = jax.tree.map(lambda a, b: jnp.stack([a, b], axis=1),
                         frames_r[0], frames_r[1])       # (T, R, ...)

    # ---- sharded multi-robot filtering ----
    eng = MultiRobotSLAM(cfg, num_robots=2)
    mesh = make_mesh(8, map_shards=1)
    shard = lambda spec: NamedSharding(mesh, spec)
    state = eng.init(jax.random.key(0), poses=starts)
    state = state.replace(
        poses=jax.device_put(state.poses, shard(P(None, "p", None))),
        log_weights=jax.device_put(state.log_weights, shard(P(None, "p"))),
        logodds=jax.device_put(state.logodds, shard(P())))
    replay = jax.jit(eng.replay)
    state, infos = replay(state, batch)
    traj = np.asarray(infos.weighted_pose)               # (T, R, 3)

    ates = [ate_rmse(traj[:, i], gts[i]) for i in range(2)]

    # ---- joint pose graph with cross-robot closures ----
    # The graph is fed each robot's DEAD-RECKONED chain (odometry
    # integration only — drifts with encoder noise); alignment information
    # comes purely from scan-matched closures, including cross-robot ones.
    # This is the BA story: the filter above shows shared-map filtering,
    # this stage shows joint trajectory optimization fixing drift.
    from gridmap_slam_tpu.ops.motion import apply_odometry
    t_count = traj.shape[0]
    dr = np.zeros((t_count, 2, 3), np.float64)
    for i in range(2):
        pose = np.asarray(starts[i], np.float64)
        for t in range(t_count):
            f = jax.tree.map(lambda a: a[t, i], batch)
            pose = np.asarray(apply_odometry(jnp.asarray(pose, jnp.float32),
                                             f.odom), np.float64)
            dr[t, i] = pose
    dr_ates = [ate_rmse(dr[:, i], gts[i]) for i in range(2)]

    fe = PoseGraphSLAM(cfg, FrontendConfig(
        keyframe_dist=0.0, closure_min_gap=4, closure_max_dist=1.6))
    for i in range(2):
        for t in range(t_count):
            f = jax.tree.map(lambda a: a[t, i], batch)
            fe.add(dr[t, i], deskew_scan(f.scan, f.odom))
    n_closures = fe.detect_closures()
    cross = sum(1 for a, b, _, _ in fe.closures
                if (a < t_count) != (b < t_count))

    # distributed BA over the mesh (edge-sharded, psum-reduced)
    import dataclasses
    from gridmap_slam_tpu.models import posegraph as PG
    poses_kf = np.asarray(fe.kf_poses, np.float32)
    ei, ej, ez, ew = PG.odometry_edges(poses_kf, fe.cfg.odom_w_xy,
                                       fe.cfg.odom_w_t)
    keep = np.asarray(ei) != (t_count - 1)               # drop the seam edge
    ei, ej, ez, ew = ei[keep], ej[keep], ez[keep], ew[keep]
    if fe.closures:
        ci = np.asarray([c[0] for c in fe.closures], np.int32)
        cj = np.asarray([c[1] for c in fe.closures], np.int32)
        cz = np.asarray([c[2] for c in fe.closures], np.float32)
        cw = np.tile(np.asarray([fe.cfg.closure_w_xy, fe.cfg.closure_w_xy,
                                 fe.cfg.closure_w_t], np.float32),
                     (len(fe.closures), 1))
        ei = np.concatenate([ei, ci]); ej = np.concatenate([ej, cj])
        ez = np.concatenate([ez, cz]); ew = np.concatenate([ew, cw])
    # pad the edge set to a multiple of the mesh's 'p' size with
    # zero-weight self-edges (contribute nothing to the normal equations)
    n_shards = mesh.shape["p"]
    padn = (-len(ei)) % n_shards
    if padn:
        ei = np.concatenate([ei, np.zeros(padn, np.int32)])
        ej = np.concatenate([ej, np.zeros(padn, np.int32)])
        ez = np.concatenate([ez, np.zeros((padn, 3), np.float32)])
        ew = np.concatenate([ew, np.zeros((padn, 3), np.float32)])
    graph = PG.PoseGraph(nodes=jnp.asarray(poses_kf),
                         edge_i=jnp.asarray(ei), edge_j=jnp.asarray(ej),
                         edge_z=jnp.asarray(ez), edge_w=jnp.asarray(ew))
    opt = make_distributed_optimizer(mesh, iterations=8, damping=1e-3)
    graph2, chi2 = opt(graph)
    chi2 = np.asarray(chi2)
    opt_nodes = np.asarray(graph2.nodes)
    opt_ates = [ate_rmse(opt_nodes[i * t_count:(i + 1) * t_count], gts[i])
                for i in range(2)]

    result = {
        "robots": 2, "revs_per_robot": t_count, "particles": particles,
        "mesh": dict(mesh.shape),
        "online_ate_m": [round(a, 4) for a in ates],
        "dead_reckoning_ate_m": [round(a, 4) for a in dr_ates],
        "closures_total": int(n_closures),
        "closures_cross_robot": int(cross),
        "chi2_first": float(chi2[0]), "chi2_last": float(chi2[-1]),
        "optimized_ate_m": [round(a, 4) for a in opt_ates],
    }
    if out_json:
        with open(out_json, "w") as fh:
            json.dump(result, fh, indent=2)
    if out_png:
        from gridmap_slam_tpu.utils.viz import render_map
        render_map(np.asarray(state.logodds), out_png,
                   trajectory=traj[:, 0], ground_truth=gts[0],
                   origin=cfg.map.origin, resolution=cfg.map.resolution,
                   title=f"config5: 2 robots, {n_closures} closures "
                         f"({cross} cross-robot)")
    return result


if __name__ == "__main__":
    res = run(out_json="docs/config5_demo.json",
              out_png="docs/config5_demo.png")
    print(json.dumps(res, indent=2))
