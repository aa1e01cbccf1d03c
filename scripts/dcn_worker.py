"""Worker process for the 2-process jax.distributed (DCN) smoke test.

Each process owns 4 virtual CPU devices; jax.distributed.initialize stitches
them into one 8-device world, parallel/dcn.make_multihost_mesh lays hosts on
the particle axis, and the explicit-collective shard_map step runs with
cross-process collectives (the DCN path of SURVEY.md §2.10).

Usage: python scripts/dcn_worker.py <pid> <nproc> <port> [particles beams reps]
Prints one line: DCN_OK pid=<i> neff=<...> wp=<x,y,t>
With the optional timing args it also times `reps` steps of the tiled
cross-process step at the given workload and prints
DCN_TIME pid=<i> ms_per_scan=<x> — the DCN-path cost row for
scripts/scaling_table.py (round-2 VERDICT weak #6/#8).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4").strip()


def main():
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    port = int(sys.argv[3])

    import jax
    jax.config.update("jax_platforms", "cpu")

    from gridmap_slam_tpu.parallel import dcn
    dcn.initialize(coordinator=f"127.0.0.1:{port}", num_processes=nproc,
                   process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == 4 * nproc, len(jax.devices())

    mesh = dcn.make_multihost_mesh(map_shards=2)
    assert dict(mesh.shape) == {"p": 2 * nproc, "m": 2}

    import numpy as np
    from gridmap_slam_tpu.config import MapConfig, SlamConfig
    from gridmap_slam_tpu.io import frame_at, frames_to_device
    from gridmap_slam_tpu.io.synthetic import (SimParams, default_world,
                                               simulate_log,
                                               square_path_controls)
    from gridmap_slam_tpu.models.shared import SharedMapSLAM
    from gridmap_slam_tpu.parallel.tiled import init_tiled, make_tiled_step

    cfg = SlamConfig(num_particles=16, max_beams=64,
                     map=MapConfig(width_m=3.2, height_m=3.2,
                                   resolution=0.05, origin=(-1.6, -1.6)))
    eng = SharedMapSLAM(cfg)
    frames, _ = simulate_log(default_world(), square_path_controls(3),
                             params=SimParams(beams_per_rev=60), seed=2)
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range)

    state = init_tiled(eng, jax.random.key(0), mesh)
    step = make_tiled_step(eng, mesh)
    for i in range(2):
        state, info = step(state, frame_at(batch, i))
    jax.block_until_ready(state)

    # Replicated outputs must agree across processes (printed for the parent
    # to compare).
    neff = float(jax.device_get(info.neff))
    wp = np.asarray(jax.device_get(info.weighted_pose))
    print(f"DCN_OK pid={pid} neff={neff:.6f} "
          f"wp={wp[0]:.6f},{wp[1]:.6f},{wp[2]:.6f}", flush=True)

    if len(sys.argv) > 6:
        # Timing mode: per-scan wall of the tiled step at the requested
        # workload with cross-process collectives on the wire.
        import time
        particles, beams, reps = (int(sys.argv[4]), int(sys.argv[5]),
                                  int(sys.argv[6]))
        cfg = SlamConfig(num_particles=particles, max_beams=beams,
                         map=MapConfig(width_m=6.4, height_m=6.4,
                                       resolution=0.05, origin=(-3.2, -3.2)))
        if len(sys.argv) > 7 and sys.argv[7]:
            # decomposition variants (scripts/scaling_table.py): dotted
            # comma-separated overrides, e.g. "resample_fraction=0.0"
            cfg = cfg.with_overrides(SlamConfig.parse_overrides(
                sys.argv[7].split(",")))
        eng = SharedMapSLAM(cfg)
        frames, _ = simulate_log(default_world(), square_path_controls(3),
                                 params=SimParams(beams_per_rev=beams),
                                 seed=1)
        batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range)
        frame = frame_at(batch, 1)
        state = init_tiled(eng, jax.random.key(0), mesh)
        step = make_tiled_step(eng, mesh)
        state, _ = step(state, frame)          # compile + warm
        jax.block_until_ready(state)
        t0 = time.perf_counter()
        for _ in range(reps):
            state, _ = step(state, frame)
        jax.block_until_ready(state)
        ms = 1e3 * (time.perf_counter() - t0) / reps
        print(f"DCN_TIME pid={pid} ms_per_scan={ms:.2f}", flush=True)


if __name__ == "__main__":
    main()
