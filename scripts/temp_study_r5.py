"""Weight-temperature / resample-gating study for surface mode (round-4
VERDICT #4 and weak #3).

At 1M particles the raw per-scan log-likelihoods (sums over ~180 beams)
spread tens of nats across the sampled cloud, so Neff collapses to ~0.5 %
of P and the Neff < P/2 gate fires EVERY scan — paying the 1M-particle
resample sort each scan.
`matcher.surface_weight_temp` scales the log-scores before normalization;
this study characterizes Neff / ATE / resample rate / throughput against
temperature on (a) the canonical room_loop_40 log and (b) the bench
synthetic log at 1M particles, and the chosen default is recorded in
config.py with this artifact as the evidence.

Writes docs/bench/temp_study_r5.json.

Usage:  python scripts/temp_study_r5.py            # GPU, full study
        python scripts/temp_study_r5.py --smoke    # CPU-sized
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def run_case(frames, gt, particles, temp, map_size, beams_max,
             resample_fraction=0.5, refine_steps=0):
    import jax
    import jax.numpy as jnp

    from gridmap_slam_tpu import SlamConfig
    from gridmap_slam_tpu.config import MapConfig
    from gridmap_slam_tpu.io import frames_to_device
    from gridmap_slam_tpu.models.shared import SharedMapSLAM
    from gridmap_slam_tpu.utils.metrics import ate_rmse

    cfg = SlamConfig(
        num_particles=particles, max_beams=beams_max,
        resample_fraction=resample_fraction,
        map=MapConfig(width_m=map_size, height_m=map_size, resolution=0.05,
                      origin=(-map_size / 2, -map_size / 2)),
    ).with_overrides({"matcher.surface_weight_temp": temp,
                      "matcher.surface_refine_steps": refine_steps,
                      # surface mode gates on its own knob since round 5
                      # (config.surface_resample_fraction); keep this
                      # study's resample_fraction meaning what it always
                      # measured
                      "matcher.surface_resample_fraction":
                          resample_fraction})
    eng = SharedMapSLAM(cfg)
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range)
    replay = eng.replay_surface_jit()
    n = len(frames)

    state, infos = replay(eng.init(jax.random.key(0)), batch)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    state2, infos = replay(eng.init(jax.random.key(1)), batch)
    jax.block_until_ready(state2)
    wall = time.perf_counter() - t0

    neffs = np.asarray(infos.neff)
    traj = np.asarray(infos.weighted_pose)
    return {
        "temp": temp,
        "refine_steps": refine_steps,
        "particles": particles,
        "resample_fraction": resample_fraction,
        "n_scans": n,
        "ate_m": round(float(ate_rmse(traj, gt[:n])), 4),
        "neff_frac_mean": round(float(neffs.mean()) / particles, 5),
        "neff_frac_final": round(float(neffs[-1]) / particles, 5),
        "resample_count": int(np.asarray(infos.resampled).sum()),
        "ms_per_scan_wall": round(1e3 * wall / n, 2),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default="docs/bench/temp_study_r5.json")
    args = ap.parse_args()

    from gridmap_slam_tpu.io import read_recording
    from gridmap_slam_tpu.io.synthetic import (SimParams, default_world,
                                               simulate_log,
                                               square_path_controls)

    temps = [1.0, 0.3, 0.1, 0.075, 0.03, 0.01]
    big_p = 20_000 if args.smoke else 1_000_000
    mid_p = 2_000 if args.smoke else 100_000

    # (a) canonical log, mid particle count
    frames_c = read_recording("maps/room_loop_40.rec")
    gt_c = np.load("maps/room_loop_40_gt.npy")
    # (b) the bench ladder's synthetic log at the mega rung's particle count
    frames_b, gt_b = simulate_log(default_world(), square_path_controls(12),
                                  params=SimParams(beams_per_rev=180),
                                  seed=0)

    results = {"canonical_room_loop_40": [], "bench_synthetic_12": []}
    for temp in temps:
        r = run_case(frames_c, gt_c, mid_p, temp, 6.0, 192)
        results["canonical_room_loop_40"].append(r)
        print(json.dumps(r), flush=True)
    for temp in temps:
        r = run_case(frames_b, gt_b, big_p, temp, 6.0, 192)
        results["bench_synthetic_12"].append(r)
        print(json.dumps(r), flush=True)

    out = {
        "what": ("surface_weight_temp sweep: Neff fraction / ATE / "
                 "resample rate / wall per scan; resample gate fires when "
                 "neff < resample_fraction * P (0.5 default)"),
        "note": ("wall ms/scan includes the per-replay dispatch cost and "
                 "is comparable WITHIN this file only"),
        "results": results,
    }
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
