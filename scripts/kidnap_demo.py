"""Mid-run kidnapped robot: AMCL recovery injection at work.

The psweep (scripts/psweep_r5.py) covers the kidnap-at-t=0 problem; this
demo covers the harder mid-run variant: the filter TRACKS confidently,
then the robot is teleported (the odometry stream never sees the jump).
Without recovery the cloud is stranded at the old pose forever — motion
noise cannot bridge a multi-meter jump, and Neff alone cannot even
DETECT the kidnap (all particles become uniformly bad, so Neff rises).
The Augmented-MCL fast/slow weight averages (config.surface_reinject_*)
detect the likelihood collapse and resampling re-injects uniform
particles until the filter re-converges.

Protocol: known map (frozen), surface mode, full-circle theta bins.
Track for K scans from pose A; splice a second log recorded from pose B
(odometry continuous, poses discontinuous); report per-scan error and
injection activity with and without recovery enabled.

Writes docs/bench/kidnap_r5.json.
Usage:  python scripts/kidnap_demo.py --particles 200000     # GPU
        python scripts/kidnap_demo.py --particles 20000 --nt 24  # CPU
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=200_000)
    ap.add_argument("--nt", type=int, default=48)
    ap.add_argument("--beams", type=int, default=180)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="docs/bench/kidnap_r5.json")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from gridmap_slam_tpu import SlamConfig
    from gridmap_slam_tpu.config import MapConfig
    from gridmap_slam_tpu.io import frame_at, frames_to_device
    from gridmap_slam_tpu.io.synthetic import SimParams, simulate_log
    from gridmap_slam_tpu.models.shared import SharedMapSLAM
    from reloc_demo import build_gt_map
    import psweep_r5 as ps

    params = SimParams(beams_per_rev=args.beams)
    w = ps.ROOMS * ps.ROOM + 2.0
    h = ps.ROOM + 3.2
    base = SlamConfig(
        num_particles=args.particles, max_beams=192, freeze_map=True,
        map=MapConfig(width_m=w, height_m=h, resolution=0.05,
                      origin=(-w / 2, -h / 2)),
    ).with_overrides({
        "matcher.surface_nt": args.nt,
        "matcher.surface_theta_span_deg": 180.0,
        "matcher.surface_crop_cells": 0,
        "matcher.surface_corr": "fft",
        "map.likelihood_sigma_cells": 2.0,
        "matcher.surface_refine_steps": 3,
    })

    map_frames, map_gt = ps.build_map_log(params)
    lo = np.asarray(build_gt_map(map_frames, map_gt, base))

    # segment A: creep inside room 2; segment B: room 6 near the landmark
    # (the kidnap target must be globally disambiguable, else recovery can
    # only reach a twin).  Both near-stationary: the odometry stream
    # propagates every particle, so a driving segment would drag even a
    # stranded cloud along.
    world = ps.build_world()
    x0 = -ps.ROOMS * ps.ROOM / 2
    fa, ga = simulate_log(world, [(0.0, 0.0)] + [(0.1, 0.0)] * 11,
                          params=params, seed=args.seed,
                          start_pose=(x0 + 1.5 * ps.ROOM, 0.0, 0.0))
    fb, gb = simulate_log(world, [(0.0, 0.0)] + [(0.05, 0.0)] * 15,
                          params=params, seed=args.seed + 7,
                          start_pose=(x0 + 5.3 * ps.ROOM, 0.6, 0.5))
    frames = fa + fb
    gt = np.concatenate([ga, gb])
    kidnap_at = len(fa)

    def run(reinject: bool):
        cfg = base
        if reinject:
            cfg = cfg.with_overrides({"matcher.surface_reinject_slow": 0.05,
                                      "matcher.surface_reinject_fast": 0.6})
        eng = SharedMapSLAM(cfg)
        # start CONVERGED at segment A's start (tracking, not reloc)
        state = eng.init_from_map(jax.random.key(args.seed + 1),
                                  jnp.asarray(lo), pose=tuple(ga[0]))
        step = jax.jit(eng.step_surface, donate_argnums=(0,))
        batch = frames_to_device(frames, cfg.max_beams,
                                 cfg.sensor.max_range)
        rows = []
        for i in range(len(frames)):
            state, info = step(state, frame_at(batch, i))
            g = gt[i]
            best = np.asarray(info.best_pose)
            rows.append({
                "scan": i,
                "kidnapped": i >= kidnap_at,
                "err_best_m": round(float(np.hypot(best[0] - g[0],
                                                   best[1] - g[1])), 3),
                "neff_frac": round(float(info.neff) / cfg.num_particles, 4),
                "resampled": bool(info.resampled),
                "recov_gap_nats": round(float(state.recov[1]
                                              - state.recov[0]), 3),
            })
        tail = rows[-4:]
        recovered = all(r["err_best_m"] < 0.3 for r in tail)
        return {"reinject": reinject, "recovered": recovered,
                "final_err_best_m": rows[-1]["err_best_m"],
                "per_scan": rows}

    t0 = time.perf_counter()
    no_recovery = run(False)
    with_recovery = run(True)
    out = {
        "what": ("mid-run kidnapped robot (teleport at scan "
                 f"{kidnap_at} of {len(frames)}; odometry never sees the "
                 "jump), frozen known 6-room map, surface mode full "
                 "circle; AMCL fast/slow recovery injection on vs off"),
        "particles": args.particles,
        "kidnap_at_scan": kidnap_at,
        "wall_s": round(time.perf_counter() - t0, 1),
        "without_recovery": no_recovery,
        "with_recovery": with_recovery,
    }
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: (v if not isinstance(v, dict)
                          else {kk: vv for kk, vv in v.items()
                                if kk != "per_scan"})
                      for k, v in out.items()}))


if __name__ == "__main__":
    main()
