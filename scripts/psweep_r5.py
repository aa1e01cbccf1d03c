"""Does particle count MATTER?  The ambiguity P-sweep (round-4 VERDICT #2).

The headline metric is scans/s/chip at 1M particles, but round 4 never
showed a task where 1M particles beat 10k: the reloc demo's world was
discriminative enough that it converged at scan 0.  This study builds a
world where small filters FAIL:

- six IDENTICAL 10 m rooms in a row (multi_room_world(6, 1)) plus ONE
  1 x 0.6 m landmark deep in the east end room: interior rooms 2-5 are
  translationally identical and the row without the landmark is globally
  180-degree symmetric, so the posterior must hold up to ~8 modes.  The
  landmark is the only global symmetry breaker and only becomes visible
  when the robot reaches the end room (~scan 22 of 39);
- the robot is KIDNAPPED at t=0 (uniform init over the full 62 x 13.2 m
  map x full circle, frozen known map) in room 4, drives east along the
  door line, and settles in room 6;
- success requires particles near the TRUE mode to SURVIVE every
  resampling of the 20-scan ambiguous phase; uniform init seeds any one
  mode basin with ~P * 1e-6 particles, so the survival probability — and
  the measured success rate — rises steeply with P.

Found by this study and now load-bearing (config.py): with the
reference's sharp ~1-cell likelihood field, surface scores at headings
between theta bins are bin-alignment luck (endpoint displacement
range*dtheta/2 >> sigma) and mode masses random-walk regardless of P —
global relocalization needs a wider field
(MapConfig.likelihood_sigma_cells, classic MCL practice) plus per-mode
hill-climb refinement.

Sweep P in {10k, 100k, 1M} x seeds; report per-scan best/mean error,
Neff, per-room particle mass (the multimodality evidence), and
scans-to-converge.  Writes docs/bench/psweep_r5.json.
Round-5 result (5 seeds): success 10k 20% / 100k 80% / 1M 100%.

Usage:  python scripts/psweep_r5.py                 # GPU, full sweep
        python scripts/psweep_r5.py --smoke         # CPU-sized
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

ROOM = 10.0          # room side (m); bigger rooms = more area per mode
ROOMS = 6


def build_world():
    """Six identical rooms in a row PLUS one asymmetric landmark in the
    east end room.  Without it the row is globally 180-degree symmetric
    (the west-driving twin of the true trajectory sees IDENTICAL scans
    forever), so convergence to the true mode was a coin flip — measured
    in the first sweep: failures all landed exactly at the rotated twin,
    31.4 m away.  The landmark is deep in room 6, so it only becomes
    visible near the end of the run: the translational + rotational
    ambiguity persists through most of the log by design, and success
    hinges on the TRUE mode's particles surviving every resampling of
    the ambiguous phase — the P-dependent event this benchmark sweeps."""
    import numpy as np
    from gridmap_slam_tpu.io.synthetic import box, multi_room_world
    world = multi_room_world(ROOMS, 1, room=ROOM)
    x0 = -ROOMS * ROOM / 2
    # a 1 x 0.6 m block in room 6's north half
    lx = x0 + 5.4 * ROOM
    ly = 0.3 * ROOM
    return np.concatenate([
        world, np.asarray(box(lx, ly, lx + 1.0, ly + 0.6))])


def build_map_log(params, seed=0):
    """Coverage pass for the known map: drive the whole row west->east
    along the door line, scanning every room."""
    from gridmap_slam_tpu.io.synthetic import simulate_log
    world = build_world()
    span = ROOMS * ROOM
    n = int(span / (0.6 * params.rev_time)) + 4
    controls = [(0.6, 0.0)] * n
    return simulate_log(world, controls, params=params, seed=seed,
                        start_pose=(-span / 2 + 1.0, 0.0, 0.0))


def build_test_log(params, seed):
    """The kidnapped run: wake up mid-room-4 (interior rooms 2-5 are the
    identical ambiguous set), sit one rev, then drive east to the end
    room where the landmark disambiguates."""
    from gridmap_slam_tpu.io.synthetic import simulate_log
    world = build_world()
    start_x = -ROOMS * ROOM / 2 + 3.5 * ROOM      # room-4 center
    drive = ROOMS * ROOM / 2 - 0.5 * ROOM - start_x   # to room-6 center
    n = int(drive / (0.4 * params.rev_time)) + 2
    # 8 settle revolutions at the end: after the landmark disambiguates
    # (~scan 22) the gated resampling needs a few more scans to drain the
    # residual wrong-mode mass out of the posterior mean
    controls = [(0.0, 0.0)] * 2 + [(0.4, 0.0)] * n + [(0.0, 0.0)] * 8
    return simulate_log(world, controls, params=params, seed=seed,
                        start_pose=(start_x, 0.0, 0.0))


def room_masses(poses_x):
    x0 = -ROOMS * ROOM / 2
    edges = x0 + ROOM * np.arange(ROOMS + 1)
    hist, _ = np.histogram(poses_x, bins=edges)
    return (hist / max(len(poses_x), 1)).round(4).tolist()


def run_one(cfg_base, lo, frames, gt, particles, seed, nt, temp,
            sigma_cells=2.0):
    import jax
    import jax.numpy as jnp
    from gridmap_slam_tpu.io import frame_at, frames_to_device
    from gridmap_slam_tpu.models.shared import SharedMapSLAM
    from gridmap_slam_tpu.ops.geometry import wrap_angle

    cfg = cfg_base.replace(num_particles=particles).with_overrides({
        "matcher.surface_nt": nt,
        "matcher.surface_theta_span_deg": 180.0,
        "matcher.surface_crop_cells": 0,
        "matcher.surface_corr": "fft",
        # Relocalization field/search settings (the round-5 finding this
        # sweep produced, see config.MapConfig.likelihood_sigma_cells):
        # a WIDER field (0.2 m) makes surface scores tolerant of the
        # theta-bin granularity (endpoint displacement range*dtheta/2 at
        # nt=48 is ~0.2 m at typical ranges) and refine steps walk every
        # particle to its mode's local optimum so mode mass flows by
        # mode identity, not bin-alignment luck.
        "map.likelihood_sigma_cells": sigma_cells,
        "matcher.surface_refine_steps": 3,
        "matcher.surface_weight_temp": temp,
    })
    eng = SharedMapSLAM(cfg)
    state = eng.init_uniform(jax.random.key(seed * 1000 + 17), jnp.asarray(lo))
    step = jax.jit(eng.step_surface, donate_argnums=(0,))
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range)

    rows = []
    t0 = time.perf_counter()
    for i in range(len(frames)):
        state, info = step(state, frame_at(batch, i))
        g = gt[i]
        best = np.asarray(info.best_pose)
        wmean = np.asarray(info.weighted_pose)
        import jax.numpy as _jnp
        rows.append({
            "scan": i,
            "neff_frac": round(float(info.neff) / particles, 6),
            "err_best_m": round(float(np.hypot(best[0] - g[0],
                                               best[1] - g[1])), 3),
            "err_mean_m": round(float(np.hypot(wmean[0] - g[0],
                                               wmean[1] - g[1])), 3),
            "err_best_theta": round(float(abs(wrap_angle(
                _jnp.asarray(best[2] - g[2])))), 3),
            "room_mass": room_masses(np.asarray(state.poses[:, 0])),
            "resampled": bool(info.resampled),
        })
    wall = time.perf_counter() - t0

    thresh = 0.3
    conv = None
    for i in range(len(rows)):
        if all(r["err_best_m"] < thresh and r["err_best_theta"] < 0.2
               for r in rows[i:]):
            conv = i
            break
    n_modes_early = sum(1 for m in rows[min(3, len(rows) - 1)]["room_mass"]
                        if m > 0.05)
    return {
        "particles": particles, "seed": seed,
        "surface_weight_temp": temp, "theta_bins": nt,
        "n_scans": len(frames),
        "success": bool(rows[-1]["err_best_m"] < thresh
                        and rows[-1]["err_best_theta"] < 0.2),
        # best-particle lock can coexist with residual wrong-mode mass;
        # posterior_converged demands the weighted mean agree too
        "posterior_converged": bool(rows[-1]["err_mean_m"] < 1.0),
        "converged_at_scan": conv,
        "final_err_best_m": rows[-1]["err_best_m"],
        "final_err_mean_m": rows[-1]["err_mean_m"],
        "rooms_with_mass_scan3": n_modes_early,
        "wall_s": round(wall, 1),
        "per_scan": rows,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--nt", type=int, default=96)
    ap.add_argument("--sigma-cells", type=float, default=2.0,
                    help="likelihood-field blur width override (cells)")
    ap.add_argument("--temp", type=float, default=None,
                    help="surface_weight_temp (default: config default)")
    ap.add_argument("--pset", default=None,
                    help="comma-separated particle counts")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--out", default="docs/bench/psweep_r5.json")
    args = ap.parse_args()

    from gridmap_slam_tpu import SlamConfig
    from gridmap_slam_tpu.config import MapConfig
    from gridmap_slam_tpu.io.synthetic import SimParams
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from reloc_demo import build_gt_map  # noqa: E402

    params = SimParams(beams_per_rev=180)
    w = ROOMS * ROOM + 2.0
    h = ROOM + 3.2
    cfg_base = SlamConfig(
        num_particles=1000, max_beams=192, freeze_map=True,
        map=MapConfig(width_m=w, height_m=h, resolution=0.05,
                      origin=(-w / 2, -h / 2)))
    if args.temp is not None:
        cfg_base = cfg_base.with_overrides(
            {"matcher.surface_weight_temp": args.temp})
    temp = cfg_base.matcher.surface_weight_temp

    map_frames, map_gt = build_map_log(params)
    lo = np.asarray(build_gt_map(map_frames, map_gt, cfg_base))
    print(f"map {lo.shape}, occupied {int((lo > 1.0).sum())}",
          file=sys.stderr, flush=True)

    pset = ([2_000, 20_000] if args.smoke else [10_000, 100_000, 1_000_000])
    if args.pset:
        pset = [int(x) for x in args.pset.split(",")]
    nt = 8 if args.smoke else args.nt
    seeds = range(args.seeds)

    runs = []
    for particles in pset:
        for seed in seeds:
            frames, gt = build_test_log(params, seed=100 + seed)
            r = run_one(cfg_base, lo, frames, gt, particles, seed, nt,
                        temp, sigma_cells=args.sigma_cells)
            runs.append(r)
            print(json.dumps({k: v for k, v in r.items()
                              if k != "per_scan"}), flush=True)

    by_p = {}
    for r in runs:
        by_p.setdefault(r["particles"], []).append(r)
    summary = [{
        "particles": p,
        "success_rate": round(np.mean([r["success"] for r in rs]), 3),
        "posterior_converged_rate": round(np.mean(
            [r["posterior_converged"] for r in rs]), 3),
        "mean_converged_at": (None if not any(
            r["converged_at_scan"] is not None for r in rs)
            else round(float(np.mean([r["converged_at_scan"] for r in rs
                                      if r["converged_at_scan"] is not None
                                      ])), 1)),
        "runs": len(rs),
    } for p, rs in sorted(by_p.items())]

    out = {
        "what": ("kidnapped-robot P-sweep in a 6-identical-room world "
                 "(multi-modal posterior; frozen known map; uniform init "
                 f"over {w:.0f}x{h:.1f} m x full circle; success = best "
                 "particle within 0.3 m / 0.2 rad at the end and stably "
                 "from convergence on)"),
        "sigma_cells": args.sigma_cells,
        "posterior_note": ("success (the SLAM output: best-particle lock, the analog of the reference's strongest-particle estimate) is the headline rate; posterior_converged (weighted mean < 1 m) lags at high P because the tempered weighting (surface_weight_temp auto) deliberately keeps minority modes alive: the per-scan tempered likelihood gap is ~e^3, so a 90%-population wrong mode retains a few percent of the WEIGHT for several scans after disambiguation and the weighted mean carries meters of minority-mode bias while the argmax is centimeter-accurate.  Untempered weighting would snap the mean but collapse the multimodal phase this benchmark exists to exercise."),
        "world": f"multi_room_world({ROOMS},1,room={ROOM}) — rooms 2-5 "
                 "are translationally identical + ~180deg self-similar",
        "summary": summary,
        "runs": runs,
    }
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(summary))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
