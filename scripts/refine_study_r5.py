"""ATE / throughput vs surface hill-climb refine steps (round-4 weak #8:
quality-mode refine cost had no per-stage row and refine=0's default had
no ATE curve behind it).

Runs refine in {0, 1, 2, 4} on (a) the canonical room_loop_40 recording
at 100k particles (ATE evidence) and (b) the bench synthetic log at 1M
(throughput evidence), with the round-5 auto-temp + gated-resample
defaults.  Writes docs/bench/refine_study_r5.json.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np

from temp_study_r5 import run_case  # noqa: E402


def main():
    from gridmap_slam_tpu.io import read_recording
    from gridmap_slam_tpu.io.synthetic import (SimParams, default_world,
                                               simulate_log,
                                               square_path_controls)

    frames_c = read_recording("maps/room_loop_40.rec")
    gt_c = np.load("maps/room_loop_40_gt.npy")
    frames_b, gt_b = simulate_log(default_world(), square_path_controls(12),
                                  params=SimParams(beams_per_rev=180),
                                  seed=0)
    results = {"canonical_room_loop_40_100k": [], "bench_synthetic_1M": []}
    for refine in (0, 1, 2, 4):
        r = run_case(frames_c, gt_c, 100_000, 0.0, 6.0, 192,
                     resample_fraction=0.15, refine_steps=refine)
        results["canonical_room_loop_40_100k"].append(r)
        print(json.dumps(r), flush=True)
    for refine in (0, 1, 2, 4):
        r = run_case(frames_b, gt_b, 1_000_000, 0.0, 6.0, 192,
                     resample_fraction=0.15, refine_steps=refine)
        results["bench_synthetic_1M"].append(r)
        print(json.dumps(r), flush=True)

    out = {"what": ("surface refine-step sweep under the round-5 defaults "
                    "(auto temp, 0.15 gate); wall ms/scan includes the "
                    "per-replay dispatch cost — compare within this file"),
           "results": results}
    Path("docs/bench/refine_study_r5.json").write_text(
        json.dumps(out, indent=1))
    print("wrote docs/bench/refine_study_r5.json")


if __name__ == "__main__":
    main()
