"""Cross-backend trajectory-divergence policy (round-4 VERDICT #8).

POLICY (docs/DIVERGENCES.md "Cross-backend trajectory tolerance"): matcher
backends may schedule candidate evaluations differently (f32 summation
order, half-res coarse basin selection), so per-scan argmaxes — and hence
the stochastic filter's trajectories — are NOT bit-identical across
backends.  What is enforced: on a canonical log with a fixed seed, every
backend's ATE must lie within ATE_TOL_M of every other backend's, and
each must meet the absolute bound.
"""

import numpy as np
import jax
import pytest

from gridmap_slam_tpu import RBPF, SlamConfig
from gridmap_slam_tpu.io import read_recording, frames_to_device, frame_at
from gridmap_slam_tpu.utils.metrics import ate_rmse

ATE_TOL_M = 0.06      # max pairwise ATE spread across backends
ATE_ABS_M = 0.25      # absolute bound for each backend on this short log

N_SCANS = 18
PARTICLES = 48


def _run_backend(impl: str, frames, **over):
    cfg = SlamConfig(num_particles=PARTICLES, max_beams=192).with_overrides(
        {"matcher.impl": impl, **over})
    eng = RBPF(cfg)
    state = eng.init(jax.random.key(0))
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range)
    step = eng.step_jit(donate=False)
    traj = []
    for i in range(N_SCANS):
        state, info = step(state, frame_at(batch, i))
        traj.append(np.asarray(info.weighted_pose))
    return np.stack(traj)


def test_backend_trajectories_within_policy_tolerance():
    frames = read_recording("maps/room_loop_40.rec")
    gt = np.load("maps/room_loop_40_gt.npy")[:N_SCANS]
    ates = {}
    for impl, over in [("gather", {}),
                       ("matmul", {"matcher.matmul_bf16": False}),
                       ("matmul_bf16", {"matcher.impl": "matmul",
                                        "matcher.matmul_bf16": True}),
                       ("splat", {})]:
        name = impl
        if impl == "matmul_bf16":
            impl = "matmul"
        traj = _run_backend(impl, frames, **over)
        ates[name] = float(ate_rmse(traj, gt))
    vals = list(ates.values())
    spread = max(vals) - min(vals)
    assert spread <= ATE_TOL_M, (ates, spread)
    assert max(vals) <= ATE_ABS_M, ates


def test_gather_and_f32_matmul_identical_schedule():
    """Stronger than the ATE policy where it CAN hold: the f32 matmul
    backend evaluates the same candidate schedule as gather with exactly
    representable one-hot contractions, so the trajectories must agree to
    float tolerance (not just in ATE class)."""
    frames = read_recording("maps/room_loop_40.rec")
    a = _run_backend("gather", frames)
    b = _run_backend("matmul", frames, **{"matcher.matmul_bf16": False})
    np.testing.assert_allclose(a, b, atol=5e-3)
