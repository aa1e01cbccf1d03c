"""Utils tests: metrics, checkpointing, visualization, logging."""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gridmap_slam_tpu.utils.metrics import (ScanTimer, align_se2, ate_rmse,
                                            relative_pose_error)


def test_ate_rmse_basic():
    a = np.asarray([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    b = np.asarray([[0.0, 1.0], [1.0, 1.0]])
    assert abs(ate_rmse(a, b) - 1.0) < 1e-9


def test_ate_alignment_removes_rigid_offset():
    rng = np.random.RandomState(0)
    gt = rng.uniform(-2, 2, (30, 2))
    th = 0.4
    r = np.asarray([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    est = gt @ r.T + np.asarray([1.0, -2.0])
    assert ate_rmse(est, gt) > 1.0
    assert ate_rmse(est, gt, align=True) < 1e-6


def test_relative_pose_error_zero_for_identical():
    t = np.cumsum(np.random.RandomState(1).uniform(0, 0.1, (10, 2)), axis=0)
    assert relative_pose_error(t, t) < 1e-12


def test_scan_timer():
    t = ScanTimer()
    import time
    for _ in range(3):
        with t:
            time.sleep(0.01)
    assert 5 < t.mean_ms < 100
    assert t.scans_per_sec() > 10


def test_checkpoint_roundtrip(tmp_path):
    from gridmap_slam_tpu import RBPF, SlamConfig
    from gridmap_slam_tpu.utils.checkpoint import restore_state, save_state

    cfg = SlamConfig(num_particles=4)
    eng = RBPF(cfg)
    state = eng.init(jax.random.key(7))
    state = state.replace(
        logodds=state.logodds.at[:, 3, 4].set(1.5),
        poses=state.poses + 0.25)
    path = tmp_path / "ckpt"
    save_state(str(path), state)
    restored = restore_state(str(path), state)
    np.testing.assert_array_equal(np.asarray(restored.logodds),
                                  np.asarray(state.logodds))
    np.testing.assert_array_equal(np.asarray(restored.poses),
                                  np.asarray(state.poses))
    assert int(restored.step) == int(state.step)


def test_render_map(tmp_path):
    from gridmap_slam_tpu.utils.viz import render_likelihood, render_map

    lo = np.random.RandomState(0).normal(size=(40, 40))
    p = tmp_path / "map.png"
    render_map(lo, p, trajectory=np.asarray([[0.0, 0.0], [0.5, 0.5]]),
               particles=np.asarray([[0.1, 0.1]]), origin=(-1.0, -1.0),
               resolution=0.05)
    assert p.exists() and p.stat().st_size > 1000
    p2 = tmp_path / "lik.png"
    render_likelihood(np.abs(lo) / np.abs(lo).max(), p2)
    assert p2.exists()


def test_metrics_logger(tmp_path):
    from gridmap_slam_tpu.types import StepInfo
    from gridmap_slam_tpu.utils.logging import MetricsLogger

    info = StepInfo(neff=jnp.float32(12.5),
                    weighted_pose=jnp.zeros(3),
                    best_pose=jnp.zeros(3),
                    best_index=jnp.int32(3),
                    best_log_weight=jnp.float32(-100.0),
                    resampled=jnp.asarray(True))
    path = tmp_path / "metrics.jsonl"
    log = MetricsLogger(path)
    log.log_scan(0, info, scan_ms=3.3)
    log.log_scan(1, info)
    log.log_event("resample", count=2)
    log.close()
    lines = [json.loads(l) for l in path.read_text().splitlines()]
    assert len(lines) == 3
    assert lines[0]["neff"] == 12.5 and lines[0]["scan_ms"] == 3.3
    assert lines[2]["event"] == "resample"


@pytest.mark.parametrize("env_value", [None, "custom"])
def test_compile_cache_dir_follows_env(env_value, monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is used and nothing overrides
    it; unset, the cache goes to the fixed <repo>/.jax_cache."""
    from pathlib import Path

    from gridmap_slam_tpu.utils import compile_cache as cc

    repo = Path(__file__).resolve().parent.parent
    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: updates.append((name, value)))
    if env_value is None:
        monkeypatch.delenv(cc.ENV_VAR, raising=False)
        want = str(repo / ".jax_cache")
        assert cc.enable_compile_cache() == want
        assert updates == [("jax_compilation_cache_dir", want)]
    else:
        want = str(tmp_path / env_value)
        monkeypatch.setenv(cc.ENV_VAR, want)
        assert cc.enable_compile_cache() == want
        assert updates == []
    assert cc.compile_cache_dir() == want
