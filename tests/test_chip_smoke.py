"""chip_smoke.py on the CPU: its phases at tiny sizes (the GPU runs them at
full size), its refusal to run without a GPU, and the trace reduction the
layers phase relies on."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


@pytest.fixture(scope="module")
def cpu():
    return jax.devices("cpu")[0]


@pytest.fixture(scope="module")
def short_log(tmp_path_factory):
    """A 5-scan recording with its ground truth beside it."""
    from gridmap_slam_tpu.io import write_recording
    from gridmap_slam_tpu.io.synthetic import (SimParams, default_world,
                                               simulate_log,
                                               square_path_controls)
    d = tmp_path_factory.mktemp("log")
    frames, gt = simulate_log(default_world(), square_path_controls(5),
                              params=SimParams(beams_per_rev=60), seed=3)
    write_recording(d / "short.rec", frames)
    np.save(d / "short_gt.npy", gt)
    return d / "short.rec"


def test_main_without_gpu_exits_nonzero(capsys):
    assert cs.main([]) == 2
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "no GPU" in out.err


def test_script_alone_fails(tmp_path):
    """Copied out of the repository it cannot import the engine: a
    non-zero exit and no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_phase_precision_tiny(cpu, capsys):
    cs.phase_precision(cpu, cpu, cells=24, bins=256, n=64, beams=36,
                       particles=4, kc=12, graph_nodes=12)
    out = capsys.readouterr().out
    assert "PHASE precision ok" in out
    assert "precision.beam_table_onehot_vs_take_mismatches: 0" in out


def test_phase_layers_tiny(cpu, tmp_path, capsys):
    got = cs.phase_layers(cpu, cpu, "cpu", particles=4, cells=24, beams=36,
                          trace_dir=tmp_path / "trace")
    assert set(got["layers"]) == {"llfield", "matcher", "map_update",
                                  "other"}
    assert got["kernel_ns"] > 0
    assert got["layers"]["matcher"] > 0 and got["layers"]["map_update"] > 0
    assert "PHASE layers ok" in capsys.readouterr().out


def test_phase_replay_tiny(short_log, tmp_path):
    metrics, traj, m = cs.phase_replay(
        "parity", ["--engine", "rbpf", "--particles", "8"], tmp_path, "cpu",
        log=short_log)
    assert metrics["frames"] == 5 and traj.shape == (5, 3)
    assert m.shape == (120, 120)
    with pytest.raises(cs.CheckFailed, match="ate_m"):
        cs.phase_replay("tight", ["--engine", "rbpf", "--particles", "8"],
                        tmp_path, "cpu", log=short_log, ate_bound=0.0)


def test_phase_four_tiny(short_log, tmp_path, capsys):
    """The four-device path on four of the virtual CPU devices."""
    assert len(jax.devices()) >= 4
    cs.phase_four(tmp_path, "cpu", surface_particles=4096,
                  tiled_particles=16, n_frames=2, log=short_log,
                  ate_bound=10.0)
    out = capsys.readouterr().out
    for phase in ("four_surface_sharded_vs_unsharded_map",
                  "four_surface_sharded_vs_surface",
                  "four_tiled_vs_unsharded_map", "four_tiled_vs_shared"):
        assert f"PHASE {phase} ok" in out


def test_devtrace_layer_attribution():
    """HLO text -> layer map (scope metadata first, stack-frame source
    files second, fusions by majority) and the per-layer sums."""
    from gridmap_slam_tpu.utils.devtrace import hlo_layers, layer_times
    hlo = "\n".join([
        "HloModule jit_step",
        "",
        "FileNames",
        '1 "/x/gridmap_slam_tpu/ops/raycast.py"',
        "",
        "FileLocations",
        "1 {file_name_id=1 function_name_id=1 line=3 end_line=3}",
        "",
        "StackFrames",
        "1 {file_location_id=1 parent_frame_id=1}",
        "",
        "%fused_computation.1 (p: f32[4]) -> f32[4] {",
        '  %a = f32[4] sine(%p), metadata={op_name="jit(step)/llfield/sin"}',
        '  ROOT %b = f32[4] add(%a, %a), metadata={op_name="jit(step)/'
        'llfield/add"}',
        "}",
        "",
        "ENTRY %main (p: f32[4]) -> f32[4] {",
        "  %fusion.1 = f32[4] fusion(%p), kind=kLoop, "
        "calls=%fused_computation.1",
        '  %atan = f32[4] atan2(%p, %p), metadata={op_name="atan2" '
        "stack_frame_id=1}",
        '  %gather.2 = f32[4] gather(%p), metadata={op_name="jit(step)/'
        'matcher/gather"}',
        "  ROOT %copy.3 = f32[4] copy(%gather.2)",
        "}",
    ])
    layers = hlo_layers(hlo)
    assert layers == {"a": "llfield", "b": "llfield", "fusion.1": "llfield",
                      "atan": "map_update", "gather.2": "matcher"}
    events = [("fusion.1", 0, 10), ("atan", 5, 10), ("gather.2", 30, 5),
              ("copy.3", 40, 2)]
    r = layer_times(events, layers)
    assert r["layers"] == {"llfield": 10, "matcher": 5, "map_update": 10,
                           "other": 2}
    assert r["kernel_ns"] == 27 and r["busy_ns"] == 22
    assert r["span_ns"] == 42 and r["top_other"] == [("copy.3", 2)]


@pytest.mark.gpu
def test_phase_precision_on_gpu(gpu_device, cpu):
    """The precision phase at parity widths on the card."""
    cs.phase_precision(gpu_device, cpu)
