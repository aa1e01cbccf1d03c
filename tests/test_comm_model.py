"""Comm-model (parallel/comm_model.py) tests: the enumerated collectives
must match the engines' actual lowered collective structure, and the
payload arithmetic must scale the way the step code says it does."""

import re

import numpy as np
import jax
import pytest

from gridmap_slam_tpu.config import MapConfig, SlamConfig
from gridmap_slam_tpu.models.shared import SharedMapSLAM
from gridmap_slam_tpu.parallel.comm_model import comm_table
from gridmap_slam_tpu.parallel.mesh import make_mesh
from gridmap_slam_tpu.io import frames_to_device, frame_at
from gridmap_slam_tpu.io.synthetic import (SimParams, default_world,
                                           simulate_log,
                                           square_path_controls)


def _cfg(p=32):
    return SlamConfig(num_particles=p, max_beams=64,
                      map=MapConfig(width_m=6.4, height_m=4.0,
                                    resolution=0.1, origin=(-3.2, -2.0)))


def _lowered_text(step, state, frame):
    return step.lower(state, frame).as_text()


@pytest.fixture(scope="module")
def frame():
    frames, _ = simulate_log(default_world(), square_path_controls(2),
                             params=SimParams(beams_per_rev=60), seed=0)
    cfg = _cfg()
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range)
    return frame_at(batch, 0)


def test_model_kinds_match_lowered_tiled(frame):
    """Every collective kind the model lists for the tiled engine appears
    in its lowered HLO, and the engine uses no kind the model omits."""
    cfg = _cfg()
    eng = SharedMapSLAM(cfg)
    mesh = make_mesh(8, map_shards=4)
    from gridmap_slam_tpu.parallel.tiled import init_tiled, make_tiled_step
    state = init_tiled(eng, jax.random.key(0), mesh)
    txt = _lowered_text(make_tiled_step(eng, mesh), state, frame)
    rows = comm_table(cfg, 2, 4, "tiled")
    kinds = {r.collective for r in rows}
    assert any("ppermute" in k for k in kinds)
    assert "collective_permute" in txt          # halos
    assert "all_reduce" in txt                  # psums
    assert "all_gather" in txt                  # election + resample


def test_model_kinds_match_lowered_surface_sharded(frame):
    cfg = _cfg().with_overrides({"matcher.surface_nt": 7,
                                 "matcher.surface_crop_cells": 48})
    eng = SharedMapSLAM(cfg)
    mesh = make_mesh(8, map_shards=4)
    from gridmap_slam_tpu.parallel.surface_sharded import (
        init_surface_sharded, make_surface_sharded_step)
    state = init_surface_sharded(eng, jax.random.key(0), mesh)
    txt = _lowered_text(make_surface_sharded_step(eng, mesh), state, frame)
    # round 5: NO ppermute halos — the field builds crop-locally from the
    # psum-assembled raw crop (the model must not list any either)
    assert "collective_permute" not in txt
    assert "all_reduce" in txt                  # crop psum + weight stats
    assert "all_gather" in txt                  # volume + election
    rows_k = {r.collective for r in comm_table(
        _cfg().with_overrides({"matcher.surface_nt": 7}), 2, 4,
        "surface_sharded")}
    assert not any("ppermute" in k for k in rows_k)
    rows = comm_table(cfg, 2, 4, "surface_sharded")
    vol = [r for r in rows if "likelihood volume" in r.what]
    assert len(vol) == 1
    # 7 bins pad to 2/shard x 4 shards; crop 48 clamps per-axis on the
    # 64 x 40 map -> (40, 48)
    assert vol[0].bytes_per_scan == 4 * 2 * 4 * 40 * 48


def test_resample_gathers_are_inside_the_cond(frame):
    """The round-5 gating: the resampling all_gathers must be lowered
    inside a conditional region, not unconditionally in the main body —
    16 B/particle of cross-host traffic only on resampling scans."""
    cfg = _cfg()
    eng = SharedMapSLAM(cfg)
    mesh = make_mesh(8, map_shards=1)
    from gridmap_slam_tpu.parallel.shmap import init_shmap, make_shmap_step
    state = init_shmap(eng, jax.random.key(0), mesh)
    txt = _lowered_text(make_shmap_step(eng, mesh), state, frame)
    # the (P, 3) pose gather appears only under a region/branch (HLO
    # conditionals lower to regions whose text is indented computations)
    assert "all_gather" in txt
    # the resample branch lowers to a stablehlo.case region; the pose
    # gather (channel ops inside the region) must not also appear
    # unconditionally before it.  Structural check: a case region exists
    # and at least one all_gather is textually inside it.
    m = re.search(r"stablehlo\.case[\s\S]*?all_gather", txt)
    assert "stablehlo.case" in txt and m is not None


def test_payload_scaling():
    cfg = _cfg(1024)
    rows1 = comm_table(cfg, 4, 2, "tiled")
    resamp = [r for r in rows1 if "resampling" in r.when]
    assert len(resamp) == 1
    assert resamp[0].bytes_per_scan == 16 * 1024          # 16 B / particle
    # matcher psum scales with local particle count
    psum = [r for r in rows1 if r.axis == "m" and r.collective == "psum"]
    rows2 = comm_table(cfg, 8, 2, "tiled")
    psum2 = [r for r in rows2 if r.axis == "m" and r.collective == "psum"]
    assert psum[0].bytes_per_scan == 2 * psum2[0].bytes_per_scan
