"""Multi-device sharding tests on the 8-virtual-device CPU mesh."""

import numpy as np
import jax
import pytest

from gridmap_slam_tpu import RBPF, SlamConfig
from gridmap_slam_tpu.config import MapConfig
from gridmap_slam_tpu.parallel.mesh import make_mesh, state_shardings
from gridmap_slam_tpu.parallel.sharded import init_sharded, make_sharded_step


def _tiny_cfg(n_particles):
    return SlamConfig(
        num_particles=n_particles, max_beams=48,
        map=MapConfig(width_m=2.4, height_m=2.4, resolution=0.05,
                      origin=(-1.2, -1.2)))


def _tiny_frame(cfg):
    import jax.numpy as jnp
    from gridmap_slam_tpu.types import Frame, Odom, Scan
    b = cfg.max_beams
    angles = np.linspace(-np.pi, np.pi, b, endpoint=False).astype(np.float32)
    return Frame(
        scan=Scan(angle=jnp.asarray(angles),
                  dist=jnp.full((b,), 0.9, jnp.float32),
                  hit=jnp.ones((b,), bool), valid=jnp.ones((b,), bool)),
        odom=Odom(d_center=jnp.float32(0.05), d_theta=jnp.float32(0.01)),
        t=jnp.float32(0.0))


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_step_runs_and_matches_single_device():
    cfg = _tiny_cfg(16)
    eng = RBPF(cfg)
    frame = _tiny_frame(cfg)

    # single-device result
    s0 = eng.init(jax.random.key(1))
    s1, info1 = jax.jit(eng.step)(s0, frame)

    # sharded over 4 devices x 2 map shards
    mesh = make_mesh(8, map_shards=2)
    ss = init_sharded(eng, jax.random.key(1), mesh)
    step = make_sharded_step(eng, mesh)
    s2, info2 = step(ss, frame)

    # same math, different partitioning: allow float tolerance only
    np.testing.assert_allclose(np.asarray(s1.poses), np.asarray(s2.poses),
                               atol=1e-4)
    np.testing.assert_allclose(float(info1.neff), float(info2.neff),
                               rtol=1e-3)
    np.testing.assert_allclose(np.asarray(s1.logodds),
                               np.asarray(s2.logodds), atol=1e-4)

    # outputs keep the requested shardings
    sh = state_shardings(mesh)
    assert s2.logodds.sharding.is_equivalent_to(sh.logodds, ndim=3)


def test_particle_only_mesh():
    cfg = _tiny_cfg(8)
    eng = RBPF(cfg)
    mesh = make_mesh(8, map_shards=1)
    ss = init_sharded(eng, jax.random.key(0), mesh)
    step = make_sharded_step(eng, mesh)
    s2, info = step(ss, _tiny_frame(cfg))
    assert np.isfinite(float(info.neff))
    assert np.isfinite(np.asarray(s2.poses)).all()


def test_graft_dryrun():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "graft_entry",
        Path(__file__).resolve().parent.parent / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(8)
