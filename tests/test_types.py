"""Type-layer tests: odometry-from-encoder-counts, scan padding, and the
pytree contract of every state type."""

import numpy as np
import jax.numpy as jnp
import pytest

from gridmap_slam_tpu.config import RobotConfig
from gridmap_slam_tpu.types import Odom, Scan


def test_odom_from_counts_matches_reference_formula():
    """slam/Odometry.java:41-55: d = counts/960 * pi * 0.063;
    dTheta = (dR - dL) / 0.22."""
    r = RobotConfig()
    o = Odom.from_counts(480, 480, r)          # half a wheel revolution each
    want = 0.5 * np.pi * 0.063
    assert abs(float(o.d_center) - want) < 1e-6
    assert abs(float(o.d_theta)) < 1e-9

    o = Odom.from_counts(0, 960, r)            # right wheel one revolution
    d_right = np.pi * 0.063
    assert abs(float(o.d_center) - d_right / 2) < 1e-6
    assert abs(float(o.d_theta) - d_right / 0.22) < 1e-6

    o = Odom.from_counts(-100, 100, r)         # spin in place
    assert abs(float(o.d_center)) < 1e-9
    assert float(o.d_theta) > 0


def test_scan_padding_and_truncation():
    s = Scan.from_arrays([0.1, 0.2], [1.0, 2.0], [True, False], max_beams=4,
                         max_range=10.0)
    assert s.num_beams == 4
    assert list(np.asarray(s.valid)) == [True, True, False, False]
    assert np.asarray(s.dist)[2] == 10.0       # padding at max range
    assert not np.asarray(s.hit)[1]

    s = Scan.from_arrays(np.zeros(10), np.ones(10), np.ones(10, bool),
                         max_beams=4)
    assert int(np.asarray(s.valid).sum()) == 4  # truncated


def _pytree_examples():
    """One small instance of every pytree type the engines carry."""
    import jax
    from gridmap_slam_tpu.models.multi import MultiRobotState, MultiStepInfo
    from gridmap_slam_tpu.models.posegraph import PoseGraph
    from gridmap_slam_tpu.models.shared import SharedMapState
    from gridmap_slam_tpu.types import Frame, SlamState, StepInfo

    f = lambda *s: jnp.arange(int(np.prod(s)), dtype=jnp.float32).reshape(s)
    scan = Scan.from_arrays([0.1, 0.2], [1.0, 2.0], [True, False],
                            max_beams=4)
    odom = Odom(d_center=jnp.float32(0.1), d_theta=jnp.float32(0.02))
    key = jax.random.key(0)
    step = jnp.int32(3)
    return {
        "Scan": scan,
        "Odom": odom,
        "Frame": Frame(scan=scan, odom=odom, t=jnp.float32(1.5)),
        "SlamState": SlamState(poses=f(2, 3), log_weights=f(2),
                               logodds=f(2, 4, 5), key=key, step=step),
        "StepInfo": StepInfo(neff=f(), weighted_pose=f(3), best_pose=f(3),
                             best_index=jnp.int32(1),
                             best_log_weight=f(), resampled=jnp.bool_(1)),
        "SharedMapState": SharedMapState(poses=f(2, 3), log_weights=f(2),
                                         logodds=f(4, 5), key=key,
                                         step=step, recov=f(2)),
        "MultiRobotState": MultiRobotState(poses=f(2, 3, 3),
                                           log_weights=f(2, 3),
                                           logodds=f(4, 5), key=key,
                                           step=step),
        "MultiStepInfo": MultiStepInfo(neff=f(2), weighted_pose=f(2, 3),
                                       best_pose=f(2, 3),
                                       resampled=jnp.zeros(2, bool)),
        "PoseGraph": PoseGraph(nodes=f(3, 3),
                               edge_i=jnp.asarray([0, 1], jnp.int32),
                               edge_j=jnp.asarray([1, 2], jnp.int32),
                               edge_z=f(2, 3), edge_w=f(2, 3)),
    }


@pytest.mark.parametrize("name", ["Scan", "Odom", "Frame", "SlamState",
                                  "StepInfo", "SharedMapState",
                                  "MultiRobotState", "MultiStepInfo",
                                  "PoseGraph"])
def test_pytree_types_roundtrip_replace_and_jit(name):
    """Every state/diagnostic type is a pytree whose children are its
    fields in declaration order: flatten/unflatten round-trips, `.replace`
    swaps one field and leaves the original alone, and the value passes
    through jit unchanged in structure."""
    import dataclasses
    import jax

    obj = _pytree_examples()[name]
    leaves, treedef = jax.tree.flatten(obj)
    back = jax.tree.unflatten(treedef, leaves)
    assert type(back) is type(obj)
    for a, b in zip(leaves, jax.tree.leaves(back)):
        assert a is b
    paths = [p for p, _ in jax.tree_util.tree_flatten_with_path(obj)[0]]
    names = [f.name for f in dataclasses.fields(obj)]
    assert [p[0].name for p in paths] == [
        n for n in names for _ in jax.tree.leaves(getattr(obj, n))]

    first = names[0]
    new_val = jax.tree.map(jnp.copy, getattr(obj, first))
    swapped = obj.replace(**{first: new_val})
    assert getattr(swapped, first) is new_val
    assert getattr(obj, first) is not new_val
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(obj, first, new_val)

    out = jax.jit(lambda t: t)(obj)
    assert jax.tree.structure(out) == treedef
    for a, b in zip(jax.tree.leaves(out), leaves):
        assert a.shape == b.shape and a.dtype == b.dtype
