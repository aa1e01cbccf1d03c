"""Distributed pose-graph bundle adjustment over collectives.

North-star capability (BASELINE.json: "distributed pose-graph BA uses
Schur-complement reduction over psum/all_gather collectives"): the edge set
is sharded across devices; every device computes residuals/Jacobians and the
weighted normal-equation contributions H_partial/b_partial for ITS edges
only, a `psum` reduces them to the full system, and the (small, dense)
reduced system solve runs replicated.  For SE(2) pose graphs the nodes ARE
the reduced variables (no landmark block to eliminate), so the psum'd
assembly is exactly the Schur-reduced system; the same structure extends to
bipartite problems by eliminating the landmark diagonal per shard before
the reduction.

Edges are padded (zero information) to a multiple of the shard count, which
keeps them inert (tests/test_posegraph.py::test_padded_edges_are_inert).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.posegraph import PoseGraph, normal_equations
from ..ops.geometry import wrap_angle


def make_distributed_optimizer(mesh: Mesh, iterations: int = 10,
                               damping: float = 1e-6, anchor_w: float = 1e6):
    """Build a jitted distributed GN optimizer: edges sharded over mesh axis
    'p', nodes replicated.  Returns fn(graph) -> (graph, chi2_history)."""

    def shard_fn(graph: PoseGraph):
        def gn_iter(nodes, _):
            h_part, b_part, chi2_part = normal_equations(
                nodes, graph.edge_i, graph.edge_j, graph.edge_z,
                graph.edge_w)
            h = jax.lax.psum(h_part, "p")          # <- the Schur reduction
            b = jax.lax.psum(b_part, "p")
            chi2 = jax.lax.psum(chi2_part, "p")
            k = nodes.shape[0]
            diag = jnp.concatenate([
                jnp.full((3,), anchor_w, nodes.dtype),
                jnp.full((3 * (k - 1),), damping, nodes.dtype)])
            dx = jax.scipy.linalg.solve(h + jnp.diag(diag), -b,
                                        assume_a="pos").reshape(k, 3)
            new_nodes = nodes + dx
            new_nodes = new_nodes.at[:, 2].set(wrap_angle(new_nodes[:, 2]))
            return new_nodes, chi2

        # f32 solve, as in models/posegraph.optimize
        with jax.default_matmul_precision("float32"):
            nodes, chi2s = jax.lax.scan(gn_iter, graph.nodes, None,
                                        length=iterations)
        return graph.replace(nodes=nodes), chi2s

    graph_spec = PoseGraph(nodes=P(), edge_i=P("p"), edge_j=P("p"),
                           edge_z=P("p", None), edge_w=P("p", None))
    fn = jax.shard_map(shard_fn, mesh=mesh,
                       in_specs=(graph_spec,),
                       out_specs=(graph_spec, P()),
                       check_vma=False)
    return jax.jit(fn)


def pad_edges(edge_i, edge_j, edge_z, edge_w, multiple: int):
    """Pad the edge set with zero-information edges to a multiple (inert)."""
    e = len(edge_i)
    target = ((e + multiple - 1) // multiple) * multiple
    pad = target - e
    if pad == 0:
        return edge_i, edge_j, edge_z, edge_w
    return (np.concatenate([edge_i, np.zeros(pad, edge_i.dtype)]),
            np.concatenate([edge_j, np.zeros(pad, edge_j.dtype)]),
            np.concatenate([edge_z, np.zeros((pad, 3), edge_z.dtype)]),
            np.concatenate([edge_w, np.zeros((pad, 3), edge_w.dtype)]))


def shard_graph(graph_arrays, mesh: Mesh) -> PoseGraph:
    """Place (nodes, ei, ej, ez, ew) onto the mesh with edges over 'p'."""
    nodes, ei, ej, ez, ew = graph_arrays
    g = PoseGraph(nodes=jnp.asarray(nodes, jnp.float32),
                  edge_i=jnp.asarray(ei), edge_j=jnp.asarray(ej),
                  edge_z=jnp.asarray(ez, jnp.float32),
                  edge_w=jnp.asarray(ew, jnp.float32))
    sh = PoseGraph(nodes=NamedSharding(mesh, P()),
                   edge_i=NamedSharding(mesh, P("p")),
                   edge_j=NamedSharding(mesh, P("p")),
                   edge_z=NamedSharding(mesh, P("p", None)),
                   edge_w=NamedSharding(mesh, P("p", None)))
    return jax.tree.map(jax.device_put, g, sh)
