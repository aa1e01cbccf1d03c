"""Bring-up check of the SLAM engine on NVIDIA GPUs, in one process.

    python chip_smoke.py            # one GPU: the five phases below
    python chip_smoke.py --four     # four GPUs: the map-sharded engines

One GPU, in order:
  device     JAX sees a GPU: its kind and count, and nvidia-smi's name and
             power limit (read by a child that does not import JAX).
  precision  f32 matmul at DEFAULT against HIGHEST (is TF32 on?), and each
             precision-sensitive formulation against its exact twin.
  layers     the plain-JAX layers of the RBPF step at parity widths (500
             particles x 120 x 120 cells, 180 beams) on the GPU against the
             same functions on the host CPU, and one warm parity step traced
             with jax.profiler for the device time of each layer.
  parity     `cli replay` of maps/room_loop_40.rec as the reference robot
             runs it (rbpf, 500 particles, 6 m map at 5 cm, 180 beams); ATE
             against the log's ground truth.
  surface1m  the same replay with the 1M-particle surface filter.

--four runs only the map-sharded engines (surface-sharded at 1M particles
and tiled, on a ('p', 'm') = (2, 2) mesh over four GPUs), each against the
same engine with the map unsharded and against its single-GPU counterpart
(surface, shared), plus the ATE bound.

The CLI runs in-process (app.cli.main); no child touches a GPU.  Every
check prints its value beside its bound.  A failed check raises, and the
script exits 1 without its final line.  With no GPU visible to JAX it
exits 2 before any phase.  The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LOG = ROOT / "maps" / "room_loop_40.rec"
ATE_BOUND_M = 0.10          # CPU reference: 0.03 m (docs/ate_parity_*)
# Stage scores are f32 sums over up to 180 beams of magnitude ~300, where
# two exact-f32 summation orders already differ by ~1.5e-4 (CPU gather vs
# CPU matmul).  The bound is relative to the largest |score|: ~17 ulp,
# 50x below what TF32-rounded taps would give.
SCORE_REL = 2e-6
PARITY_ARGS = ["--engine", "rbpf", "--particles", "500"]
SURFACE_ARGS = ["--engine", "surface", "--particles", "1000000"]


class CheckFailed(AssertionError):
    pass


class Checks:
    """Prints each check of one phase with its bound; `done` raises if any
    failed."""

    def __init__(self, phase: str):
        self.phase = phase
        self.failed = []
        print(f"PHASE {phase}", flush=True)

    def _report(self, name, ok, text):
        print(f"  {self.phase}.{name}: {text} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            self.failed.append(name)

    def le(self, name, value, bound):
        self._report(name, bool(value <= bound),     # NaN fails
                     f"{value:.6g} <= {bound:g}")

    def ge(self, name, value, bound):
        self._report(name, bool(value >= bound), f"{value:.6g} >= {bound:g}")

    def true(self, name, cond, detail=""):
        self._report(name, bool(cond), detail or "true")

    def note(self, text):
        print(f"  {self.phase}: {text}", flush=True)

    def done(self):
        if self.failed:
            raise CheckFailed(f"phase {self.phase} failed: "
                              f"{', '.join(self.failed)}")
        print(f"PHASE {self.phase} ok", flush=True)


# ------------------------------------------------------------- helpers
def nvidia_smi():
    """nvidia-smi's name and power limit of every card, one line each."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def on(device, fn, *args):
    """Run jax.jit(fn) with its arguments placed on `device`; result as
    NumPy (a pytree of arrays)."""
    import jax
    import numpy as np
    args = jax.device_put(args, device)
    return jax.tree.map(np.asarray, jax.jit(fn)(*args))


def synthetic_scan(rng, beams: int, max_range: float = 10.0):
    """A full-circle scan of `beams` beams, ~90 % hits at 0.5-5 m."""
    import numpy as np
    from gridmap_slam_tpu.types import Scan
    angles = np.linspace(-np.pi, np.pi, beams, endpoint=False)
    dists = rng.uniform(0.5, 5.0, beams)
    hits = rng.uniform(size=beams) < 0.9
    dists = np.where(hits, dists, max_range)
    return Scan.from_arrays(angles, dists, hits, max_beams=beams,
                            max_range=max_range)


def random_maps(rng, n: int, cells: int):
    """(n, cells, cells) log-odds maps: walls, free space and unknown
    cells in blocks, varied per map."""
    import numpy as np
    base = rng.choice([-1.2, 0.0, 2.2], p=[0.6, 0.3, 0.1],
                      size=(cells // 4 + 1, cells // 4 + 1))
    base = np.kron(base, np.ones((4, 4)))[:cells, :cells]
    maps = np.repeat(base[None], n, axis=0)
    flip = rng.uniform(size=maps.shape) < 0.05
    maps = np.where(flip, rng.choice([-1.2, 0.0, 2.2], size=maps.shape),
                    maps)
    return maps.astype(np.float32)


def oracle_llfield(logodds, z_hit: float, max_range: float):
    """Float64 log-likelihood field of one map by the NumPy oracle's blur
    (oracle/numpy_ref.py), with the engine's unknown-cell rule: a cell with
    no explored cell in its blur window reads the uniform 1/max_range."""
    import numpy as np
    from gridmap_slam_tpu.oracle.numpy_ref import OracleGridMap
    gm = OracleGridMap()
    gm.h, gm.w = logodds.shape
    field = gm.likelihood(logodds.astype(np.float64))
    explored = gm.likelihood(np.where(logodds != 0.0, 1.0, -1.0))
    uniform = 1.0 / max_range
    return np.where(explored <= 0.0, np.log(uniform),
                    np.log(z_hit * field + (1.0 - z_hit) * uniform))


def correlate_np(llf, e_stack, ll_outside: float):
    """Float64 reference of ops/surface.scan_surface: C[t, y, x] =
    sum_{dy, dx} pad(llf)[y + dy, x + dx] * E[t, dy, dx], by FFT over the
    exact linear-correlation length."""
    import numpy as np
    kc = (e_stack.shape[-1] - 1) // 2
    fpad = np.pad(np.asarray(llf, np.float64), kc,
                  constant_values=ll_outside)
    s = fpad.shape
    e = np.asarray(e_stack, np.float64)
    out = np.fft.irfft2(np.fft.rfft2(fpad, s)[None]
                        * np.conj(np.fft.rfft2(e, s)), s)
    return out[:, :llf.shape[0], :llf.shape[1]]


def loop_graph(k: int):
    """A k-node loop pose graph with odometry edges, one loop closure and
    a drifted initialization (the shape of models/frontend's graphs)."""
    import numpy as np
    import jax.numpy as jnp
    from gridmap_slam_tpu.models.posegraph import PoseGraph, odometry_edges
    th = np.linspace(0, 2 * np.pi, k, endpoint=False)
    gt = np.stack([3 * np.cos(th), 3 * np.sin(th), th + np.pi / 2], 1)
    ei, ej, ez, ew = odometry_edges(gt.astype(np.float32))
    a, b = gt[-1], gt[0]
    c, s = math.cos(a[2]), math.sin(a[2])
    rel = [c * (b[0] - a[0]) + s * (b[1] - a[1]),
           -s * (b[0] - a[0]) + c * (b[1] - a[1]),
           math.atan2(math.sin(b[2] - a[2]), math.cos(b[2] - a[2]))]
    drift = np.linspace(0, 0.3, k)[:, None] * np.asarray([1.0, -0.5, 0.2])
    return PoseGraph(
        nodes=jnp.asarray(gt + drift, jnp.float32),
        edge_i=jnp.asarray(np.append(ei, k - 1).astype(np.int32)),
        edge_j=jnp.asarray(np.append(ej, 0).astype(np.int32)),
        edge_z=jnp.asarray(np.vstack([ez, rel]).astype(np.float32)),
        edge_w=jnp.asarray(np.vstack([ew, [400.0, 400.0, 800.0]])
                           .astype(np.float32)))


def normal_equations_np(nodes, ei, ej, e, ji, jj, w):
    """Float64 assembly of the GN normal equations from f32 residuals and
    Jacobians (the reference for models/posegraph.normal_equations)."""
    import numpy as np
    k = len(nodes)
    e, ji, jj, w = (np.asarray(x, np.float64) for x in (e, ji, jj, w))
    h = np.zeros((k, k, 3, 3))
    b = np.zeros((k, 3))
    for n in range(len(ei)):
        i, j = int(ei[n]), int(ej[n])
        wi, wj = w[n][:, None] * ji[n], w[n][:, None] * jj[n]
        h[i, i] += ji[n].T @ wi
        h[j, j] += jj[n].T @ wj
        h[i, j] += ji[n].T @ wj
        h[j, i] += (ji[n].T @ wj).T
        b[i] += ji[n].T @ (w[n] * e[n])
        b[j] += jj[n].T @ (w[n] * e[n])
    return h.transpose(0, 2, 1, 3).reshape(3 * k, 3 * k), b.reshape(-1)


def integrate_margin(scan, lut, pose, iy: int, ix: int, res: float,
                     origin, tol_cells: float) -> float:
    """Float64 distance of one cell's ops/raycast.integrate_scan decisions
    from their thresholds: the bearing-bin edge (in bins), the ray
    footprint edge and the free/occupied band edges (in cells), and the
    cos(dphi) > 0 test.  A cell whose update differs between two f32
    backends must sit within rounding of one of them."""
    import numpy as np
    wrap = lambda a: np.arctan2(np.sin(a), np.cos(a))
    ang = np.asarray(scan.angle, np.float64)
    dist = np.asarray(scan.dist, np.float64)
    lut = np.asarray(lut)
    n_bins = len(lut)
    x, y, th = (float(v) for v in pose)
    dx = origin[0] + (ix + 0.5) * res - x
    dy = origin[1] + (iy + 0.5) * res - y
    r = math.hypot(dx, dy)
    phi = math.atan2(dy, dx) - th
    u = (wrap(phi) + math.pi) * n_bins / (2 * math.pi)
    k = lut[min(max(int(math.floor(u)), 0), n_bins - 1)]
    alpha, m = ang[k], dist[k]
    dphi = wrap(phi - alpha)
    halfw = 0.5005 * (abs(math.cos(th + alpha))
                      + abs(math.sin(th + alpha))) * res
    tol_m = 0.5 * tol_cells * res
    in_cells = min(abs(abs(r * math.sin(dphi)) - halfw),
                   abs(r - (m - tol_m)), abs(r - (m + tol_m)),
                   abs(r - m)) / res
    return min(abs(u - round(u)), in_cells, abs(math.cos(dphi)))


def _rel(a, b):
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _max_abs(a, b):
    import numpy as np
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


# -------------------------------------------------------------- phases
def phase_device(min_count: int = 1):
    """Require a GPU; print its kind, the device count and nvidia-smi's
    name and power limit.  Returns the first card's nvidia-smi line."""
    import jax
    devs = jax.devices()
    c = Checks("device")
    c.true("platform_gpu", devs[0].platform == "gpu",
           f"platform={devs[0].platform}")
    c.ge("device_count", len(devs), min_count)
    c.note(f"kind={devs[0].device_kind} count={len(devs)}")
    smi = nvidia_smi()
    for line in smi:
        print(f"nvidia-smi: {line}", flush=True)
    c.done()
    return smi[0]


def phase_precision(dev, cpu, cells: int = 120, bins: int = 2048,
                    n: int = 1024, beams: int = 180, particles: int = 16,
                    kc: int = 202, graph_nodes: int = 216):
    """Precision-sensitive formulations on `dev`: the defaults are the
    parity widths (6 m map at 5 cm; kc = max_range / resolution + 2)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from gridmap_slam_tpu.models.posegraph import (normal_equations,
                                                   optimize,
                                                   residuals_and_jacobians)
    from gridmap_slam_tpu.ops.geometry import scan_points
    from gridmap_slam_tpu.ops.grid import gaussian_kernel, likelihood_field
    from gridmap_slam_tpu.ops.matcher import (_stage_scores,
                                              log_likelihood_field)
    from gridmap_slam_tpu.ops.matcher_matmul import (pad_llfield,
                                                     stage_scores_matmul)
    from gridmap_slam_tpu.ops.raycast import (_beam_values_for_cells,
                                              build_beam_lut)
    from gridmap_slam_tpu.ops.surface import (scan_surface,
                                              splat_endpoint_kernels)
    from gridmap_slam_tpu.parallel.ba import make_distributed_optimizer
    from gridmap_slam_tpu.parallel.mesh import make_mesh

    c = Checks("precision")
    rng = np.random.RandomState(0)
    hp, dp = jax.lax.Precision.HIGHEST, jax.lax.Precision.DEFAULT

    # f32 matmul: DEFAULT vs HIGHEST vs float64
    a = rng.randn(n, n).astype(np.float32)
    b = rng.randn(n, n).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    got_d = on(dev, lambda x, y: jnp.dot(x, y, precision=dp), a, b)
    got_h = on(dev, lambda x, y: jnp.dot(x, y, precision=hp), a, b)
    err_d, err_h = _rel(got_d, ref), _rel(got_h, ref)
    c.note(f"matmul f32 {n}x{n}: DEFAULT rel err {err_d:.3e}, HIGHEST "
           f"{err_h:.3e}; DEFAULT "
           f"{'rounds inputs (TF32-class)' if err_d > 1e-5 else 'is f32'}")
    c.le("matmul_highest_rel_err", err_h, 1e-5)

    # beam-table selection: one-hot contraction vs its own gather branch
    res, origin = 0.05, (-cells * 0.025, -cells * 0.025)
    scan = synthetic_scan(rng, beams)
    phi = rng.uniform(-np.pi, np.pi, (cells, cells)).astype(np.float32)

    def beam_values(one_hot):
        return lambda s, p: _beam_values_for_cells(
            s, build_beam_lut(s, bins), p, one_hot=one_hot)

    oh = on(dev, beam_values(True), scan, phi)
    tk = on(dev, beam_values(False), scan, phi)
    mism = sum(int(np.sum(x != y)) for x, y in zip(oh, tk))
    c.le("beam_table_onehot_vs_take_mismatches", mism, 0)

    # matmul matcher (f32, HIGHEST) vs gather stage scores
    maps = random_maps(rng, 1, cells)
    kern = gaussian_kernel(1.0, 3)

    def llf_of(lo):
        f, u = likelihood_field(lo, kern)
        return log_likelihood_field(f, u, 0.9, 10.0)

    llf = on(dev, llf_of, maps[0])
    px, py = scan_points(scan)
    use = np.asarray(scan.valid & scan.hit)
    poses = np.concatenate([rng.uniform(-0.5, 0.5, (particles, 2)),
                            rng.uniform(-np.pi, np.pi, (particles, 1))],
                           1).astype(np.float32)
    dxs = np.linspace(-0.1, 0.1, 5).astype(np.float32)
    dts = np.linspace(-0.05, 0.05, 5).astype(np.float32)
    ll_out = math.log(1.0 / 10.0)
    kw = dict(resolution=res, origin=origin)

    def gather(f, x, y, u, ps):
        return jax.vmap(lambda p: _stage_scores(
            f, x, y, u, p, dxs, dxs, dts, z_hit=0.9, max_range=10.0,
            **kw))(ps)

    def matmul(f, x, y, u, ps):
        fpad = pad_llfield(f, 2, ll_out)
        return jax.vmap(lambda p: stage_scores_matmul(
            fpad, x, y, u.astype(jnp.float32), p, dxs, dxs, dts, pad=2,
            bf16=False, **kw))(ps)

    sg = on(dev, gather, llf, px, py, use, poses)
    sm = on(dev, matmul, llf, px, py, use, poses)
    c.note(f"matcher matmul f32 vs gather: max abs diff "
           f"{_max_abs(sm, sg):.3g} on scores up to {np.abs(sg).max():.4g}")
    c.le("matcher_matmul_f32_vs_gather_rel", _rel(sm, sg), SCORE_REL)

    # surface volume: direct conv (HIGHEST) vs FFT path vs float64 NumPy
    thetas = np.linspace(-0.4, 0.4, 25).astype(np.float32)
    wgt = use.astype(np.float32)
    e_stack = on(dev, lambda x, y, w, t: splat_endpoint_kernels(
        x, y, w, t, kc, res), px, py, wgt, thetas)
    direct = on(dev, lambda f, e: scan_surface(f, e, ll_out, fft=False),
                llf, e_stack)
    fft = on(dev, lambda f, e: scan_surface(f, e, ll_out, fft=True),
             llf, e_stack)
    ref_c = correlate_np(llf, e_stack, ll_out)
    c.le("surface_direct_vs_numpy_rel", _rel(direct, ref_c), 1e-3)
    c.le("surface_fft_vs_numpy_rel", _rel(fft, ref_c), 1e-3)
    c.le("surface_direct_vs_fft_rel", _rel(direct, fft), 1e-3)

    # pose-graph normal equations (shared by models/posegraph and
    # parallel/ba) vs float64; one distributed GN step vs posegraph's
    graph = loop_graph(graph_nodes)
    h_d, b_d, _ = on(dev, lambda g: normal_equations(
        g.nodes, g.edge_i, g.edge_j, g.edge_z, g.edge_w), graph)
    e, ji, jj = on(cpu, lambda g: residuals_and_jacobians(
        g.nodes, g.edge_i, g.edge_j, g.edge_z), graph)
    h_r, b_r = normal_equations_np(np.asarray(graph.nodes),
                                   np.asarray(graph.edge_i),
                                   np.asarray(graph.edge_j), e, ji, jj,
                                   np.asarray(graph.edge_w))
    c.le("normal_eqs_H_rel", _rel(h_d, h_r), 1e-5)
    c.le("normal_eqs_b_rel", _rel(b_d, b_r), 1e-5)
    g_dev = jax.device_put(graph, dev)
    pg, _ = optimize(g_dev, iterations=1)
    ba = make_distributed_optimizer(make_mesh(1, devices=[dev]),
                                    iterations=1)
    bg, _ = ba(g_dev)
    c.le("ba_vs_posegraph_step_rel", _rel(bg.nodes, pg.nodes), 1e-5)
    c.done()


def phase_layers(dev, cpu, card: str, particles: int = 500,
                 cells: int = 120, beams: int = 180, trace_dir=None):
    """The RBPF step's layers at parity widths on `dev` against the same
    functions on `cpu` (HIGHEST precision); then one warm parity step
    traced for per-layer device time.  Returns that breakdown or None."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from gridmap_slam_tpu import RBPF, SlamConfig
    from gridmap_slam_tpu.config import MapConfig
    from gridmap_slam_tpu.io import frame_at, frames_to_device, read_recording
    from gridmap_slam_tpu.ops.geometry import deskew_scan, scan_points
    from gridmap_slam_tpu.ops.grid import likelihood_field
    from gridmap_slam_tpu.ops.matcher import (_stage_scores,
                                              log_likelihood_field)
    from gridmap_slam_tpu.ops.raycast import build_beam_lut, integrate_scan

    c = Checks("layers")
    rng = np.random.RandomState(1)
    size = cells * 0.05
    cfg = SlamConfig(num_particles=particles, max_beams=beams,
                     map=MapConfig(width_m=size, height_m=size,
                                   origin=(-size / 2, -size / 2)))
    eng = RBPF(cfg)
    zh, rmax = cfg.matcher.z_hit, cfg.sensor.max_range
    res, origin = cfg.map.resolution, cfg.map.origin
    batch = frames_to_device(read_recording(LOG)[:3], beams, rmax)
    scan = deskew_scan(frame_at(batch, 2).scan, frame_at(batch, 2).odom)
    maps = random_maps(rng, particles, cells)
    poses = np.concatenate([rng.uniform(-0.3, 0.3, (particles, 2)),
                            rng.uniform(-np.pi, np.pi, (particles, 1))],
                           1).astype(np.float32)

    def both(fn, *args):
        with jax.default_matmul_precision("highest"):
            return on(dev, fn, *args), on(cpu, fn, *args)

    def llf_batch(lo):
        def one(m):
            f, u = likelihood_field(m, eng.kernel)
            return log_likelihood_field(f, u, zh, rmax)
        return jax.vmap(one)(lo)

    ll_d, ll_c = both(llf_batch, maps)
    c.le("llfield_gpu_vs_cpu_abs", _max_abs(ll_d, ll_c), 1e-5)
    worst = max(_max_abs(ll_d[i], oracle_llfield(maps[i], zh, rmax))
                for i in range(min(4, particles)))
    c.le("llfield_gpu_vs_oracle_abs", worst, 1e-5)

    px, py = scan_points(scan)
    use = scan.valid & scan.hit
    mc = cfg.matcher
    stride = mc.coarse_beam_stride
    ll_out = math.log(1.0 / rmax)
    wt = math.radians(mc.window_theta_deg)
    c_dxs = np.linspace(-mc.window_xy, mc.window_xy, mc.coarse_nxy
                        ).astype(np.float32)
    c_dts = np.linspace(-wt, wt, mc.coarse_nt).astype(np.float32)
    f_dxs = np.linspace(-0.05, 0.05, mc.fine_nxy).astype(np.float32)
    f_dts = np.linspace(-0.05, 0.05, mc.fine_nt).astype(np.float32)

    def stages(lls, x, y, u, ps):
        def one(f, p):
            # the engine's coarse stage (matcher.coarse_halfres): every
            # `stride`-th beam, bilinear on the 2x2-pooled field
            fe = jnp.pad(f, ((0, f.shape[0] & 1), (0, f.shape[1] & 1)),
                         constant_values=ll_out)
            half = fe.reshape(fe.shape[0] // 2, 2, fe.shape[1] // 2,
                              2).mean((1, 3))
            coarse = _stage_scores(
                half, x[::stride], y[::stride], u[::stride], p, c_dxs,
                c_dxs, c_dts, resolution=2 * res, origin=origin, z_hit=zh,
                max_range=rmax)
            fine = _stage_scores(f, x, y, u, p, f_dxs, f_dxs, f_dts,
                                 resolution=res, origin=origin, z_hit=zh,
                                 max_range=rmax)
            return coarse, fine
        return jax.vmap(one)(lls, ps)

    (co_d, fi_d), (co_c, fi_c) = both(stages, ll_c, px, py, use, poses)
    for stage, got, want in (("coarse", co_d, co_c), ("fine", fi_d, fi_c)):
        c.note(f"matcher {stage} stage: max abs diff "
               f"{_max_abs(got, want):.3g} on scores up to "
               f"{np.abs(want).max():.4g}")
        c.le(f"matcher_{stage}_gpu_vs_cpu_rel", _rel(got, want), SCORE_REL)

    def integrate(lo, ps, s):
        lut = build_beam_lut(s, cfg.beam_lut_bins)
        return jax.vmap(lambda m, p: integrate_scan(
            m, p, s, lut, resolution=res, origin=origin,
            l_free=cfg.sensor.l_free, l_occ=cfg.sensor.l_occ,
            tol_cells=cfg.sensor.hit_tolerance_cells))(lo, ps)

    de_d, de_c = both(integrate, maps, poses, scan)
    diff = np.argwhere(de_d != de_c)
    # transcendentals (atan2, sin, cos, sqrt) are not bit-identical across
    # XLA's CPU and GPU backends, so a cell can flip only where a decision
    # sits within f32 rounding of its threshold; every other cell is exact
    lut = on(cpu, lambda s: build_beam_lut(s, cfg.beam_lut_bins), scan)
    scan_np = jax.tree.map(np.asarray, scan)
    margins = [integrate_margin(scan_np, lut, poses[k], iy, ix, res, origin,
                                cfg.sensor.hit_tolerance_cells)
               for k, iy, ix in diff]
    c.note(f"integrate_scan: {len(diff)} of {de_d.size} cells differ; "
           f"their decision margins (cells or bins): "
           f"{sorted(round(m, 7) for m in margins)[:10]}")
    c.le("integrate_scan_mismatch_fraction", len(diff) / de_d.size, 1e-5)
    c.le("integrate_scan_mismatch_max_margin", max(margins, default=0.0),
         1e-3)

    breakdown = None
    if trace_dir is not None:
        from gridmap_slam_tpu.utils.devtrace import trace_layer_times
        step = jax.jit(eng.step)
        state = eng.init(jax.random.key(0))
        for i in range(2):
            state, _ = step(state, frame_at(batch, i))
        frame = frame_at(batch, 2)
        times = []
        for _ in range(11):
            t0 = time.perf_counter()
            jax.block_until_ready(step(state, frame))
            times.append(time.perf_counter() - t0)
        c.note(f"warm parity step, host clock with block_until_ready: "
               f"median {1e3 * sorted(times[1:])[5]:.3f} ms over 10")
        breakdown = trace_layer_times(step, (state, frame), str(trace_dir))
        total = breakdown["kernel_ns"]
        parts = ", ".join(f"{k} {v / 1e6:.3f} ms ({v / max(total, 1):.1%})"
                          for k, v in breakdown["layers"].items())
        c.note(f"traced parity step ({particles} particles), device "
               f"kernel time {total / 1e6:.3f} ms, busy "
               f"{breakdown['busy_ns'] / 1e6:.3f} ms of a "
               f"{breakdown['span_ns'] / 1e6:.3f} ms span: {parts}; "
               f"card {card}")
        c.note(f"largest unattributed kernels: {breakdown['top_other']}")
        c.true("trace_has_kernels", total > 0,
               f"{total / 1e6:.3f} ms of kernels")
    c.done()
    return breakdown


def phase_replay(name: str, engine_args, out_dir: Path, card: str,
                 log: Path = LOG, ate_bound: float = ATE_BOUND_M):
    """`cli replay` of `log` in this process; checks ATE against the log's
    ground truth and a finite final Neff.  Returns (metrics, trajectory,
    map)."""
    import jax
    import numpy as np
    from gridmap_slam_tpu.app import cli
    from gridmap_slam_tpu.utils.metrics import ate_rmse

    c = Checks(name)
    out = Path(out_dir) / name
    argv = ["replay", "--log", str(log), "--out", str(out),
            "--max-beams", "180", "--seed", "0", *engine_args]
    c.note("cli " + " ".join(argv))
    t0 = time.perf_counter()
    cli.main(argv)
    wall = time.perf_counter() - t0
    metrics = json.loads((out / "replay_metrics.json").read_text())
    traj = np.load(out / "replay_trajectory.npy")
    gt = np.load(log.with_name(log.stem + "_gt.npy"))
    ate = ate_rmse(traj, gt[:len(traj)])
    c.le("ate_m", ate, ate_bound)
    c.true("final_neff_finite", math.isfinite(metrics["final_neff"]),
           f"final_neff={metrics['final_neff']:.6g}")
    stats = jax.devices()[0].memory_stats() or {}
    c.note(f"first_scan_s={metrics['first_scan_s']:.3f} (compile "
           f"included) steady_ms_per_scan={metrics['steady_scan_ms']:.3f} "
           f"scans={metrics['frames']} wall_s={wall:.1f} "
           f"peak_bytes_in_use={stats.get('peak_bytes_in_use')} "
           f"(process peak so far) card={card}")
    c.done()
    return metrics, traj, np.load(out / "replay_map.npy")


def _mesh_run(engine: str, n_dev: int, map_shards: int, particles: int,
              n_frames: int, log: Path = LOG):
    """`n_frames` steps of a map-sharded engine through its own API (as
    tests/test_surface_sharded.py and test_tiled.py drive it).  Returns
    (poses, map, per-scan infos) as NumPy."""
    import jax
    import numpy as np
    from gridmap_slam_tpu import SlamConfig
    from gridmap_slam_tpu.io import frame_at, frames_to_device, read_recording
    from gridmap_slam_tpu.models.shared import SharedMapSLAM
    from gridmap_slam_tpu.parallel.mesh import make_mesh

    cfg = SlamConfig(num_particles=particles, max_beams=180)
    if engine == "tiled":
        from gridmap_slam_tpu.parallel.tiled import init_tiled as init
        from gridmap_slam_tpu.parallel.tiled import make_tiled_step as make
    else:
        from gridmap_slam_tpu.parallel.surface_sharded import (
            init_surface_sharded as init, make_surface_sharded_step as make)
    eng = SharedMapSLAM(cfg)
    mesh = make_mesh(n_dev, map_shards=map_shards)
    state = init(eng, jax.random.key(0), mesh)
    step = make(eng, mesh)
    batch = frames_to_device(read_recording(log)[:n_frames], 180,
                             cfg.sensor.max_range)
    infos = []
    for i in range(n_frames):
        state, info = step(state, frame_at(batch, i))
        infos.append(jax.tree.map(np.asarray, info))
    return np.asarray(state.poses), np.asarray(state.logodds), infos


def phase_four(out_dir: Path, card: str, surface_particles: int = 1_000_000,
               tiled_particles: int = 500, n_frames: int = 3,
               log: Path = LOG, ate_bound: float = ATE_BOUND_M):
    """The map-sharded engines on a (p, m) = (2, 2) mesh of four devices:
    (a) against the same engine on (2, 1) — identical RNG layout over 'p',
    so only the map sharding differs — for `n_frames` scans at the tests'
    tolerances; (b) through the CLI over the whole log against their
    single-device counterparts, with the ATE bound."""
    import numpy as np

    for engine, single, particles in (
            ("surface-sharded", "surface", surface_particles),
            ("tiled", "shared", tiled_particles)):
        tag = engine.replace("-", "_")
        c = Checks(f"four_{tag}_vs_unsharded_map")
        p4, m4, i4 = _mesh_run(engine, 4, 2, particles, n_frames, log)
        p2, m2, i2 = _mesh_run(engine, 2, 1, particles, n_frames, log)
        for k, (a, b) in enumerate(zip(i2, i4)):
            c.le(f"scan{k}_neff_rel", abs(float(b.neff) - float(a.neff))
                 / max(abs(float(a.neff)), 1e-30), 1e-3)
            c.le(f"scan{k}_weighted_pose_abs",
                 _max_abs(b.weighted_pose, a.weighted_pose), 2e-3)
        c.le("map_abs", _max_abs(m4, m2), 1e-3)
        # float noise in the weights moves resampling boundaries past
        # systematic draws, so some particles take a neighbouring ancestor
        # (more at more particles); the cloud is compared by its spread
        far = np.abs(p4 - p2).max(axis=1) > 2e-3
        c.note(f"particles off by > 2e-3: {int(far.sum())} of {len(far)}")
        c.le("cloud_std_abs", _max_abs(p4.std(axis=0), p2.std(axis=0)),
             2e-3)
        c.done()

        args = ["--particles", str(particles)]
        _, tr4, m4 = phase_replay(
            f"four_{tag}", ["--engine", engine, "--devices", "4",
                            "--map-shards", "2", *args],
            out_dir, card, log, ate_bound)
        _, tr1, m1 = phase_replay(f"four_{tag}_single",
                                  ["--engine", single, *args], out_dir,
                                  card, log, ate_bound)
        # Different RNG layouts over 'p': the runs agree only as two
        # filters that both meet the ATE bound (checked above).  Their
        # maps must agree on the cells both observed.
        c = Checks(f"four_{tag}_vs_{single}")
        rms = float(np.sqrt(np.mean(np.sum((tr4[:, :2] - tr1[:, :2]) ** 2,
                                           axis=1))))
        c.note(f"trajectory rms difference {rms:.4f} m")
        seen = (m4 != 0) & (m1 != 0)
        agree = float(np.mean(np.sign(m4[seen]) == np.sign(m1[seen])))
        c.ge("map_sign_agreement_on_cells_both_observed", agree, 0.9)
        c.done()


# ---------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the map-sharded engines on four GPUs")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "chip_smoke"),
                    help="directory for replay outputs and the trace")
    args = ap.parse_args(argv)

    import jax

    from gridmap_slam_tpu.utils.compile_cache import enable_compile_cache

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: JAX sees no GPU (only {devs[0].platform} "
              f"devices); nothing was run", file=sys.stderr)
        return 2
    enable_compile_cache()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    cpu = jax.devices("cpu")[0]
    dev = devs[0]

    card = phase_device(4 if args.four else 1)
    if args.four:
        phase_four(out, card)
    else:
        phase_precision(dev, cpu)
        phase_layers(dev, cpu, card, trace_dir=out / "trace")
        phase_replay("parity", PARITY_ARGS, out, card)
        phase_replay("surface1m", SURFACE_ARGS, out, card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
