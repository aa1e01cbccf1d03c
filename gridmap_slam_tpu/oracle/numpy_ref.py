"""NumPy oracle: a faithful, scalar reimplementation of the reference SLAM
math, used as ground truth in unit tests and as the single-thread CPU baseline
proxy in benchmarks (the reference itself is Java and not runnable here).

Semantics follow the reference (file:line cited per function); this is NOT the
engine's path — it is deliberately written the way the Java code works (per-beam
DDA walks, dense double precision) so the vectorized JAX ops can be validated
against it.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

# Inverse sensor model constants (slam/SensorModel.java:20-25).
SENSOR_MAX_RANGE = 10.0
P_FREE = 0.30
P_OCCUPIED = 0.90
P_PRIOR = 0.50


def log_odds(p: float) -> float:
    return math.log(p / (1.0 - p))


def inv_log_odds(l: np.ndarray) -> np.ndarray:
    return 1.0 - 1.0 / (1.0 + np.exp(l))


def inverse_sensor_model(current: float, measured: float, was_hit: bool,
                         tol: float = 2.0) -> float:
    """slam/SensorModel.java:31-41 (distances in cell units)."""
    if not was_hit:
        return P_FREE if current < measured else P_PRIOR
    if current < measured - tol / 2.0:
        return P_FREE
    if current > measured + tol / 2.0:
        return P_PRIOR
    return P_OCCUPIED


def ray_cells(x0: float, y0: float, x1: float, y1: float,
              additional_steps: int, width: int, height: int
              ) -> List[Tuple[int, int]]:
    """Amanatides/Woo-style integer grid traversal from (x0,y0) to (x1,y1) in
    grid coordinates, with bounds clipping and extra trailing steps
    (slam/RayIterator.java:65-130)."""
    dx = abs(x1 - x0)
    dy = abs(y1 - y0)
    x = int(math.floor(x0))
    y = int(math.floor(y0))
    n = 1 + additional_steps
    if dx == 0:
        x_inc = 0
        error = math.inf
    elif x1 > x0:
        x_inc = 1
        n += int(math.floor(x1)) - x
        error = (math.floor(x0) + 1 - x0) * dy
    else:
        x_inc = -1
        n += x - int(math.floor(x1))
        error = (x0 - math.floor(x0)) * dy
    if dy == 0:
        y_inc = 0
        error -= math.inf
    elif y1 > y0:
        y_inc = 1
        n += int(math.floor(y1)) - y
        error -= (math.floor(y0) + 1 - y0) * dx
    else:
        y_inc = -1
        n += y - int(math.floor(y1))
        error -= (y0 - math.floor(y0)) * dx

    cells = []
    while n > 0 and not (x < 0 or x >= width or y < 0 or y >= height):
        cells.append((x, y))
        if error > 0:
            y += y_inc
            error -= dx
        else:
            x += x_inc
            error += dy
        n -= 1
    return cells


class OracleGridMap:
    """Reference GridMap semantics (slam/GridMap.java) on NumPy arrays.

    logodds is (H, W) indexed [y, x]; world origin at `origin` (lower-left)."""

    def __init__(self, width_m=6.0, height_m=6.0, resolution=0.05,
                 origin=(-3.0, -3.0)):
        self.res = resolution
        self.origin = origin
        self.w = int(math.ceil(width_m / resolution))
        self.h = int(math.ceil(height_m / resolution))
        sigma = math.sqrt(0.05 / resolution)
        radius = int(math.ceil(sigma * 3))
        x = np.arange(-radius, radius + 1, dtype=np.float64)
        k = np.exp(-(x * x) / (2 * sigma * sigma)) / (np.sqrt(2 * np.pi) * sigma)
        self.kernel = k / k.sum()
        self.z_hit = 0.9

    def new_map(self) -> np.ndarray:
        return np.zeros((self.h, self.w), np.float64)

    # -- integration (slam/GridMap.java:173-228) -------------------------
    def integrate(self, logodds: np.ndarray, pose, angles, dists, hits):
        c, s = math.cos(pose[2]), math.sin(pose[2])
        sx = (pose[0] - self.origin[0]) / self.res
        sy = (pose[1] - self.origin[1]) / self.res
        for a, d, hit in zip(angles, dists, hits):
            lx, ly = d * math.cos(a), d * math.sin(a)
            wx = lx * c - ly * s + pose[0]
            wy = lx * s + ly * c + pose[1]
            ex = (wx - self.origin[0]) / self.res
            ey = (wy - self.origin[1]) / self.res
            md = d / self.res
            for (cx, cy) in ray_cells(sx + 0.5, sy + 0.5, ex + 0.5, ey + 0.5,
                                      2, self.w, self.h):
                dx = sx - (cx + 0.5)
                dy = sy - (cy + 0.5)
                dist = math.sqrt(dx * dx + dy * dy)
                logodds[cy, cx] += log_odds(
                    inverse_sensor_model(dist, md, hit, 2.0))
        return logodds

    # -- likelihood field (slam/GridMap.java:233-250, app/Util.java:378) --
    def likelihood(self, logodds: np.ndarray) -> np.ndarray:
        p = np.where(logodds > 0, 1.0, np.where(logodds < 0, 0.0, 0.5))
        k = len(self.kernel) // 2
        h = np.zeros_like(p)
        for i, kv in enumerate(self.kernel):
            off = i - k
            lo, hi = max(0, -off), min(self.w, self.w - off)
            h[:, lo:hi] += kv * p[:, lo + off:hi + off]
        out = np.zeros_like(p)
        for i, kv in enumerate(self.kernel):
            off = i - k
            lo, hi = max(0, -off), min(self.h, self.h - off)
            out[lo:hi, :] += kv * h[lo + off:hi + off, :]
        return out

    # -- measurement likelihood (slam/GridMap.java:261-294) --------------
    def probability_of(self, field: np.ndarray, pose, angles, dists, hits,
                      skip_out_of_map: bool = True) -> float:
        c, s = math.cos(pose[2]), math.sin(pose[2])
        product = 1.0
        for a, d, hit in zip(angles, dists, hits):
            if not hit:
                continue
            lx, ly = d * math.cos(a), d * math.sin(a)
            wx = lx * c - ly * s + pose[0]
            wy = lx * s + ly * c + pose[1]
            gx = int(math.floor((wx - self.origin[0]) / self.res))
            gy = int(math.floor((wy - self.origin[1]) / self.res))
            if gx < 0 or gy < 0 or gx >= self.w or gy >= self.h:
                if not skip_out_of_map:
                    product *= 1.0 / SENSOR_MAX_RANGE
                continue
            val = field[gy, gx]
            if val == 0.5:
                product *= 1.0 / SENSOR_MAX_RANGE
            else:
                product *= self.z_hit * val + (1 - self.z_hit) / SENSOR_MAX_RANGE
        return product

    # -- brute-force matcher (slam/GridMap.java:319-346) -----------------
    def find_best_pose(self, field, angles, dists, hits, start_pose,
                       span_xy=0.20, span_t=math.radians(15.0),
                       step_xy=0.04, n_theta=10):
        best = tuple(start_pose)
        best_p = 0.0
        step_t = span_t / (n_theta / 2)
        dx = -span_xy
        while dx < span_xy:
            dy = -span_xy
            while dy < span_xy:
                dt = -span_t
                while dt < span_t:
                    p = (start_pose[0] + dx, start_pose[1] + dy,
                         start_pose[2] + dt)
                    prob = self.probability_of(field, p, angles, dists, hits)
                    if prob > best_p:
                        best_p = prob
                        best = p
                    dt += step_t
                dy += step_xy
            dx += step_xy
        return best, best_p


def deskew(angles, dists, hits, d_center, d_theta):
    """Motion-distortion correction (app/GridMapApp.java:144-175)."""
    n = len(angles)
    out_a = np.empty(n)
    out_d = np.empty(n)
    for i in range(n):
        d_i = -(n - i) / n
        xa = dists[i] * math.cos(angles[i] + d_theta * d_i) + d_center * d_i
        ya = dists[i] * math.sin(angles[i] + d_theta * d_i)
        out_a[i] = math.atan2(ya, xa)
        out_d[i] = math.hypot(xa, ya)
    return out_a, out_d, np.asarray(hits, bool)


def sample_motion(rng: np.random.RandomState, pose, d_center, d_theta):
    """slam/Odometry.java:60-96."""
    sd_c = (0.01 + abs(d_center) * 0.05) / 2.0
    sd_t = math.radians(5.0) + 0.1 * abs(d_theta)
    d = rng.normal(d_center, sd_c)
    th = rng.normal(d_theta, sd_t)
    theta = pose[2] + th
    theta = math.atan2(math.sin(theta), math.cos(theta))
    return (pose[0] + math.cos(theta) * d, pose[1] + math.sin(theta) * d, theta)


def systematic_resample(rng: np.random.RandomState, weights: np.ndarray
                        ) -> np.ndarray:
    """slam/SLAM.java:133-153 low-variance resampler indices."""
    n = len(weights)
    w = weights / weights.sum()
    r = rng.uniform(0.0, 1.0 / n)
    c = w[0]
    i = 0
    out = np.empty(n, np.int64)
    for m in range(n):
        u = r + m / n
        while u > c:
            i += 1
            c += w[i]
        out[m] = i
    return out


class OracleSLAM:
    """Full reference SLAM loop on NumPy (slam/SLAM.java:80-131), used as the
    behavioral baseline for ATE comparison and as the single-thread
    scans/sec baseline proxy."""

    def __init__(self, num_particles=30, gm: OracleGridMap | None = None,
                 seed=0, use_brute_force_matcher=True):
        self.gm = gm or OracleGridMap()
        self.n = num_particles
        self.rng = np.random.RandomState(seed)
        self.poses = [(0.0, 0.0, 0.0)] * num_particles
        self.maps = [self.gm.new_map() for _ in range(num_particles)]
        self.weights = np.full(num_particles, 1.0 / num_particles)
        self.matcher = use_brute_force_matcher

    def update(self, angles, dists, hits, d_center, d_theta):
        angles, dists, hits = deskew(angles, dists, hits, d_center, d_theta)
        skip = abs(d_theta) > math.radians(30.0)
        weights = np.empty(self.n)
        for i in range(self.n):
            pose = sample_motion(self.rng, self.poses[i], d_center, d_theta)
            field = self.gm.likelihood(self.maps[i])
            if self.matcher:
                pose, _ = self.gm.find_best_pose(field, angles, dists, hits,
                                                 pose)
            weights[i] = self.gm.probability_of(field, pose, angles, dists,
                                                hits)
            if not skip:
                self.gm.integrate(self.maps[i], pose, angles, dists, hits)
            self.poses[i] = pose
        self.weights = weights / weights.sum()
        neff = 1.0 / np.sum(self.weights ** 2)
        if neff < self.n / 2:
            idx = systematic_resample(self.rng, self.weights)
            self.poses = [self.poses[j] for j in idx]
            self.maps = [self.maps[j].copy() for j in idx]
            self.weights = self.weights[idx]
        return neff

    def weighted_pose(self):
        w = self.weights / self.weights.sum()
        x = sum(p[0] * wi for p, wi in zip(self.poses, w))
        y = sum(p[1] * wi for p, wi in zip(self.poses, w))
        t = sum(math.atan2(math.sin(p[2]), math.cos(p[2])) * wi
                for p, wi in zip(self.poses, w))
        return (x, y, t)
