"""Offline visualization: PNG dumps of maps, trajectories, particle clouds.

Replaces the reference's live OpenGL/ImGui rendering (L6/L0 layers,
app/GridMapApp.java:215-433, graphics/*) with headless matplotlib exports —
the appropriate surface for an accelerator-side engine.  matplotlib is
optional: the CLI skips these renders when it is not installed.
"""

from __future__ import annotations

import numpy as np


def _beam_segments(scan, pose):
    """(N, 2, 2) world-frame beam segments + hit mask for a scan at pose.

    scan provides angle/dist/hit/valid arrays (types.Scan or any
    namespace of numpy-convertibles)."""
    ang = np.asarray(scan.angle, np.float64)
    dist = np.asarray(scan.dist, np.float64)
    hit = np.asarray(scan.hit, bool)
    valid = np.asarray(scan.valid, bool)
    ang = ang[valid]
    dist = dist[valid]
    hit = hit[valid]
    x, y, th = float(pose[0]), float(pose[1]), float(pose[2])
    ex = x + dist * np.cos(th + ang)
    ey = y + dist * np.sin(th + ang)
    segs = np.stack([np.broadcast_to([x, y], (len(ex), 2)),
                     np.stack([ex, ey], -1)], axis=1)
    return segs, hit


def draw_scan_rays(ax, scan, pose, raw_pose=None) -> None:
    """Scan-ray overlay, reference colors (app/GridMapApp.java:396-412):
    corrected beams green (hit) / red (miss) from the SLAM pose, raw beams
    blue from the uncorrected odometry pose."""
    from matplotlib.collections import LineCollection

    if raw_pose is not None:
        segs, _ = _beam_segments(scan, raw_pose)
        ax.add_collection(LineCollection(segs, colors="tab:blue", lw=0.3,
                                         alpha=0.35, label="raw scan"))
    segs, hit = _beam_segments(scan, pose)
    if hit.any():
        ax.add_collection(LineCollection(segs[hit], colors="tab:green",
                                         lw=0.4, alpha=0.6,
                                         label="scan (hit)"))
    if (~hit).any():
        ax.add_collection(LineCollection(segs[~hit], colors="tab:red",
                                         lw=0.4, alpha=0.45,
                                         label="scan (miss)"))


def render_map(logodds: np.ndarray, path: str, trajectory=None,
               ground_truth=None, particles=None, origin=(-3.0, -3.0),
               resolution: float = 0.05, title: str = "",
               scan=None, scan_pose=None, raw_pose=None) -> None:
    """Save an occupancy-map PNG.  logodds: (H, W); trajectories are (T, >=2)
    world-coordinate arrays; particles is (P, >=2); scan + scan_pose
    (+ raw_pose) add the reference's scan-ray overlay."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    lo = np.asarray(logodds, np.float64)
    prob = 1.0 - 1.0 / (1.0 + np.exp(lo))
    h, w = prob.shape
    extent = (origin[0], origin[0] + w * resolution,
              origin[1], origin[1] + h * resolution)
    fig, ax = plt.subplots(figsize=(7, 7))
    ax.imshow(1.0 - prob, cmap="gray", origin="lower", extent=extent,
              vmin=0.0, vmax=1.0, interpolation="nearest")
    if particles is not None:
        p = np.asarray(particles)
        ax.plot(p[:, 0], p[:, 1], ".", ms=2, color="tab:cyan", alpha=0.5,
                label="particles")
    if ground_truth is not None:
        g = np.asarray(ground_truth)
        ax.plot(g[:, 0], g[:, 1], "-", color="tab:green", lw=1.5,
                label="ground truth")
    if trajectory is not None:
        t = np.asarray(trajectory)
        ax.plot(t[:, 0], t[:, 1], "-", color="tab:red", lw=1.2,
                label="estimate")
    if scan is not None and scan_pose is not None:
        draw_scan_rays(ax, scan, scan_pose, raw_pose=raw_pose)
    if trajectory is not None or ground_truth is not None or particles is not None:
        ax.legend(loc="upper right", fontsize=8)
    ax.set_title(title)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)


def render_likelihood(field: np.ndarray, path: str, origin=(-3.0, -3.0),
                      resolution: float = 0.05) -> None:
    """Save a likelihood-field PNG (reference 'likelihood' map view,
    app/GridMapApp.java map-type selector)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    f = np.asarray(field, np.float64)
    h, w = f.shape
    extent = (origin[0], origin[0] + w * resolution,
              origin[1], origin[1] + h * resolution)
    fig, ax = plt.subplots(figsize=(7, 7))
    im = ax.imshow(f, cmap="viridis", origin="lower", extent=extent,
                   interpolation="nearest")
    fig.colorbar(im, ax=ax, shrink=0.8)
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
