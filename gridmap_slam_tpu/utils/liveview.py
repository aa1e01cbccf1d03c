"""Live terminal visualization of SLAM state while scans stream in.

The reference renders map/particles/scan overlays every frame in an OpenGL
window (app/GridMapApp.java:215-433).  The equivalent surface here is a
terminal: an ANSI half-block rendering of the occupancy grid with the pose,
particle cloud, and per-scan stats, redrawn in place as frames arrive, plus
optional periodic PNG snapshots (utils/viz.render_map) for headless runs.

No dependencies beyond numpy; degrades to a one-line status ticker when
stdout is not a TTY.
"""

from __future__ import annotations

import sys
import time
from typing import Optional

import numpy as np

# Unicode lower-half block: one char cell = two map rows (fg = top row,
# bg = bottom row), so an 80x40 map fits in 80x20 characters.
_HALF = "▄"
_RESET = "\x1b[0m"


def _gray(p: float) -> int:
    """Occupancy probability -> xterm-256 grayscale index (232..255),
    white=free, black=occupied, mid-gray=unknown."""
    v = int(round((1.0 - p) * 23))
    return 232 + max(0, min(23, v))


class TerminalMapView:
    """Redraw-in-place map view.  Call update() once per processed scan."""

    def __init__(self, origin, resolution: float, *, max_cols: int = 96,
                 max_rows: int = 56, stream=None, force: Optional[bool] = None):
        self.origin = (float(origin[0]), float(origin[1]))
        self.resolution = float(resolution)
        self.max_cols = max_cols
        self.max_rows = max_rows            # map rows (2 per char row)
        self.stream = stream or sys.stdout
        isatty = getattr(self.stream, "isatty", lambda: False)()
        self.enabled = isatty if force is None else force
        self._frame = 0
        self._t0 = time.monotonic()
        self._lines_drawn = 0

    # ------------------------------------------------------------------ core
    def _downsample(self, prob: np.ndarray) -> tuple[np.ndarray, int]:
        """Block-reduce to fit the terminal budget; occupied wins over free
        within a block (walls must not vanish when zoomed out)."""
        h, w = prob.shape
        step = max(1, (h + self.max_rows - 1) // self.max_rows,
                   (w + self.max_cols - 1) // self.max_cols)
        if step > 1:
            hh = (h // step) * step
            ww = (w // step) * step
            blocks = prob[:hh, :ww].reshape(hh // step, step,
                                            ww // step, step)
            known_hi = blocks.max(axis=(1, 3))
            known_lo = blocks.min(axis=(1, 3))
            # occupied (p>0.6) dominates, then free (p<0.4), else unknown
            prob = np.where(known_hi > 0.6, known_hi,
                            np.where(known_lo < 0.4, known_lo, 0.5))
        return prob, step

    def render(self, logodds: np.ndarray, pose=None, particles=None,
               info_line: str = "", scan=None, raw_pose=None) -> str:
        prob = 1.0 - 1.0 / (1.0 + np.exp(np.asarray(logodds, np.float64)))
        prob, step = self._downsample(prob)
        h, w = prob.shape
        res = self.resolution * step

        def to_cell(xy):
            cx = int((xy[0] - self.origin[0]) / res)
            cy = int((xy[1] - self.origin[1]) / res)
            return cx, cy

        overlay = {}
        if scan is not None and raw_pose is not None:
            # raw (uncorrected-odometry) beam endpoints, reference blue
            for ex, ey in self._endpoints(scan, raw_pose)[0]:
                overlay[to_cell((ex, ey))] = ("\x1b[94m", "·")
        if scan is not None and pose is not None:
            # corrected endpoints: green hit / red miss (GridMapApp:396-412)
            pts, hits = self._endpoints(scan, pose)
            for (ex, ey), hh in zip(pts, hits):
                overlay[to_cell((ex, ey))] = (
                    "\x1b[92m" if hh else "\x1b[91m", "x")
        if particles is not None:
            for p in np.asarray(particles)[:512]:
                overlay[to_cell(p)] = ("\x1b[36m", "+")       # cyan cloud
        if pose is not None:
            arrows = "→↗↑↖←↙↓↘"
            k = int(round(float(pose[2]) / (np.pi / 4))) % 8
            overlay[to_cell(pose)] = ("\x1b[91m", arrows[k])  # red robot

        rows = []
        for y in range(h - (h % 2) - 2, -1, -2):              # top-down pairs
            parts = []
            for x in range(w):
                top = overlay.get((x, y + 1))
                bot = overlay.get((x, y))
                if top or bot:
                    color, ch = top or bot
                    parts.append(f"{color}{ch}{_RESET}")
                    continue
                fg = _gray(prob[y + 1, x])
                bg = _gray(prob[y, x])
                parts.append(f"\x1b[38;5;{fg}m\x1b[48;5;{bg}m{_HALF}")
            rows.append("".join(parts) + _RESET)
        rows.append(info_line)
        return "\n".join(rows)

    @staticmethod
    def _endpoints(scan, pose):
        ang = np.asarray(scan.angle, np.float64)
        dist = np.asarray(scan.dist, np.float64)
        valid = np.asarray(scan.valid, bool)
        hit = np.asarray(scan.hit, bool)[valid]
        ang, dist = ang[valid], dist[valid]
        x, y, th = float(pose[0]), float(pose[1]), float(pose[2])
        pts = np.stack([x + dist * np.cos(th + ang),
                        y + dist * np.sin(th + ang)], -1)
        return pts, hit

    def update(self, logodds, pose=None, particles=None, neff=None,
               scan=None, raw_pose=None) -> None:
        self._frame += 1
        dt = time.monotonic() - self._t0
        sps = self._frame / dt if dt > 0 else 0.0
        info = (f"scan {self._frame}  {sps:5.1f} scans/s"
                + (f"  Neff {float(neff):6.1f}" if neff is not None else "")
                + (f"  pose ({float(pose[0]):+.2f}, {float(pose[1]):+.2f}, "
                   f"{float(pose[2]):+.2f})" if pose is not None else ""))
        if not self.enabled:
            print("\r" + info, end="", file=self.stream, flush=True)
            return
        frame = self.render(logodds, pose, particles, info, scan=scan,
                            raw_pose=raw_pose)
        if self._lines_drawn:
            self.stream.write(f"\x1b[{self._lines_drawn}F")   # cursor up
        self.stream.write(frame + "\n")
        self.stream.flush()
        self._lines_drawn = frame.count("\n") + 1

    def finish(self) -> None:
        if not self.enabled:
            print("", file=self.stream)
