"""Command-line application: replay, live SLAM, synthetic data generation.

The accelerator-side equivalent of the reference's desktop app shell
(core/Main2 + app/GridMapApp): wires a data source (recording, synthetic
world, or live robot link) into the SLAM engine and emits
maps/trajectories/metrics — .npy + JSON, plus PNG renders when matplotlib
is installed, instead of an OpenGL window.  The engine runs on whatever
platform JAX picks (JAX_PLATFORMS); the CLI never switches it.

Usage:
  python -m gridmap_slam_tpu.app.cli replay --log maps/rec1 --out out/
  python -m gridmap_slam_tpu.app.cli synth --revs 40 --out out/ --save-log r.rec
  python -m gridmap_slam_tpu.app.cli live --host esp32robot.local --scans 30
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def _render(name: str, path, data, **kwargs) -> None:
    """Write a PNG with utils.viz.<name>(data, path, **kwargs), or say on
    stderr that it was skipped when matplotlib is not installed."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print(f"matplotlib not installed: skipped {path}", file=sys.stderr)
        return
    from ..utils import viz
    getattr(viz, name)(data, path, **kwargs)


class _MeshEngine:
    """CLI adapter exposing a distributed shard_map engine through the
    single-device engine interface `_run_frames` consumes (.step / .init /
    .best_map).  The mesh spans every visible device unless --devices
    caps it; map tiles go on 'm' (--map-shards), particles on 'p'."""

    def __init__(self, base, mesh, step_fn, init_fn):
        self.config = base.config
        self._base, self._mesh, self._init = base, mesh, init_fn
        self.step = step_fn

    def init(self, key):
        return self._init(self._base, key, self._mesh)

    def best_map(self, state):
        return self._base.best_map(state)


def _engine(args):
    import jax
    from .. import RBPF, SlamConfig
    from ..config import MapConfig

    cfg = SlamConfig(
        num_particles=args.particles,
        max_beams=args.max_beams,
        particle_chunk=args.chunk,
        map=MapConfig(width_m=args.map_size, height_m=args.map_size,
                      resolution=args.resolution,
                      origin=(-args.map_size / 2, -args.map_size / 2)),
    )
    if getattr(args, "set", None):
        cfg = cfg.with_overrides(SlamConfig.parse_overrides(args.set))
    engine = getattr(args, "engine", "rbpf")
    if engine in ("shared", "surface"):
        from ..models.shared import SharedMapSLAM
        eng = SharedMapSLAM(cfg)
        if engine == "surface":
            # route the generic step() through the surface-volume update
            eng.step = eng.step_surface
    elif engine in ("shmap", "shmap-surface", "tiled", "surface-sharded"):
        # distributed engines: explicit-collective shard_map steps over a
        # ('p', 'm') device mesh (multi-host runs initialize
        # parallel/dcn.py first; single host uses all local devices)
        from ..models.shared import SharedMapSLAM
        from ..parallel.mesh import make_mesh
        n_dev = getattr(args, "devices", 0) or len(jax.devices())
        m_sh = getattr(args, "map_shards", 1)
        base = SharedMapSLAM(cfg)
        mesh = make_mesh(n_dev, map_shards=m_sh if engine in
                         ("tiled", "surface-sharded") else 1)
        if engine == "tiled":
            from ..parallel.tiled import init_tiled, make_tiled_step
            eng = _MeshEngine(base, mesh, make_tiled_step(base, mesh),
                              init_tiled)
        elif engine == "surface-sharded":
            from ..parallel.surface_sharded import (
                init_surface_sharded, make_surface_sharded_step)
            eng = _MeshEngine(base, mesh,
                              make_surface_sharded_step(base, mesh),
                              init_surface_sharded)
        else:
            from ..parallel.shmap import init_shmap, make_shmap_step
            eng = _MeshEngine(
                base, mesh,
                make_shmap_step(base, mesh,
                                surface=(engine == "shmap-surface")),
                init_shmap)
    else:
        eng = RBPF(cfg)
    state = eng.init(jax.random.key(args.seed))
    return cfg, eng, state


def _run_frames(cfg, eng, state, frames, out_dir: Path, gt=None,
                label: str = "replay", live_view=None,
                map_view: str = "occupancy", map_select: str = "best",
                save_map=None):
    import jax
    from ..io import frames_to_device, frame_at
    from ..utils.metrics import ScanTimer, ate_rmse

    from ..ops.geometry import deskew_scan
    from ..ops.motion import apply_odometry

    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range)
    step = jax.jit(eng.step)
    deskew = jax.jit(deskew_scan)
    traj = []
    neffs = []
    timer = ScanTimer()
    last_scan = last_raw = None
    for i in range(len(frames)):
        frame = frame_at(batch, i)
        # raw (uncorrected) pose: previous estimate advanced by odometry
        # alone — the reference's blue scan overlay baseline
        # (app/GridMapApp.java:396-412)
        prev = traj[-1] if traj else np.zeros(3)
        last_raw = np.asarray(apply_odometry(jax.numpy.asarray(prev),
                                             frame.odom))
        with timer:
            state, info = step(state, frame)
            jax.block_until_ready(info.weighted_pose)
        traj.append(np.asarray(info.weighted_pose))
        neffs.append(float(info.neff))
        last_scan = deskew(frame.scan, frame.odom)
        if live_view is not None:
            live_view.update(np.asarray(eng.best_map(state)), traj[-1],
                             np.asarray(state.poses), info.neff,
                             scan=last_scan, raw_pose=last_raw)
    if live_view is not None:
        live_view.finish()
    traj = np.stack(traj)

    out_dir.mkdir(parents=True, exist_ok=True)
    metrics = {
        "frames": len(frames),
        "mean_scan_ms": timer.mean_ms,
        "scans_per_sec": timer.scans_per_sec(),
        # the first scan includes compilation; the rest are steady state
        "first_scan_s": timer.times[0] if timer.times else None,
        "steady_scan_ms": (1e3 * float(np.median(timer.times[1:]))
                           if len(timer.times) > 1 else None),
        "final_neff": neffs[-1] if neffs else None,
        "final_pose": traj[-1].tolist() if len(traj) else None,
    }
    if gt is not None:
        metrics["ate_rmse_m"] = ate_rmse(traj, gt)
    np.save(out_dir / f"{label}_trajectory.npy", traj)

    _dump_maps(cfg, eng, state, out_dir, label, traj, gt,
               map_view=map_view, map_select=map_select,
               scan=last_scan, raw_pose=last_raw)
    if save_map:
        from ..io import write_map_checkpoint
        write_map_checkpoint(
            save_map,
            {"width_m": cfg.map.width_m, "height_m": cfg.map.height_m,
             "resolution": cfg.map.resolution, "origin": cfg.map.origin},
            np.asarray(eng.best_map(state), np.float64))
        print(f"map checkpoint -> {save_map}", file=sys.stderr)
    (out_dir / f"{label}_metrics.json").write_text(json.dumps(metrics,
                                                              indent=2))
    print(json.dumps(metrics))
    return state, traj, metrics


def _dump_maps(cfg, eng, state, out_dir: Path, label: str, traj, gt,
               map_view: str = "occupancy", map_select: str = "best",
               scan=None, raw_pose=None):
    """Final map artifact(s) — the reference's map-type (occupancy /
    likelihood) and map-select (strongest / combined) views
    (app/GridMapApp.java:246-320): the selected log-odds map as .npy, and
    as PNG when matplotlib is installed."""
    if map_select == "combined" and hasattr(eng, "combined_occupancy"):
        p = np.asarray(eng.combined_occupancy(state))
        m = np.log(np.clip(p, 1e-6, 1 - 1e-6) /
                   np.clip(1 - p, 1e-6, 1.0))     # back to log-odds for viz
    elif map_select not in ("best", "combined"):
        # specific-particle view (reference map-select "specific",
        # app/GridMapApp.java:246-320); rbpf engine only.
        try:
            i = int(map_select)
        except ValueError:
            sys.exit(f"--map-select must be 'best', 'combined', or a "
                     f"particle index; got {map_select!r}")
        if state.logodds.ndim != 3:
            sys.exit("--map-select <index> requires the rbpf engine "
                     "(per-particle maps)")
        if not (0 <= i < state.logodds.shape[0]):
            sys.exit(f"--map-select {i} out of range "
                     f"(0..{state.logodds.shape[0] - 1})")
        m = np.asarray(state.logodds[i])
    else:
        m = np.asarray(eng.best_map(state))
    np.save(out_dir / f"{label}_map.npy", m)
    _render("render_map", out_dir / f"{label}_map.png", m, trajectory=traj,
            ground_truth=gt, particles=np.asarray(state.poses),
            origin=cfg.map.origin, resolution=cfg.map.resolution,
            title=f"{label}: {len(traj)} scans ({map_select})",
            scan=scan, scan_pose=traj[-1] if len(traj) else None,
            raw_pose=raw_pose)
    if map_view == "likelihood":
        import jax.numpy as jnp
        from ..ops.grid import likelihood_field
        field, _ = likelihood_field(jnp.asarray(m), eng.kernel)
        _render("render_likelihood", out_dir / f"{label}_likelihood.png",
                np.asarray(field), origin=cfg.map.origin,
                resolution=cfg.map.resolution)


def _make_view(args, cfg):
    if not getattr(args, "view", False):
        return None
    from ..utils.liveview import TerminalMapView
    return TerminalMapView(cfg.map.origin, cfg.map.resolution, force=True)


def cmd_replay(args):
    from ..io import read_recording

    frames = read_recording(args.log)
    cfg, eng, state = _engine(args)
    if args.load_map:
        # Start every particle from a previously-built map checkpoint
        # (reference GridMapLoader, slam/GridMapLoader.java:105-135):
        # localization-in-known-map / checkpoint-resume mapping.
        import jax
        from ..io import read_map_checkpoint
        if not hasattr(eng, "init_from_map"):
            sys.exit("--load-map requires the rbpf engine")
        params, logodds = read_map_checkpoint(args.load_map)
        # A checkpoint with different geometry but coincidentally matching
        # cell counts would load silently and misalign all localization —
        # validate every geometry param against the engine config.
        mismatches = [
            (name, have, want)
            for name, have, want in [
                ("resolution", params["resolution"], cfg.map.resolution),
                ("width_m", params["width_m"], cfg.map.width_m),
                ("height_m", params["height_m"], cfg.map.height_m),
                ("origin_x", params["origin"][0], cfg.map.origin[0]),
                ("origin_y", params["origin"][1], cfg.map.origin[1]),
            ] if abs(have - want) > 1e-5
        ]
        if mismatches:
            detail = ", ".join(f"{n}: checkpoint={h:g} config={w:g}"
                               for n, h, w in mismatches)
            sys.exit(f"--load-map geometry mismatch ({detail}); rerun with "
                     f"--map-size/--resolution matching the checkpoint")
        state = eng.init_from_map(jax.random.key(args.seed), logodds)
        print(f"loaded map checkpoint {args.load_map} {logodds.shape}",
              file=sys.stderr)
    _run_frames(cfg, eng, state, frames, Path(args.out), label="replay",
                live_view=_make_view(args, cfg),
                map_view=args.map_view, map_select=args.map_select,
                save_map=args.save_map)


def cmd_synth(args):
    from ..io import write_recording
    from ..io.synthetic import (SimParams, default_world, multi_room_world,
                                simulate_log, square_path_controls)

    world = (multi_room_world() if args.world == "multi_room"
             else default_world())
    params = SimParams(beams_per_rev=args.beams)
    frames, gt = simulate_log(world, square_path_controls(args.revs),
                              params=params, seed=args.seed)
    if args.save_log:
        write_recording(args.save_log, frames)
        print(f"wrote {args.save_log}", file=sys.stderr)
    cfg, eng, state = _engine(args)
    _run_frames(cfg, eng, state, frames, Path(args.out), gt=gt, label="synth",
                live_view=_make_view(args, cfg),
                map_view=args.map_view, map_select=args.map_select)


def cmd_live(args):
    """Live operation: SLAM runs ON EACH FRAME as it arrives (the reference
    processes one TimeFrame per render frame, app/GridMapApp.java:215-217),
    with an in-terminal map/pose/particle view and optional recording."""
    from .application import SlamApplication
    from .pipeline import RobotLink, SlamPipeline
    from .recorder import DataRecorder

    if args.serial:
        link = RobotLink.connect_serial(args.serial, args.baud)
    else:
        link = RobotLink.connect(args.host, args.port)
    link.set_resolution(args.degrees)
    link.sensor_enable()
    pipe = SlamPipeline(link)
    collected = []
    cfg, eng, state = _engine(args)
    # The reference IApplication lifecycle (app/application.py): one SLAM
    # update per arriving frame + a view refresh per tick.
    app = SlamApplication(cfg, eng, view=_make_view(args, cfg))
    app.init(seed=args.seed, state=state)

    def on_frame(f):
        collected.append(f)
        app.on_frame(f)
        app.render()

    pipe.subscribe(on_frame)
    rec = DataRecorder(lambda f: None, directory=args.out)
    if args.record:
        rec.begin_record()
        pipe.subscribe(rec.on_frame)
    pipe.start()
    t0 = time.monotonic()
    teleop = keys = None
    if args.teleop:
        # Operator drive loop (reference teleop panel,
        # conn/ConnectionManager.java:143-215): WASD/arrows -> wheel-speed
        # refs via command 0x10; space stops, q ends the session early.
        from .teleop import StdinKeys, TeleopController
        teleop = TeleopController(link.set_speeds, speed=args.speed)
        keys = StdinKeys()
        keys.__enter__()
        print("teleop: WASD/arrows drive, space stops, +/- trims speed, "
              "q quits", file=sys.stderr)
    try:
        while len(collected) < args.scans:
            pipe.handle_events(4)     # subscribers run on THIS thread
            rec.update(time.monotonic() - t0 - rec.current_time)
            if teleop is not None:
                for k in keys.poll():
                    if not teleop.handle(k):
                        raise KeyboardInterrupt
            time.sleep(0.01)
    except KeyboardInterrupt:
        pass
    finally:
        if teleop is not None:
            teleop.stop()
            keys.__exit__(None, None, None)
        app.dispose()
        link.sensor_disable()
        pipe.stop()
        link.close()
    if args.record:
        path = rec.save(args.record)
        print(f"recorded {len(rec.frames)} frames -> {path}", file=sys.stderr)

    # final artifacts (map PNG, metrics) for the session just run
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    tr = app.trajectory_array()
    np.save(out_dir / "live_trajectory.npy", tr)
    _render("render_map", out_dir / "live_map.png", app.occupancy(),
            trajectory=tr, particles=np.asarray(app.state.poses),
            origin=cfg.map.origin, resolution=cfg.map.resolution,
            title=f"live: {len(collected)} scans")
    print(json.dumps({"frames": len(collected),
                      "final_pose": tr[-1].tolist() if len(tr) else None}))


def cmd_posegraph(args):
    """SLAM a log, promote keyframes, close loops, optimize, rebuild —
    emits both the online map and the loop-corrected map."""
    import jax
    from ..io import read_recording, frames_to_device, frame_at
    from ..io.synthetic import (SimParams, default_world, simulate_log,
                                square_path_controls)
    from ..models.frontend import FrontendConfig, PoseGraphSLAM
    from ..ops.geometry import deskew_scan

    if args.log:
        frames = read_recording(args.log)
        gt = None
    else:
        frames, gt = simulate_log(default_world(),
                                  square_path_controls(args.revs),
                                  params=SimParams(beams_per_rev=args.beams),
                                  seed=args.seed)
    cfg, eng, state = _engine(args)
    out_dir = Path(args.out)
    state, traj, metrics = _run_frames(cfg, eng, state, frames, out_dir,
                                       gt=gt, label="pg_online")

    fe = PoseGraphSLAM(cfg, FrontendConfig())
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range)
    for i, pose in enumerate(traj):
        f = frame_at(batch, i)
        fe.add(pose, deskew_scan(f.scan, f.odom))
    n_closures = fe.detect_closures()
    opt, chi2 = fe.optimize()
    rebuilt = fe.rebuild_map()
    np.save(out_dir / "pg_optimized_map.npy", np.asarray(rebuilt))
    _render("render_map", out_dir / "pg_optimized_map.png",
            np.asarray(rebuilt), trajectory=opt, ground_truth=gt,
            origin=cfg.map.origin, resolution=cfg.map.resolution,
            title=f"pose-graph: {fe.num_keyframes} keyframes, "
                  f"{n_closures} closures")
    summary = {"keyframes": fe.num_keyframes, "closures": n_closures,
               "chi2_first": float(chi2[0]), "chi2_last": float(chi2[-1])}
    if gt is not None:
        from ..utils.metrics import ate_rmse
        kf_gt = None  # keyframe-wise gt not tracked; report trajectory ATE
        summary["online_ate_m"] = metrics.get("ate_rmse_m")
    print(json.dumps(summary))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="gridmap_slam_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--particles", type=int, default=100)
        p.add_argument("--engine",
                       choices=["rbpf", "shared", "surface", "shmap",
                                "shmap-surface", "tiled",
                                "surface-sharded"],
                       default="rbpf",
                       help="rbpf: per-particle maps (reference parity); "
                            "shared: single shared map, 16 B/particle; "
                            "surface: shared map + per-scan likelihood "
                            "volume (~8 taps/particle — the 1M mode); "
                            "shmap/shmap-surface: explicit-collective "
                            "distributed step, particles over 'p'; "
                            "tiled: + map columns over 'm' (per-particle "
                            "matcher); surface-sharded: the 1M surface "
                            "mode composed with map sharding")
        p.add_argument("--devices", type=int, default=0,
                       help="devices in the mesh (0 = all visible; "
                            "distributed engines only)")
        p.add_argument("--map-shards", type=int, default=1,
                       help="map-column shards 'm' for tiled / "
                            "surface-sharded (must divide --devices)")
        p.add_argument("--max-beams", type=int, default=360)
        p.add_argument("--chunk", type=int, default=0)
        p.add_argument("--map-size", type=float, default=6.0)
        p.add_argument("--resolution", type=float, default=0.05)
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--out", default="out")
        p.add_argument("--set", action="append", default=[],
                       metavar="KEY=VALUE",
                       help="config override, e.g. --set matcher.z_hit=0.95")
        p.add_argument("--view", action="store_true",
                       help="live terminal map view while processing "
                            "(reference GridMapApp render loop equivalent)")
        p.add_argument("--map-view", choices=["occupancy", "likelihood"],
                       default="occupancy",
                       help="also dump the likelihood-field view "
                            "(reference map-type selector)")
        p.add_argument("--map-select", default="best", metavar="WHICH",
                       help="'best' (strongest particle), 'combined' "
                            "(cell-wise 1 - prod(1-p_i)), or a particle "
                            "index for that specific particle's map "
                            "(reference map-select, GridMapApp.java:246-320)")

    p = sub.add_parser("replay", help="replay a recording file")
    common(p)
    p.add_argument("--log", required=True)
    p.add_argument("--save-map", default=None,
                   help="write the strongest particle's map as a reference-"
                        "format map checkpoint after the run")
    p.add_argument("--load-map", default=None,
                   help="initialize all particles from a map checkpoint "
                        "(localization in a known map)")
    p.set_defaults(fn=cmd_replay)

    p = sub.add_parser("synth", help="synthetic world run")
    common(p)
    p.add_argument("--revs", type=int, default=40)
    p.add_argument("--beams", type=int, default=180)
    p.add_argument("--world", choices=["default", "multi_room"],
                   default="default")
    p.add_argument("--save-log", default=None)
    p.set_defaults(fn=cmd_synth)

    p = sub.add_parser("posegraph",
                       help="SLAM + keyframes + loop closure + optimize")
    common(p)
    p.add_argument("--log", default=None,
                   help="recording to process (default: synthetic loop)")
    p.add_argument("--revs", type=int, default=40)
    p.add_argument("--beams", type=int, default=180)
    p.set_defaults(fn=cmd_posegraph)

    p = sub.add_parser("live", help="connect to a robot (or loopback sim)")
    common(p)
    p.add_argument("--host", default="esp32robot.local")
    p.add_argument("--port", type=int, default=5555)
    p.add_argument("--serial", default=None, metavar="PORT",
                   help="use a serial port instead of TCP "
                        "(e.g. /dev/ttyUSB0)")
    p.add_argument("--baud", type=int, default=115200)
    p.add_argument("--degrees", type=int, default=2)
    p.add_argument("--scans", type=int, default=20)
    p.add_argument("--record", default=None,
                   help="also save the received frames under this name")
    p.add_argument("--teleop", action="store_true",
                   help="interactive keyboard drive (WASD/arrows; the "
                        "reference's ImGui teleop panel equivalent)")
    p.add_argument("--speed", type=float, default=5.0,
                   help="teleop wheel-speed magnitude, rad/s")
    p.set_defaults(fn=cmd_live)

    args = ap.parse_args(argv)
    # Fail invalid --map-select at PARSE time, not after a full replay:
    # a specific-particle index needs per-particle maps (rbpf engine), and
    # the index must parse as an int (range check still happens against the
    # live state in _dump_maps).
    ms = getattr(args, "map_select", "best")
    if ms not in ("best", "combined"):
        try:
            int(ms)
        except ValueError:
            ap.error(f"--map-select must be 'best', 'combined', or a "
                     f"particle index; got {ms!r}")
        if getattr(args, "engine", "rbpf") != "rbpf":
            ap.error("--map-select <index> requires --engine rbpf "
                     "(per-particle maps); shared/surface engines keep one "
                     "shared map")
    from ..utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
