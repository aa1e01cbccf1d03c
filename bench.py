"""Benchmark harness: LiDAR scans/sec on one GPU for the SLAM engine.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N}

Baselines (the reference publishes no numbers, BASELINE.md):
  (a) MEASURED: the NumPy oracle port of the reference per-particle math on
      this host (oracle/numpy_ref.py), timed once and cached in
      docs/bench/oracle_baseline.json, scaled 1/P to the benchmarked
      particle count;
  (b) ASSUMED: a deliberately generous 1.0 scans/s for the single-threaded
      Java implementation at its own 500 particles, scaled 1/P.
vs_baseline divides by the LARGER of the two (the harder comparison).

Default mode (no args) runs the benchmark LADDER: one child process runs
the rungs sequentially (single runtime attach), streaming a result line
per rung; the parent re-prints the best-so-far result line after EVERY
rung and always exits 0 before GRIDMAP_BENCH_DEADLINE (default 1500 s) —
a truncated or deadline-hit run still leaves a complete, parseable last
line.

Every measurement needs a GPU: with no GPU visible to JAX it exits with an
error instead of timing the CPU.

Usage:
  python bench.py                                   # ladder
  python bench.py --preset parity --marginal        # one rung
  python bench.py --particles 10000 --frames 20
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ORACLE_CACHE = Path(__file__).parent / "docs" / "bench" / "oracle_baseline.json"


def build_log(n_frames: int, beams: int, seed: int = 0):
    from gridmap_slam_tpu.io.synthetic import (SimParams, default_world,
                                               simulate_log,
                                               square_path_controls)
    params = SimParams(beams_per_rev=beams)
    return simulate_log(default_world(), square_path_controls(n_frames),
                        params=params, seed=seed)


# --------------------------------------------------------------- baselines
def oracle_baseline(n_particles: int) -> tuple[float | None, int | None]:
    """Oracle (reference-math proxy) scans/sec at n_particles, from the
    cached one-off measurement (docs/bench/oracle_baseline.json) scaled
    linearly in particle count; measures a quick 50-particle probe and
    writes the cache if absent.  Returns (scans_per_sec, probe_particles).
    """
    if ORACLE_CACHE.exists():
        d = json.loads(ORACLE_CACHE.read_text())
    else:
        d = measure_oracle(probe_particles=50, n_frames=3)
        ORACLE_CACHE.parent.mkdir(parents=True, exist_ok=True)
        ORACLE_CACHE.write_text(json.dumps(d, indent=2))
    sps = d["scans_per_sec"] * d["probe_particles"] / n_particles
    return sps, d["probe_particles"]


def measure_oracle(probe_particles: int, n_frames: int = 3) -> dict:
    """Time the NumPy oracle at `probe_particles` on a synthetic log."""
    from gridmap_slam_tpu.oracle.numpy_ref import OracleSLAM
    frames, _ = build_log(max(n_frames + 1, 2), 180)
    o = OracleSLAM(num_particles=probe_particles)
    f = frames[0]
    o.update(f.angle, f.dist, f.hit, f.d_center, f.d_theta)   # warm
    t0 = time.perf_counter()
    timed = frames[1:1 + n_frames]
    for f in timed:
        o.update(f.angle, f.dist, f.hit, f.d_center, f.d_theta)
    dt = (time.perf_counter() - t0) / len(timed)
    return {"scans_per_sec": 1.0 / dt, "probe_particles": probe_particles,
            "timed_scans": len(timed), "host": os.uname().nodename}


def result_line(sps: float, n_particles: int, skip_oracle: bool) -> dict:
    java_assumed = 1.0 * 500.0 / n_particles
    if skip_oracle:
        oracle_sps, probe = None, None
    else:
        oracle_sps, probe = oracle_baseline(n_particles)
    baseline = max(java_assumed, oracle_sps or 0.0)
    return {
        "metric": f"lidar_scans_per_sec_per_chip@{n_particles}p",
        "value": round(sps, 3),
        "unit": "scans/s",
        "vs_baseline": round(sps / baseline, 2),
        "baseline_oracle_scans_per_sec":
            round(oracle_sps, 6) if oracle_sps else None,
        "baseline_oracle_probe_particles": probe,
        "baseline_oracle_extrapolated":
            (probe is not None and probe != n_particles) or None,
        "baseline_java_assumed_scans_per_sec": round(java_assumed, 4),
    }


# ---------------------------------------------------------------- engines
def _parse_override(kv: str):
    key, _, raw = kv.partition("=")
    for cast in (int, float):
        try:
            return key, cast(raw)
        except ValueError:
            pass
    if raw.lower() in ("true", "false"):
        return key, raw.lower() == "true"
    return key, raw


def make_engine(n_particles: int, chunk: int, map_size: float, mode: str,
                crop: int = 0, resolution: float = 0.05,
                refine_steps: int = -1, overrides: list[str] = ()):
    """mode: 'rbpf' (per-particle maps) | 'shared' (shared map, per-particle
    matcher) | 'surface' (shared map, precomputed likelihood volume)."""
    from gridmap_slam_tpu import RBPF, SlamConfig
    from gridmap_slam_tpu.config import MapConfig

    cfg = SlamConfig(num_particles=n_particles, max_beams=192,
                     particle_chunk=chunk,
                     map=MapConfig(width_m=map_size, height_m=map_size,
                                   resolution=resolution,
                                   origin=(-map_size / 2, -map_size / 2)))
    if crop:
        cfg = cfg.with_overrides({"matcher.surface_crop_cells": crop})
    if refine_steps >= 0:
        cfg = cfg.with_overrides({"matcher.surface_refine_steps":
                                  refine_steps})
    if overrides:
        cfg = cfg.with_overrides(dict(_parse_override(kv)
                                      for kv in overrides))
    if mode in ("shared", "surface"):
        from gridmap_slam_tpu.models.shared import SharedMapSLAM
        eng = SharedMapSLAM(cfg)
        replay = (eng.replay_surface_jit() if mode == "surface"
                  else eng.replay_jit())
    else:
        eng = RBPF(cfg)
        replay = eng.replay_jit()
    return cfg, eng, replay


def _resolved_matcher_impl(cfg, eng, mode: str) -> str:
    """The matcher implementation this run actually uses (rung JSONs must
    be reproducible without the narrative docs).
    Surface mode has no per-particle matcher; the other engines resolve
    through ops/matcher.resolve_impl."""
    from gridmap_slam_tpu.ops.matcher import resolve_impl
    if mode == "surface":
        return "surface-volume"
    return resolve_impl(cfg.matcher.impl)


def _rung_meta(cfg, eng, mode: str, n_scans: int, timing: str) -> dict:
    """Self-containedness keys every rung JSON carries."""
    return {
        "n_scans": n_scans,
        "timing": timing,
        "mode": mode,
        "matcher_impl": _resolved_matcher_impl(cfg, eng, mode),
        "surface_weight_temp": cfg.matcher.surface_weight_temp,
        "resample_fraction": cfg.resample_fraction,
        "particle_chunk": cfg.particle_chunk,
        "map_cells": [cfg.map.cells_y, cfg.map.cells_x],
        "surface_crop_cells": cfg.matcher.surface_crop_cells,
        "surface_refine_steps": cfg.matcher.surface_refine_steps,
    }


def time_engine(frames, n_particles: int, chunk: int, map_size: float = 6.0,
                mode: str = "rbpf", crop: int = 0, refine_steps: int = -1,
                overrides=(), gt=None) -> tuple[float, dict]:
    import jax
    import jax.numpy as jnp
    from gridmap_slam_tpu.io import frames_to_device

    cfg, eng, replay = make_engine(n_particles, chunk, map_size, mode, crop,
                                   refine_steps=refine_steps,
                                   overrides=overrides)
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range)
    n = len(frames)

    def run(state):
        """Replay the whole log in one lax.scan dispatch."""
        return replay(state, batch)

    state, infos = run(eng.init(jax.random.key(0)))
    jax.block_until_ready(state)
    neff_last = float(infos.neff[-1])

    min_time, max_reps = 2.0, 50
    reps = 0
    t0 = time.perf_counter()
    while True:
        state0 = eng.init(jax.random.key(reps))
        state, infos = run(state0)
        jax.block_until_ready(state)
        reps += 1
        if time.perf_counter() - t0 >= min_time or reps >= max_reps:
            break
    dt = (time.perf_counter() - t0) / (n * reps)
    wpose = infos.weighted_pose[-1]
    extra = {
        "platform": jax.devices()[0].platform,
        "device": str(jax.devices()[0]),
        "neff": neff_last,
        "final_weighted_pose": [round(float(v), 4) for v in wpose],
        "pose_dispersion_m": round(float(jnp.std(state.poses[:, :2])), 4),
        "ms_per_scan": 1e3 * dt,
        "timed_reps": reps,
        "frames_per_run": n,
        **_rung_meta(cfg, eng, mode, n, "wall"),
    }
    if gt is not None:
        from gridmap_slam_tpu.utils.metrics import ate_rmse
        import numpy as _np
        extra["ate_m"] = round(
            ate_rmse(_np.asarray(infos.weighted_pose), gt[:n]), 4)
    return 1.0 / dt, extra


def time_engine_marginal(frames, n_particles: int, chunk: int,
                         map_size: float = 6.0, mode: str = "rbpf",
                         crop: int = 0, refine_steps: int = -1,
                         k: int = 3, reps: int = 8,
                         overrides=(), gt=None) -> tuple[float, dict]:
    """On-device per-scan rate with the fixed per-dispatch cost cancelled.

    Every replay pays a fixed cost (dispatch, argument transfer, the final
    synchronisation) that is not per-scan work.  Measure two
    SINGLE-dispatch replays — the log once and tiled k times — at
    identical dispatch counts; the time difference over the extra frames is
    the marginal on-device per-scan cost."""
    import statistics

    import jax
    import jax.numpy as jnp
    from gridmap_slam_tpu.io import frames_to_device

    cfg, eng, replay = make_engine(n_particles, chunk, map_size, mode, crop,
                                   refine_steps=refine_steps,
                                   overrides=overrides)
    b1 = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range)
    bk = jax.tree.map(lambda a: jnp.concatenate([a] * k, axis=0), b1)
    n = len(frames)

    def timed(batch, n_reps=reps):
        ts = []
        for r in range(n_reps + 1):
            s0 = eng.init(jax.random.key(r))
            jax.block_until_ready(s0)
            t0 = time.perf_counter()
            s, _ = replay(s0, batch)
            jax.block_until_ready(s)
            if r > 0:
                ts.append(time.perf_counter() - t0)
        return statistics.median(ts), statistics.pstdev(ts)

    t1, sd1 = timed(b1)
    tk, sdk = timed(bk)
    per_scan = max(tk - t1, 1e-9) / ((k - 1) * n)
    # Liveness signals alongside the throughput number (no rung ships
    # scans/s without them): final Neff, weighted pose,
    # and particle-cloud dispersion from one extra replay of the log.
    s, infos = replay(eng.init(jax.random.key(0)), b1)
    wpose = infos.weighted_pose[-1]
    extra = {
        "platform": jax.devices()[0].platform,
        "device": str(jax.devices()[0]),
        "ms_per_scan_marginal": 1e3 * per_scan,
        "dispatch_overhead_s": round(t1 - n * per_scan, 3),
        "dispatch_jitter_ms": round(1e3 * max(sd1, sdk), 1),
        "frames_short": n, "frames_long": k * n,
        **_rung_meta(cfg, eng, mode, n, "marginal"),
        "neff": float(infos.neff[-1]),
        "final_weighted_pose": [round(float(v), 4) for v in wpose],
        "pose_dispersion_m": round(float(jnp.std(s.poses[:, :2])), 4),
    }
    if gt is not None:
        from gridmap_slam_tpu.utils.metrics import ate_rmse
        import numpy as _np
        extra["ate_m"] = round(
            ate_rmse(_np.asarray(infos.weighted_pose), gt[:n]), 4)
    return 1.0 / per_scan, extra


# ----------------------------------------------------------------- ladder
# (name, particles, child argv, env overrides).
LADDER = [
    # the out-of-the-box parity configuration (impl='auto' = gather)
    ("parity", 500, ["--preset", "parity", "--marginal"], {}),
    ("mega_surface", 1_000_000, ["--preset", "mega"], {}),
    ("city_surface", 1_000_000, ["--preset", "city"], {}),
    # the one-hot matmul matcher on the same configuration
    ("parity_matmul", 500, ["--preset", "parity", "--marginal",
                            "--set", "matcher.impl=matmul"], {}),
]


def run_rungs(names: list[str], beams: int) -> None:
    """Child mode (--rungs): run the named ladder rungs SEQUENTIALLY in this
    one process — the only process that holds the GPU, with one runtime
    start-up and a shared in-process compile cache.  Prints one
    'RUNG {json}' line per rung, flushed immediately, so the parent can
    harvest results as they land."""
    by_name = {name: (argv, env) for name, _, argv, env in LADDER}
    parser = build_parser()
    for name in names:
        rung_argv, rung_env = by_name[name]
        argv = rung_argv + ["--beams", str(beams), "--skip-oracle",
                            "--reps", "3"]
        t0 = time.perf_counter()
        saved = {k: os.environ.get(k) for k in rung_env}
        os.environ.update(rung_env)
        try:
            result, extra = measure(parser.parse_args(argv))
            out = {"name": name, "particles": int(
                result["metric"].split("@")[1][:-1]),
                "scans_per_sec": result["value"],
                "wall_s": round(time.perf_counter() - t0, 1)}
            # liveness signals + self-containedness keys (a reader can
            # reproduce a rung from its JSON alone)
            for key in ("neff", "final_weighted_pose", "pose_dispersion_m",
                        "ate_m", "n_scans", "timing", "mode",
                        "matcher_impl", "surface_weight_temp",
                        "resample_fraction", "particle_chunk", "map_cells",
                        "surface_crop_cells", "surface_refine_steps"):
                if key in extra:
                    out[key] = extra[key]
        except Exception as e:  # noqa: BLE001 — a faulted rung must not
            out = {"name": name,  # take down the remaining rungs
                   "error": repr(e)[:300],
                   "wall_s": round(time.perf_counter() - t0, 1)}
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        print("RUNG " + json.dumps(out), flush=True)


def run_ladder(beams: int) -> int:
    """Parent mode (default): spawn ONE child running every ladder rung,
    stream its per-rung result lines, and re-print the best-so-far JSON
    line after each — bounded by a GLOBAL deadline (GRIDMAP_BENCH_DEADLINE
    seconds, default 1500).  The driver that invokes `python bench.py`
    kills it after an unpublished budget and only parses the final JSON
    line when the process exits cleanly, so this parent exits on its own
    before the deadline: the child is killed and the best-so-far line
    stands.  The parent never imports JAX, so the child is the one process
    on the GPU."""
    import subprocess
    import threading

    deadline = float(os.environ.get("GRIDMAP_BENCH_DEADLINE", "1500"))
    t_start = time.perf_counter()
    env = dict(os.environ)
    best = None          # (particles, sps)
    rungs = {name: {"error": "not reached"} for name, *_ in LADDER}
    particles_of = {name: p for name, p, *_ in LADDER}

    def emit():
        if best is None:
            line = {"metric": "lidar_scans_per_sec_per_chip",
                    "value": None, "unit": "scans/s",
                    "vs_baseline": None, "rungs": rungs,
                    "error": "no ladder rung completed"}
            print(json.dumps(line), flush=True)
            return
        line = result_line(best[1], best[0], skip_oracle=False)
        line["rungs"] = rungs
        print(json.dumps(line), flush=True)

    cmd = [sys.executable, os.path.abspath(__file__), "--beams", str(beams),
           "--rungs", ",".join(name for name, *_ in LADDER)]
    child = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                             env=env, bufsize=1)
    lines: list[str] = []
    lock = threading.Lock()

    def reader():
        for raw in child.stdout:
            with lock:
                lines.append(raw)

    th = threading.Thread(target=reader, daemon=True)
    th.start()

    done = 0

    def process(raw: str):
        nonlocal best, done
        if not raw.startswith("RUNG "):
            return
        r = json.loads(raw[5:])
        name = r.pop("name")
        rungs[name] = r
        done += 1
        if "scans_per_sec" in r:
            p = particles_of[name]
            print(f"ladder: {name}: {r['scans_per_sec']} scans/s "
                  f"@{p}p ({r['wall_s']}s)", file=sys.stderr)
            # headline = highest particle count; among equal counts the
            # FASTEST rung (city at 1M must not displace mega's number)
            if (best is None or p > best[0]
                    or (p == best[0] and r["scans_per_sec"] > best[1])):
                best = (p, r["scans_per_sec"])
        else:
            print(f"ladder: {name}: {r.get('error')}", file=sys.stderr)
        emit()

    while True:
        with lock:
            new, lines[:] = lines[:], []
        for raw in new:
            process(raw)
        if done >= len(LADDER) or child.poll() is not None:
            break
        if time.perf_counter() - t_start > deadline - 15.0:
            child.kill()
            for name in rungs:
                if rungs[name] == {"error": "not reached"}:
                    rungs[name] = {"error": "killed: global deadline"}
            print("ladder: global deadline — child killed", file=sys.stderr)
            break
        time.sleep(1.0)
    # Final drain: the loop can break on child.poll() with RUNG lines still
    # in the pipe (typically the LAST rung's result).  Join the reader at
    # stdout EOF and process anything it buffered before the final emit.
    th.join(timeout=30.0)
    with lock:
        new, lines[:] = lines[:], []
    for raw in new:
        process(raw)
    emit()
    # rc=1 when NOTHING completed: a fully-failed run must not look like a
    # (partially) successful one.  The driver's parseable-line path still
    # sees the final JSON (value null) on stdout either way.
    return 0 if best is not None else 1


# ------------------------------------------------------------------- main
def require_gpu():
    """Refuse to measure anywhere but on a GPU (JAX falls back to the CPU,
    with only a warning, when its CUDA plugin fails to load); sets up the
    compile cache on the way."""
    import jax
    from gridmap_slam_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures on a GPU; JAX sees "
                         f"{dev.platform} ({dev.device_kind})")


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=None)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--beams", type=int, default=180)
    ap.add_argument("--chunk", type=int, default=2048)
    ap.add_argument("--map-size", type=float, default=6.0)
    ap.add_argument("--shared-map", action="store_true",
                    help="shared-map mode, per-particle matcher")
    ap.add_argument("--surface", action="store_true",
                    help="shared-map SURFACE mode: per-scan likelihood "
                         "volume, ~8 taps/particle (models/shared."
                         "step_surface) — the 1M-particle mode")
    ap.add_argument("--crop", type=int, default=0,
                    help="surface-volume crop in cells (0 = full map)")
    ap.add_argument("--refine-steps", type=int, default=-1,
                    help="surface hill-climb steps override (-1 = config "
                         "default; 0 = pure MCL weighting, fewest taps)")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                    dest="overrides",
                    help="dotted-key SlamConfig override, e.g. "
                         "--set matcher.matmul_bf16=false (repeatable)")
    ap.add_argument("--skip-oracle", action="store_true")
    ap.add_argument("--marginal", action="store_true")
    ap.add_argument("--measure-oracle", type=int, default=0, metavar="P",
                    help="measure the oracle baseline at P particles, "
                         "write docs/bench/oracle_baseline.json, exit")
    ap.add_argument("--preset",
                    choices=["parity", "pr1", "chip", "mega", "city"],
                    default=None,
                    help="parity: 500p/6m RBPF; pr1: 100p/20m; chip: 10k "
                         "RBPF; mega: 1M surface/6m; city: 1M surface "
                         "200x200 m crop 512 (BASELINE 3)")
    ap.add_argument("--reps", type=int, default=8,
                    help="timing repetitions for --marginal")
    ap.add_argument("--rungs", default=None, metavar="NAME,NAME",
                    help="(ladder child) run these LADDER rungs "
                         "sequentially in one process")
    return ap


def measure(args) -> tuple[dict, dict]:
    """Run ONE configured measurement; returns (result_line, extra)."""
    require_gpu()
    if args.preset == "parity":
        args.particles, args.map_size, args.chunk = 500, 6.0, 250
    elif args.preset == "pr1":
        args.particles, args.map_size, args.chunk = 100, 20.0, 0
    elif args.preset == "chip":
        args.particles, args.map_size, args.chunk = 10_000, 6.0, 500
    elif args.preset == "mega":
        args.particles, args.map_size, args.chunk = 1_000_000, 6.0, 0
        args.surface = True
        args.marginal = True
        args.frames = min(args.frames, 4)
        if args.refine_steps < 0:
            # 1M particles cover the posterior by density; hill-climb taps
            # are the dominant cost at this scale (random-gather bound)
            args.refine_steps = 0
    elif args.preset == "city":
        args.particles, args.map_size, args.chunk = 1_000_000, 200.0, 0
        args.surface = True
        args.crop = args.crop or 512
        args.marginal = True
        args.frames = min(args.frames, 4)

    if args.particles is None:
        args.particles = 10_000

    frames, gt = build_log(args.frames, args.beams)
    mode = ("surface" if args.surface
            else "shared" if args.shared_map else "rbpf")

    if args.marginal:
        sps, extra = time_engine_marginal(frames, args.particles, args.chunk,
                                          map_size=args.map_size, mode=mode,
                                          crop=args.crop,
                                          refine_steps=args.refine_steps,
                                          reps=args.reps,
                                          overrides=args.overrides, gt=gt)
    else:
        sps, extra = time_engine(frames, args.particles, args.chunk,
                                 map_size=args.map_size, mode=mode,
                                 crop=args.crop,
                                 refine_steps=args.refine_steps,
                                 overrides=args.overrides, gt=gt)

    return result_line(sps, args.particles, args.skip_oracle), extra


def main():
    args = build_parser().parse_args()

    if args.measure_oracle:
        d = measure_oracle(args.measure_oracle)
        ORACLE_CACHE.parent.mkdir(parents=True, exist_ok=True)
        ORACLE_CACHE.write_text(json.dumps(d, indent=2))
        print(json.dumps(d))
        return

    if args.rungs:
        run_rungs(args.rungs.split(","), args.beams)
        return

    if args.particles is None and args.preset is None:
        sys.exit(run_ladder(args.beams))

    result, extra = measure(args)
    print(json.dumps(extra), file=sys.stderr)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
