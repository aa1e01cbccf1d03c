"""bench.py ladder plumbing, on the CPU (no measurement runs here).

The ladder's final stdout line is what a benchmark reader parses, so its
failure modes are tested explicitly: per-rung errors must not kill the
child, the parent must stream best-so-far lines, the global deadline must
kill a hung child and still exit 0 with a parseable line, and a measurement
without a GPU must fail.
"""

import contextlib
import io
import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench


def test_parse_override():
    assert bench._parse_override("a.b=3") == ("a.b", 3)
    assert bench._parse_override("a.b=3.5") == ("a.b", 3.5)
    assert bench._parse_override("a.b=false") == ("a.b", False)
    assert bench._parse_override("a.b=auto") == ("a.b", "auto")


def test_measure_refuses_without_gpu():
    """A measurement on the CPU backend is an error, not a CPU number."""
    args = bench.build_parser().parse_args(["--preset", "parity"])
    with pytest.raises(SystemExit, match="GPU"):
        bench.measure(args)


def test_run_rungs_isolates_rung_errors(monkeypatch):
    def fake_measure(args):
        if args.preset == "city":
            raise RuntimeError("boom")
        p = 500 if args.preset == "parity" else 1000000
        return ({"metric": f"lidar_scans_per_sec_per_chip@{p}p",
                 "value": 5.0}, {})

    monkeypatch.setattr(bench, "measure", fake_measure)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.run_rungs(["parity", "mega_surface", "city_surface"], 180)
    lines = [ln for ln in buf.getvalue().splitlines() if ln]
    assert len(lines) == 3 and all(ln.startswith("RUNG ") for ln in lines)
    parsed = [json.loads(ln[5:]) for ln in lines]
    assert parsed[0]["scans_per_sec"] == 5.0
    assert "boom" in parsed[2]["error"]


def _run_parent_with_fake_child(tmp_path, monkeypatch, child_src,
                                deadline="20"):
    fake = tmp_path / "fakebench.py"
    fake.write_text(child_src)
    monkeypatch.setitem(bench.__dict__, "__file__", str(fake))
    monkeypatch.setenv("GRIDMAP_BENCH_DEADLINE", deadline)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.run_ladder(180)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    return rc, [json.loads(ln) for ln in lines]


def test_ladder_parent_streams_and_deadline_kills(tmp_path, monkeypatch):
    child = """
import json, time
print("RUNG " + json.dumps({"name": "parity", "particles": 500,
                            "scans_per_sec": 21.8, "wall_s": 0.1}),
      flush=True)
print("RUNG " + json.dumps({"name": "mega_surface", "particles": 1000000,
                            "scans_per_sec": 4.5, "wall_s": 0.1}),
      flush=True)
time.sleep(600)
"""
    rc, results = _run_parent_with_fake_child(tmp_path, monkeypatch, child,
                                              deadline="20")
    assert rc == 0
    last = results[-1]
    # best-so-far = highest particle count completed
    assert last["value"] == 4.5
    assert "1000000p" in last["metric"]
    assert last["baseline_oracle_scans_per_sec"] is not None
    assert last["rungs"]["city_surface"]["error"].startswith("killed")


def test_ladder_parent_no_results_still_parseable(tmp_path, monkeypatch):
    rc, results = _run_parent_with_fake_child(
        tmp_path, monkeypatch, "import time\ntime.sleep(600)\n",
        deadline="18")
    # a fully-failed ladder run exits nonzero (round-3 ADVICE) but its
    # final stdout line is still the parseable best-so-far JSON
    assert rc == 1
    last = results[-1]
    assert last["value"] is None
    assert last["error"] == "no ladder rung completed"
