"""2-process jax.distributed (DCN path) smoke test: two CPU processes of 4
virtual devices each form one 8-device world; the tiled shard_map step runs
with cross-process collectives and both processes agree on the replicated
outputs (VERDICT r1 #7; parallel/dcn.py)."""

import os
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.timeout(600)
def test_two_process_distributed_tiled_step():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "scripts", "dcn_worker.py")
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"

    procs = [subprocess.Popen(
        [sys.executable, worker, str(i), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=root) for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"worker failed:\n{err[-2000:]}"
        outs.append(out)

    lines = [next(ln for ln in o.splitlines() if ln.startswith("DCN_OK"))
             for o in outs]
    # replicated Neff / weighted pose must be identical across processes
    vals = [ln.split("pid=")[1].split(" ", 1)[1] for ln in lines]
    assert vals[0] == vals[1], lines
