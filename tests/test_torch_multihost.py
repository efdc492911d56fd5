"""Two-process test of the port's meshes: ``init_multihost`` joins a gloo
world of real processes, and the mesh collectives, ``sharded_spectrum``,
the sharded telemetry step (with dp and then sp across the processes) and
``tp_fft`` run across the process boundary, each checked against the
single-process result (tests/_torch_multihost_worker.py; the counterpart
of tests/test_multihost.py). Each worker has its own timeout, so a hang
fails the test instead of stalling the suite."""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_mesh_collectives_and_sharded_step():
    coord = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "tests._torch_multihost_worker",
             coord, "2", str(pid)],
            cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multi-process workers timed out:\n"
                    + "\n".join(o or "" for o in outs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert f"proc {pid}: OK" in out
        for layout in ("dp", "sp"):
            assert (f"proc {pid}: sharded step with {layout} across "
                    "processes bit-equal") in out
