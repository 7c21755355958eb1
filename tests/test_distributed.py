"""2-process jax.distributed runtime test (SURVEY.md P8).

Spawns two REAL processes, each with 4 virtual CPU devices, connected by a
jax.distributed coordinator -- the same topology as two hosts of cards
(the reference has no distributed backend at all; rayon is shared-memory
only, reference: Cargo.toml:21).  Verifies a cross-process psum over the
hybrid [proc, local] mesh and the point-sharded MSM against a host oracle.
"""
import os
import socket
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed():
    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), "_distributed_worker.py")
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update({
            "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
            "JAX_NUM_PROCESSES": "2",
            "JAX_PROCESS_ID": str(pid),
            "JAX_PLATFORMS": "cpu",
        })
        env.pop("XLA_FLAGS", None)  # worker sets its own device count
        # The worker script lives in tests/, so python puts tests/ (not the
        # repo root) on sys.path -- plonky_tpu must come via PYTHONPATH,
        # which the invoking environment does not always provide.  EXTEND,
        # never overwrite.
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        procs.append(subprocess.Popen(
            [sys.executable, worker], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert "sharded MSM OK" in out
