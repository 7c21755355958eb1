"""Multi-process distributed runtime (SURVEY.md P8).

The reference has NO distributed backend (rayon shared-memory only,
Cargo.toml:21); the equivalent here is the `jax.distributed` runtime: one
process per host (or per card), all devices visible as one global device
list, and a 2-D mesh whose inner axis spans the cards of one process and
whose outer axis spans processes.  The cards of one host are joined all to
all by NVLink, so the mesh follows the algorithm alone.

Sharding plan for the BASELINE 2^22 workloads across H processes x C cards:

* FFT 2^22 (four-step, parallel/fft.py): factor n = n1 * n2 with
  n1 = H * C.  Stage 1 (per-shard n2-FFTs + twiddle multiply) is purely
  local; the single transpose between stages is one all_to_all, which XLA
  hands to NCCL -- (H*C-1)/(H*C) of the 2^22 * D * 4 bytes ~ 0.5 GB moves
  per FFT, amortizable by batching polynomials.
* MSM 2^22 (parallel/msm.py): points/scalars sharded over all H*C cards;
  the bucket pipeline is local per card and only the H*C partial points
  (~KB) are combined -- communication-free to first order, so weak scaling
  is bounded by the slowest card, not the interconnect.
* Transcript: host-side on process 0; challenge columns ([D, 1] arrays) are
  broadcast with the next dispatched computation (bytes, negligible).

Single-process fallbacks keep every code path testable without hardware:
`initialize()` is a no-op for a single process, and `hybrid_mesh` degrades
to a flat local mesh.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bring up the jax.distributed runtime for a multi-host run.

    Call once per process before any jax computation.  Arguments default to
    the standard env vars (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES,
    JAX_PROCESS_ID) so launchers can configure via environment only.
    Single-process (or already-initialized) invocations are no-ops.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    if num_processes <= 1 or coordinator_address is None:
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
    except RuntimeError:
        # already initialized (e.g. by the launcher)
        pass


def hybrid_mesh(local_axis: str = "local", proc_axis: str = "proc") -> Mesh:
    """2-D mesh [proc, local]: the inner axis spans the devices of one
    process, the outer axis spans processes.  With a single process this is
    a [1, n_local] mesh, so shardings written against the two named axes
    run unchanged from 1 card to H processes."""
    devs = jax.devices()
    n_proc = jax.process_count()
    per_proc = len(devs) // n_proc
    arr = np.array(devs).reshape(n_proc, per_proc)
    return Mesh(arr, (proc_axis, local_axis))


def process_local_slice(n_total: int) -> tuple[int, int]:
    """[start, stop) of this process's shard of a length-n_total axis."""
    n_proc = jax.process_count()
    assert n_total % n_proc == 0
    per = n_total // n_proc
    i = jax.process_index()
    return i * per, (i + 1) * per
