"""Phase timing / tracing (SURVEY.md section 5: the reference's only
observability is `log`-crate phase lines, e.g. witness-generation wall time
at plonk.rs:581 and gate counts at circuit_builder.rs:1091-1102).

Enable with PLONKY_TRACE=1 (stderr phase lines) and PLONKY_PROFILE=<dir>
(wraps phases in jax.profiler traces for xprof/tensorboard).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

_TRACE = os.environ.get("PLONKY_TRACE", "") not in ("", "0")
_PROFILE_DIR = os.environ.get("PLONKY_PROFILE", "")
_depth = [0]


def trace_enabled() -> bool:
    return _TRACE


# When non-None, phase() accumulates {name: total_seconds} here (in
# addition to any stderr/profiler output).  Used by bench.py's prover
# phase to report per-phase wall-clock without env plumbing.
_RECORDER = [None]


@contextlib.contextmanager
def record_phases():
    """Collect phase durations into the yielded dict for this block.
    Durations accumulate by name (a phase entered twice sums)."""
    acc = {}
    prev = _RECORDER[0]
    _RECORDER[0] = acc
    try:
        yield acc
    finally:
        _RECORDER[0] = prev


@contextlib.contextmanager
def phase(name: str):
    """Time a named phase.  Nesting is indented; no-op unless PLONKY_TRACE
    is set (and jax.profiler.TraceAnnotation when PLONKY_PROFILE is) or a
    record_phases() block is active."""
    if not _TRACE and not _PROFILE_DIR and _RECORDER[0] is None:
        yield
        return
    ctx = contextlib.nullcontext()
    if _PROFILE_DIR:
        import jax
        ctx = jax.profiler.TraceAnnotation(name)
    t0 = time.time()
    _depth[0] += 1
    try:
        with ctx:
            yield
    finally:
        _depth[0] -= 1
        dt = time.time() - t0
        if _RECORDER[0] is not None:
            _RECORDER[0][name] = _RECORDER[0].get(name, 0.0) + dt
        if _TRACE:
            indent = "  " * _depth[0]
            print(f"[plonky {indent}{name}] {dt:.3f}s",
                  file=sys.stderr, flush=True)


@contextlib.contextmanager
def profiler_session():
    """Wrap a whole run in a jax profiler trace when PLONKY_PROFILE is set
    (replacement for the reference's RUST_LOG timing)."""
    if not _PROFILE_DIR:
        yield
        return
    import jax
    jax.profiler.start_trace(_PROFILE_DIR)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
