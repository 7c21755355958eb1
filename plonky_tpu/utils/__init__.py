"""Small pure-host utilities.

Re-implementation of the helpers in the reference's `src/util.rs`
(ceil_div, log2, padding, transpose); behavioral parity, new code.
"""

from __future__ import annotations


def raise_map_count_limit(target: int = 4_194_304) -> None:
    """Raise the kernel's per-process memory-map limit when possible.

    ROOT CAUSE of the long-standing "aged process" SIGSEGVs (rounds 3-5):
    XLA:CPU creates memory mappings at a furious rate while compiling /
    loading our giant protocol executables -- measured on this box: a
    3-file protocol-test pytest run grew from 37k to 58k maps in three
    minutes and died right at the default `vm.max_map_count` of 65530
    (SIGSEGV or SIGABRT wherever the failing mmap lands: persistent-cache
    deserialization, a compile, an allocation...).  Stack sizes, compile
    threads and cache policy only moved the crash around; the map-count
    ceiling is the real resource running out.  Raising it requires root
    (true in this environment); where the write fails this is a no-op and
    the big-stack/cache-cap mitigations still help."""
    try:
        with open("/proc/sys/vm/max_map_count", "r") as f:
            current = int(f.read().strip())
        if current >= target:
            return
        with open("/proc/sys/vm/max_map_count", "w") as f:
            f.write(str(target))
    except (OSError, ValueError):
        pass


def raise_stack_limit() -> None:
    """Raise RLIMIT_STACK to the hard limit so XLA:CPU can compile our
    largest programs.

    The unrolled digit-convolution bodies make some protocol graphs (the
    Rescue-gadget circuit build, the verifier's G-check MSM) deep enough
    that XLA's recursive CPU compiler passes overflow the stack -- a hard
    SIGSEGV that killed whole pytest runs (reproduced rounds 3-4).  256 MB
    was measured insufficient (a suite run still crashed); the same
    programs compile fine under `ulimit -s unlimited`, so go to the hard
    limit (unlimited for us).  The Linux main-thread stack grows on demand
    up to the rlimit at fault time, so raising the soft limit in-process,
    before the first compile, is sufficient.  No-op where the hard limit
    forbids it or on non-Unix."""
    try:
        import resource
        soft, hard = resource.getrlimit(resource.RLIMIT_STACK)
        if soft != hard:
            resource.setrlimit(resource.RLIMIT_STACK, (hard, hard))
    except (ImportError, ValueError, OSError):
        pass


def install_big_stack_compile(stack_bytes: int = 8 << 30) -> None:
    """Route XLA's client-side compile-or-load-from-cache path through a
    thread with a large FIXED stack.

    `raise_stack_limit` is not always enough: the MAIN thread's stack
    grows on demand only while the address space below it is unmapped,
    and a long-lived process (a full pytest session) accumulates mappings
    until growth fails -- the same graph then compiles fine in a fresh
    process but SIGSEGVs mid-suite (observed: the crash moved from graph
    to graph as individual programs were right-sized).  A worker thread
    created with an explicit `threading.stack_size` gets its full stack
    as one up-front mapping, immune to crowding, so every deep recursive
    XLA:CPU pass gets room regardless of process age.  8 GB: the
    deepest protocol graphs (gate-constraint evaluation with in-circuit
    curve formulas inlined) overflowed 512 MB and 2 GB thread stacks --
    each raise moved the crash one test later -- and the mapping is
    virtual and lazily paged, so the cost is address space only.
    Thread-per-compile costs ~ms against multi-second compiles.

    Applies to the CPU backend only (the CPU test tier); elsewhere it is a
    no-op.

    We wrap `compile_or_get_cached`, NOT just `backend_compile_and_load`:
    deserializing a persistent-cache HIT (`_cache_read` ->
    `get_executable_and_time`) recurses as deep as compiling does, and
    round 4's wrap of only the compile path left cache reads on the
    crowded main thread -- the full suite then segfaulted inside
    `jax/_src/compilation_cache.py:get_executable_and_time` with a warm
    cache.  `backend_compile_and_load` is wrapped too for any direct
    callers.  Degrades to a no-op (with a warning) if a jax upgrade
    renames either private symbol.  Idempotent."""
    import threading
    import warnings

    import jax

    if jax.default_backend() != "cpu":
        return
    try:
        import jax._src.compiler as _comp
    except ImportError:  # pragma: no cover - jax internals moved
        warnings.warn("plonky_tpu: jax._src.compiler missing; "
                      "big-stack compile guard disabled")
        return

    # threading.stack_size() is process-global; serialize set/spawn/restore
    # so a concurrent compile can't race a worker onto the default stack.
    lock = threading.Lock()

    def _wrap(inner):
        def on_big_stack(*args, **kwargs):
            result = {}

            def run():
                try:
                    result["v"] = inner(*args, **kwargs)
                except BaseException as e:  # re-raised on the caller thread
                    result["e"] = e

            with lock:
                old = threading.stack_size(stack_bytes)
                try:
                    t = threading.Thread(
                        target=run, name="xla-compile-big-stack")
                    t.start()
                finally:
                    threading.stack_size(old)
            t.join()
            if "e" in result:
                raise result["e"]
            return result["v"]

        on_big_stack._plonky_big_stack = True
        return on_big_stack

    for name in ("compile_or_get_cached", "backend_compile_and_load"):
        fn = getattr(_comp, name, None)
        if fn is None:  # pragma: no cover - jax internals renamed
            warnings.warn(f"plonky_tpu: jax._src.compiler.{name} missing; "
                          "big-stack guard not applied to it")
            continue
        if getattr(fn, "_plonky_big_stack", False):
            continue
        setattr(_comp, name, _wrap(fn))


def ceil_div(a: int, b: int) -> int:
    """Ceiling division (reference: src/util.rs ceil_div_usize)."""
    return -(-a // b)


def pad_to_multiple(n: int, m: int) -> int:
    """Round n up to a multiple of m (reference: src/util.rs pad_to_multiple_usize)."""
    return ceil_div(n, m) * m


def log2_ceil(n: int) -> int:
    """Smallest k with 2^k >= n (reference: src/util.rs log2_ceil)."""
    assert n > 0
    return (n - 1).bit_length()


def log2_strict(n: int) -> int:
    """log2 of n, requiring n to be a power of two (reference: src/util.rs log2_strict)."""
    k = n.bit_length() - 1
    assert 1 << k == n, f"{n} is not a power of two"
    return k


def is_power_of_two(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def transpose(matrix):
    """Transpose a list-of-lists (reference: src/util.rs transpose)."""
    if not matrix:
        return []
    return [list(row) for row in zip(*matrix)]


import functools as _functools

# Process-wide count of jit TRACES through cached_jit (the wrapped python
# body only runs while tracing, so a cache hit leaves this untouched).
# Tests assert a second proof of the same circuit adds zero traces.
TRACE_COUNT = [0]


@_functools.lru_cache(maxsize=None)
def cached_jit(fn, *static):
    """One process-wide jit per (function, static-arg tuple).

    The hot protocol path must never build `jax.jit(lambda ...)` objects per
    call: a fresh function identity defeats jit's in-process cache and forces
    a re-trace (and an XLA cache lookup by serialized program) on every
    proof.  All per-proof values (challenges, opening points) are passed as
    device arrays so the traced graph is reused across proofs of the same
    circuit shape.  Static args may be any hashable (FieldSpec, circuit,
    FFT precomputation -- object identity is the right key for the latter
    two, which are built once and reused).
    """
    import jax

    def body(*args, **kwargs):
        TRACE_COUNT[0] += 1
        return fn(*static, *args, **kwargs)

    # the jitted program is named after fn (compile logs, profiler traces)
    body.__name__ = body.__qualname__ = getattr(fn, "__name__", "body")
    return jax.jit(body)
