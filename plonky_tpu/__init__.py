"""plonky_tpu: a recursive zk-SNARK proving framework in JAX.

A from-scratch re-design of the capabilities of the reference `plonky`
(PLONK with custom gates + Halo IPA over the Tweedledee/Tweedledum 2-cycle)
for accelerators: batched digit-vector field arithmetic, fold-matrix modular
reduction, branch-free complete curve formulas, dense Pippenger MSM, and
mesh-sharded FFT/MSM via jax.sharding -- orchestrated by JAX/XLA with the
sequential transcript and circuit construction on host.
"""

import os as _os

__version__ = "0.1.0"

# <checkout>/.cache/jax: a fixed path (the cache key includes it), inside
# the checkout so the program writes nothing outside it.  `.cache/` is
# git-ignored.
DEFAULT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".cache", "jax")


def enable_compilation_cache() -> str | None:
    """Enable JAX's persistent compilation cache (protocol graphs are large;
    caching makes repeat runs start in seconds).  Returns the directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX already uses it and nothing
    is set here.  Otherwise the cache goes to DEFAULT_CACHE_DIR.
    PLONKY_COMPILE_CACHE=0 disables the cache.

    On the CPU backend only (the CPU test tier), entries larger than
    PLONKY_CACHE_MAX_READ_MB (default 6) are not read back
    (`_install_cache_read_cap`): `deserialize_executable` on the largest
    (>~10 MB) XLA:CPU AOT entries SIGSEGVs in long-lived processes, while
    compiling the same graphs (on the big-stack thread of
    `utils.install_big_stack_compile`) is stable.  The CPU cache also
    guards stability, not just speed: long processes that cold-compile many
    of the largest protocol graphs have crashed inside XLA:CPU, and a warm
    cache skips those compiles.
    """
    import jax

    if _os.environ.get("PLONKY_COMPILE_CACHE") == "0":
        return None
    path = _os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    if jax.default_backend() == "cpu":
        max_mb = float(_os.environ.get("PLONKY_CACHE_MAX_READ_MB", "6"))
        _install_cache_read_cap(int(max_mb * (1 << 20)))
    return path


def _install_cache_read_cap(max_bytes: int) -> None:
    """Treat persistent-cache entries larger than max_bytes as misses.

    See enable_compilation_cache's docstring: XLA:CPU's
    deserialize_executable segfaults on the giant protocol-graph entries
    once a process has aged, while compiling the same graph (on the
    big-stack worker thread) does not.  The entry is fetched once here to
    check its size; undersized entries are re-fetched by the original
    reader (disk cache hits are cheap next to a multi-MB deserialize).
    Degrades to a no-op if jax internals move.  Idempotent."""
    import warnings

    try:
        import jax._src.compilation_cache as _cc
    except ImportError:  # pragma: no cover - jax internals moved
        warnings.warn("plonky_tpu: jax._src.compilation_cache missing; "
                      "cache read cap disabled")
        return
    orig = getattr(_cc, "get_executable_and_time", None)
    getc = getattr(_cc, "_get_cache", None)
    if orig is None or getc is None:  # pragma: no cover
        warnings.warn("plonky_tpu: compilation_cache internals renamed; "
                      "cache read cap disabled")
        return
    if getattr(orig, "_plonky_read_cap", False):
        return

    def capped(cache_key, compile_options, backend, executable_devices):
        try:
            cache = getc(backend)
            if cache is not None:
                entry = cache.get(cache_key)
                if entry is not None and len(entry) > max_bytes:
                    return None, None
        except Exception:
            pass
        return orig(cache_key, compile_options, backend, executable_devices)

    capped._plonky_read_cap = True
    _cc.get_executable_and_time = capped

    # Recompiled oversized entries would be re-SERIALIZED and rewritten
    # every process (serialization of the giants is the other historical
    # SIGSEGV mode, round 3) -- skip the put when the key already exists.
    orig_put = getattr(_cc, "put_executable_and_time", None)
    if orig_put is not None and not getattr(orig_put, "_plonky_read_cap",
                                            False):
        def put_once(cache_key, module_name, executable, backend,
                     compile_time):
            try:
                cache = getc(backend)
                if cache is not None and cache.get(cache_key) is not None:
                    return
            except Exception:
                pass
            return orig_put(cache_key, module_name, executable, backend,
                            compile_time)

        put_once._plonky_read_cap = True
        _cc.put_executable_and_time = put_once
