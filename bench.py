"""Benchmark on one GPU, in one process.

    python bench.py [--phases field,point_add,fft_layer,fft,msm,rescue,blsmsm,prover]

Phases (all by default, in this order):

* field      -- Tweedledee base-field multiply (D=34 digits) at 2^18, 2^20;
* point_add  -- RCB15 complete point add on Tweedledee at 2^20;
* fft_layer  -- one radix-2 butterfly stage over 2^20 points;
* fft        -- full FFT with runtime tables, 2^14 .. 2^22;
* msm        -- Tweedledee MSM 2^16 .. 2^22, each result checked against a
                one-scalar-mul host oracle;
* rescue     -- a batch of 2^14 Rescue permutations;
* blsmsm     -- BLS12-377 G1 MSM at 2^16 (random digits: throughput only);
* prover     -- the reference demo's 2^14-gate proof (src/bin/recursion.rs:
                6-97): build, cold and warm prove with phase spans, verify
                with verify_g=True, and memory_analysis() of its largest
                device graphs.

Every time is host wall-clock around work that ends in block_until_ready;
compilation is reported apart from steady time.  The kernel phases also
report `compiled.memory_analysis()`.  Without a GPU the script fails: it
never measures another backend.  Log lines go to stderr; the last line of
stdout is one JSON object with the device and every result.

Reference workloads: benches/bls12_g1_summations.rs:8-31 (MSM 2^16-2^22),
benches/fft.rs:10-40 (FFT).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

ALL_PHASES = ("field", "point_add", "fft_layer", "fft", "msm", "rescue",
              "blsmsm", "prover")
KERNEL_LOG_N = 20    # batch of the field, point-add and FFT-layer phases


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def steady_seconds(fn, *args, reps: int = 5) -> float:
    """Median wall-clock of `reps` calls, each ended by block_until_ready.
    The caller has already run fn once (compile + warm-up)."""
    import jax

    times = []
    for _ in range(reps):
        t0 = time.time()
        jax.block_until_ready(fn(*args))
        times.append(time.time() - t0)
    return float(np.median(times))


def compile_with_memory(fn, *args):
    """(compiled, compile seconds, memory-analysis dict) of jit(fn)(*args)."""
    import jax

    t0 = time.time()
    compiled = jax.jit(fn).lower(*args).compile()
    secs = time.time() - t0
    ma = compiled.memory_analysis()
    mem = {k: int(getattr(ma, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if ma is not None and hasattr(ma, k)}
    return compiled, secs, mem


def rand_digits(rng, spec, n):
    """[D, n] random working-form digits (< 256)."""
    import jax.numpy as jnp

    return jnp.asarray(rng.integers(0, 256, (spec.n_digits, n),
                                    dtype=np.int32))


def kernel_record(name, fn, args, n, unit):
    import jax

    compiled, c_s, mem = compile_with_memory(fn, *args)
    jax.block_until_ready(compiled(*args))
    dt = steady_seconds(compiled, *args, reps=10)
    log(f"{name}: {dt * 1e3:.3f} ms ({n / dt:.4g} {unit}/s), compile "
        f"{c_s:.1f}s, memory {mem}")
    return {"ms": dt * 1e3, f"{unit}_per_s": n / dt, "compile_s": c_s,
            "memory": mem}


def phase_field(rng):
    from plonky_tpu.fields import TWEEDLEDEE_BASE as F
    from plonky_tpu.fields import ops as fops

    out = {}
    for lg in (KERNEL_LOG_N - 2, KERNEL_LOG_N):
        n = 1 << lg
        args = (rand_digits(rng, F, n), rand_digits(rng, F, n))
        out[f"2e{lg}"] = kernel_record(
            f"field mul {F.name} D={F.n_digits} 2^{lg}",
            lambda a, b: fops.mul(F, a, b), args, n, "muls")
    return out


def phase_point_add(rng):
    from plonky_tpu.curves import TWEEDLEDEE as curve
    from plonky_tpu.curves import ops as cops

    lg = KERNEL_LOG_N
    n = 1 << lg
    f = curve.base
    p1 = tuple(rand_digits(rng, f, n) for _ in range(3))
    p2 = tuple(rand_digits(rng, f, n) for _ in range(3))
    return {f"2e{lg}": kernel_record(
        f"point add {curve.name} 2^{lg}",
        lambda a, b: cops.add(curve, a, b), (p1, p2), n, "adds")}


def phase_fft_layer(rng):
    from plonky_tpu.curves import TWEEDLEDEE
    from plonky_tpu.poly.fft import butterfly_stage

    F = TWEEDLEDEE.scalar
    lg = KERNEL_LOG_N
    n = 1 << lg
    args = (rand_digits(rng, F, n), rand_digits(rng, F, n // 2))
    return {f"2e{lg}": kernel_record(
        f"FFT stage {F.name} 2^{lg}",
        lambda x, tw: butterfly_stage(F, x, tw), args, n // 2,
        "butterflies")}


def phase_fft(rng):
    import jax

    from plonky_tpu.curves import TWEEDLEDEE
    from plonky_tpu.poly.fft import FftPrecomputation, fft_t

    F = TWEEDLEDEE.scalar
    out = {}
    for lg in (14, 16, 18, 20, 22):
        n = 1 << lg
        pre = FftPrecomputation(F, n)
        tabs = pre.runtime_tables(False)
        fn = jax.jit(lambda c, *t, pre=pre: fft_t(pre, c, *t))
        coeffs = rand_digits(rng, F, n)
        t0 = time.time()
        jax.block_until_ready(fn(coeffs, *tabs))
        first = time.time() - t0
        dt = steady_seconds(fn, coeffs, *tabs)
        rate = (n // 2 * lg) / dt
        log(f"FFT 2^{lg}: {dt * 1e3:.2f} ms ({rate:.4g} butterflies/s), "
            f"first call {first:.1f}s")
        out[f"2e{lg}"] = {"ms": dt * 1e3, "butterflies_per_s": rate,
                          "first_call_s": first}
    return out


def phase_msm(rng, curve=None, sizes=(16, 18, 20, 22), chunk_log=18,
              check=True):
    import jax

    from plonky_tpu.curves import TWEEDLEDEE
    from plonky_tpu.curves import host as chost
    from plonky_tpu.curves import msm as cmsm
    from plonky_tpu.curves import ops as cops
    from plonky_tpu.fields import ops as fops

    curve = curve or TWEEDLEDEE
    out = {}
    for lg in sizes:
        n = 1 << lg
        if check:
            xs, ys, dig, expected = chost.chain_msm_instance(curve, n, lg)
        else:
            xs = rng.integers(0, 256, (curve.base.n_digits, n), np.int32)
            ys = rng.integers(0, 256, (curve.base.n_digits, n), np.int32)
            dig = rng.integers(0, 256, (curve.scalar.n_digits, n), np.int32)
        P = cops.from_affine(curve, jax.numpy.asarray(xs),
                             jax.numpy.asarray(ys), jax.numpy.zeros(n, bool))
        S = jax.numpy.asarray(dig)

        def fn(P, S):
            return cmsm.msm_chunked(curve, P, S, window_bits=8,
                                    window_group=8, chunk_log=chunk_log)

        t0 = time.time()
        res = jax.block_until_ready(fn(P, S))
        first = time.time() - t0
        dt = steady_seconds(fn, P, S, reps=3 if lg <= 18 else 1)
        if check:
            x, y, zero = jax.jit(lambda q: cops.to_affine(curve, q))(res)
            got = chost.AffinePoint(curve, fops.to_ints(curve.base, x),
                                    fops.to_ints(curve.base, y), bool(zero))
            assert got == expected, f"MSM 2^{lg} result wrong"
        log(f"MSM {curve.name} 2^{lg}: {dt * 1e3:.1f} ms "
            f"({n / dt:.4g} points/s), first call {first:.1f}s"
            + (", matches host oracle" if check else ""))
        out[f"2e{lg}"] = {"ms": dt * 1e3, "points_per_s": n / dt,
                          "first_call_s": first, "checked": check}
    return out


def phase_blsmsm(rng):
    from plonky_tpu.curves import BLS12_377

    return phase_msm(rng, BLS12_377, sizes=(16,), chunk_log=16, check=False)


def phase_rescue(rng):
    import jax

    from plonky_tpu.fields import TWEEDLEDEE_BASE as F
    from plonky_tpu.hashing import rescue

    n = 1 << 14
    state = [rand_digits(rng, F, n) for _ in range(4)]
    fn = jax.jit(lambda s: rescue.rescue_permutation(F, s, 128))
    t0 = time.time()
    jax.block_until_ready(fn(state))
    first = time.time() - t0
    dt = steady_seconds(fn, state, reps=3)
    log(f"Rescue 2^14 permutations: {dt * 1e3:.1f} ms, first call "
        f"{first:.1f}s")
    return {"2e14": {"ms": dt * 1e3, "perms_per_s": n / dt,
                     "first_call_s": first}}


def prover_graph_memory(circuit, wires_8n_shape):
    """memory_analysis() of the prover's three largest device graphs at
    this circuit's size: the vanishing polynomial, t = V / Z_H, and the
    commitment MSM's group program (8 windows over the n-point basis)."""
    import functools

    import jax
    import jax.numpy as jnp

    from plonky_tpu.curves import msm as cmsm
    from plonky_tpu.protocol import prover as pv
    from plonky_tpu.protocol.circuit import commit_window_bits
    from plonky_tpu.utils import cached_jit

    sf = circuit.spec
    D, n = sf.n_digits, circuit.degree()
    c = commit_window_bits(n)

    def abstract(*xs):
        return [jax.ShapeDtypeStruct(x.shape, x.dtype) for x in xs]

    col = jnp.zeros((D, 1), jnp.int32)
    sub8, xn_m1 = pv._circuit_vanishing_consts(circuit)
    tabs8 = (circuit.fft_8n.runtime_tables(False)
             + circuit.fft_8n.runtime_tables(True))
    graphs = {
        "vanishing_poly": (cached_jit(pv._vanishing_body, circuit), abstract(
            jax.ShapeDtypeStruct(wires_8n_shape, jnp.int32),
            jax.ShapeDtypeStruct((D, n), jnp.int32),
            circuit.constants_8n, circuit.s_sigma_values_8n, sub8, xn_m1,
            col, col, col, *tabs8)),
        "t_quotient": (cached_jit(pv._div_zh, sf, n), abstract(
            jax.ShapeDtypeStruct((D, 8 * n), jnp.int32),
            *pv._div_zh_consts(circuit))),
        "msm_group": (jax.jit(functools.partial(
            cmsm._group_sum, circuit.curve, c=c, signed=False)), (
            tuple(abstract(*circuit.commit_engine.g_dev)),
            jax.ShapeDtypeStruct((8, n), jnp.int32),
            jax.ShapeDtypeStruct((8, n), jnp.int32))),
    }
    out = {}
    for name, (fn, args) in graphs.items():
        ma = fn.lower(*args).compile().memory_analysis()
        out[name] = {"temp_size_in_bytes": int(ma.temp_size_in_bytes),
                     "argument_size_in_bytes": int(ma.argument_size_in_bytes),
                     "output_size_in_bytes": int(ma.output_size_in_bytes)}
        log(f"prover graph {name}: {out[name]}")
    return out


def phase_prover(rng, log_gates: int = 14):
    """chip_smoke's main path (build, cold and warm prove, verify), plus the
    memory analysis of the prover's largest graphs."""
    import chip_smoke

    rec, circuit = chip_smoke.phase_main(log_gates)
    sf = circuit.spec
    rec["graph_memory"] = prover_graph_memory(
        circuit, (sf.n_digits, 9, 8 * circuit.degree()))
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(ALL_PHASES))
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(ALL_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py: needs a GPU; JAX reports "
                         f"platform {dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"jax {jax.__version__}; {dev.device_kind}; card: {card}")

    import plonky_tpu

    plonky_tpu.enable_compilation_cache()
    rng = np.random.default_rng(0)
    results = {}
    for name in phases:
        results[name] = globals()[f"phase_{name}"](rng)
    print(json.dumps({"device": {"platform": dev.platform,
                                 "kind": dev.device_kind,
                                 "count": len(jax.devices())},
                      "card": card, "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
