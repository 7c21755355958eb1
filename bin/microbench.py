"""Microbenchmark suite mirroring the reference's criterion benches
(BASELINE.md workload table; reference: benches/*.rs).

Workloads:
  field  — add/sub/mul/square/inverse/exp batch throughput per field
           (TweedledeeBase, Bls12377Base, Bls12377Scalar; reference:
           benches/tweedledee_base.rs, bls12_base.rs, bls12_scalar.rs)
  cmp    — batched canonical equality (reference: benches/bigint_arithmetic.rs)
  curve  — BLS12-377 G1 batched add / double (reference: benches/bls12_g1.rs)
           and a 150-point summation (benches/bls12_g1_summations.rs)
  fft    — FFT/iFFT over TweedledeeBase at several sizes (benches/fft.rs)
  h2c    — hash-to-curve BLAKE3 vs Rescue (benches/hash_to_curve.rs)
  rescue — batched Rescue permutation (part of benches/bls12_scalar.rs)
  msm    — MSM over Tweedledee and BLS12-377 G1 (src/bin/msms.rs)

Each emits one JSON line to stdout; a human-readable line goes to stderr.
Select workloads with --only (comma list); size knobs via env
PLONKY_BENCH_LOG_{MUL,FFT,MSM}.

On a cold cache every distinct (op, field, size) pays an XLA compile, so
defaults are modest.  Times end in block_until_ready.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def emit(metric, value, unit, **detail):
    log(f"  {metric}: {value:.4g} {unit}")
    print(json.dumps({"metric": metric, "value": value, "unit": unit,
                      "detail": detail}), flush=True)


def time_it(fn, *args, reps=10):
    import jax
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.time() - t0) / reps


def rand_elems(F, n, rng):
    from plonky_tpu.fields import ops as fops
    return fops.from_ints(F, [int.from_bytes(rng.bytes(48), "little") % F.p
                              for _ in range(n)])


def bench_field(F, name, lg, rng):
    import jax
    from plonky_tpu.fields import ops as fops
    n = 1 << lg
    a = rand_elems(F, n, rng)
    b = rand_elems(F, n, rng)
    ops = {
        "add": jax.jit(lambda x, y: fops.add(F, x, y)),
        "sub": jax.jit(lambda x, y: fops.sub(F, x, y)),
        "mul": jax.jit(lambda x, y: fops.mul(F, x, y)),
        "square": jax.jit(lambda x, y: fops.square(F, x)),
        "inverse": jax.jit(lambda x, y: fops.inverse(F, x)),
        "exp": jax.jit(lambda x, y: fops.exp_const(F, x, 1234567)),
    }
    for op, fn in ops.items():
        reps = 3 if op in ("inverse", "exp") else 10
        dt = time_it(fn, a, b, reps=reps)
        emit(f"field_{op}_{name}_2e{lg}", n / dt, "elems/s", ms=dt * 1e3)


def bench_cmp(F, name, lg, rng):
    import jax
    from plonky_tpu.fields import ops as fops
    n = 1 << lg
    a = rand_elems(F, n, rng)
    b = rand_elems(F, n, rng)
    fn = jax.jit(lambda x, y: fops.eq(F, x, y))
    dt = time_it(fn, a, b)
    emit(f"cmp_eq_{name}_2e{lg}", n / dt, "elems/s", ms=dt * 1e3)


def _rand_points(curve, n, rng):
    """Random multiples of the generator via a doubling chain (host)."""
    import jax.numpy as jnp
    from plonky_tpu.curves import host as chost, ops as cops
    from plonky_tpu.fields import ops as fops
    g = chost.generator(curve)
    pts = []
    cur = chost.mul(g, int(rng.integers(1, 1 << 62)))
    for _ in range(n):
        pts.append(cur)
        cur = chost.add(cur, cur)
    xs = fops.from_ints(curve.base, [p.x for p in pts])
    ys = fops.from_ints(curve.base, [p.y for p in pts])
    return pts, cops.from_affine(curve, xs, ys,
                                 jnp.asarray(np.zeros(n, bool)))


def bench_curve(lg, rng):
    import jax
    from plonky_tpu.curves import BLS12_377 as curve
    from plonky_tpu.curves import ops as cops
    n = 1 << lg
    _, P = _rand_points(curve, n, rng)
    add_fn = jax.jit(lambda p: cops.add(curve, p, p))
    dbl_fn = jax.jit(lambda p: cops.double(curve, p))
    dt = time_it(add_fn, P, reps=5)
    emit(f"bls12_g1_add_2e{lg}", n / dt, "adds/s", ms=dt * 1e3)
    dt = time_it(dbl_fn, P, reps=5)
    emit(f"bls12_g1_double_2e{lg}", n / dt, "dbls/s", ms=dt * 1e3)


def bench_summation(rng):
    """150-point summation (reference: benches/bls12_g1_summations.rs)."""
    import jax
    from plonky_tpu.curves import BLS12_377 as curve
    from plonky_tpu.curves import host as chost, ops as cops
    n = 150
    pad = 256
    pts, _ = _rand_points(curve, n, rng)
    _, P = _rand_points(curve, pad, rng)
    import jax.numpy as jnp
    from plonky_tpu.fields import ops as fops
    xs = fops.from_ints(curve.base, [p.x for p in pts] + [0] * (pad - n))
    ys = fops.from_ints(curve.base, [p.y for p in pts] + [0] * (pad - n))
    zero = np.zeros(pad, bool)
    zero[n:] = True
    P = cops.from_affine(curve, xs, ys, jnp.asarray(zero))

    def tree_sum(p):
        m = pad
        while m > 1:
            half = tuple(t[..., : m // 2] for t in p)
            other = tuple(t[..., m // 2: m] for t in p)
            p = cops.add(curve, half, other)
            m //= 2
        return tuple(t[..., 0] for t in p)

    fn = jax.jit(tree_sum)
    dt = time_it(fn, P, reps=5)
    # correctness: compare against host sum
    out = fn(P)
    x_a, y_a, is_zero = jax.jit(lambda q: cops.to_affine(curve, q))(out)
    expected = pts[0]
    for p in pts[1:]:
        expected = chost.add(expected, p)
    got = chost.AffinePoint(curve, fops.to_ints(curve.base, x_a),
                            fops.to_ints(curve.base, y_a))
    assert got == expected and not bool(np.asarray(is_zero))
    emit("bls12_g1_summation_150", dt * 1e3, "ms")


def bench_fft(lgs, rng):
    import jax
    from plonky_tpu.fields import TWEEDLEDEE_BASE as F
    from plonky_tpu.poly.fft import FftPrecomputation, fft, ifft
    for lg in lgs:
        n = 1 << lg
        pre = FftPrecomputation(F, n)
        coeffs = jax.numpy.asarray(
            rng.integers(0, 256, (F.n_digits, n), dtype=np.int32))
        f_fn = jax.jit(lambda c: fft(pre, c))
        i_fn = jax.jit(lambda c: ifft(pre, c))
        dt = time_it(f_fn, coeffs, reps=5)
        emit(f"fft_tweedledee_2e{lg}", (n // 2 * lg) / dt, "butterflies/s",
             ms=dt * 1e3)
        dt = time_it(i_fn, coeffs, reps=5)
        emit(f"ifft_tweedledee_2e{lg}", (n // 2 * lg) / dt, "butterflies/s",
             ms=dt * 1e3)


def bench_h2c():
    from plonky_tpu.curves import TWEEDLEDEE
    from plonky_tpu.hashing.hash_to_curve import (
        blake_hash_usize_to_curve, hash_usize_to_curve)
    n = 20
    t0 = time.time()
    for i in range(n):
        blake_hash_usize_to_curve(TWEEDLEDEE, i)
    emit("hash_to_curve_blake", (time.time() - t0) / n * 1e3, "ms")
    t0 = time.time()
    for i in range(n):
        hash_usize_to_curve(TWEEDLEDEE, i, 128)
    emit("hash_to_curve_rescue", (time.time() - t0) / n * 1e3, "ms")


def bench_rescue(lg, rng):
    import jax
    from plonky_tpu.fields import TWEEDLEDEE_BASE as F
    from plonky_tpu.hashing import rescue
    n = 1 << lg
    state = [rand_elems(F, n, rng) for _ in range(4)]
    fn = jax.jit(lambda s: rescue.rescue_permutation(F, list(s), 128))
    dt = time_it(fn, state, reps=3)
    emit(f"rescue_permutation_2e{lg}", n / dt, "perms/s", ms=dt * 1e3)


def bench_msm(curve, name, lg, window, rng):
    import jax
    from plonky_tpu.curves import host as chost, msm as cmsm, ops as cops
    from plonky_tpu.fields import ops as fops
    n = 1 << lg
    pts, P = _rand_points(curve, n, rng)
    scalars = fops.from_ints(curve.scalar, [
        int.from_bytes(rng.bytes(40), "little") % curve.scalar.p
        for _ in range(n)])
    fn = cmsm.msm_jit(curve, window)
    dt = time_it(fn, P, scalars, reps=3)
    emit(f"msm_{name}_2e{lg}_w{window}", n / dt, "points/s", ms=dt * 1e3)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", type=str, default="",
                    help="comma list: field,cmp,curve,fft,h2c,rescue,msm")
    args = ap.parse_args()
    only = set(filter(None, args.only.split(",")))

    def want(k):
        return not only or k in only

    import plonky_tpu
    plonky_tpu.enable_compilation_cache()
    import jax
    log("devices:", jax.devices())

    from plonky_tpu.curves import BLS12_377, TWEEDLEDEE
    from plonky_tpu.fields import (
        BLS12_377_BASE,
        BLS12_377_SCALAR,
        TWEEDLEDEE_BASE,
    )

    rng = np.random.default_rng(0)
    lg_mul = int(os.environ.get("PLONKY_BENCH_LOG_MUL", "16"))
    lg_fft = int(os.environ.get("PLONKY_BENCH_LOG_FFT", "14"))
    lg_msm = int(os.environ.get("PLONKY_BENCH_LOG_MSM", "12"))

    if want("field"):
        log("== field ops ==")
        bench_field(TWEEDLEDEE_BASE, "tweedledee", lg_mul, rng)
        bench_field(BLS12_377_BASE, "bls12base", lg_mul, rng)
        bench_field(BLS12_377_SCALAR, "bls12scalar", lg_mul, rng)
    if want("cmp"):
        log("== canonical compare ==")
        bench_cmp(BLS12_377_BASE, "bls12base", lg_mul, rng)
    if want("curve"):
        log("== BLS12-377 G1 ==")
        bench_curve(min(lg_mul, 14), rng)
        bench_summation(rng)
    if want("fft"):
        log("== FFT ==")
        bench_fft([lg_fft - 4, lg_fft], rng)
    if want("h2c"):
        log("== hash-to-curve ==")
        bench_h2c()
    if want("rescue"):
        log("== Rescue ==")
        bench_rescue(min(lg_mul, 14), rng)
    if want("msm"):
        log("== MSM ==")
        bench_msm(TWEEDLEDEE, "tweedledee", lg_msm, 8, rng)
        bench_msm(BLS12_377, "bls12_g1", lg_msm, 8, rng)


if __name__ == "__main__":
    main()
