"""Smoke test of the main path on one GPU: the quickest proof that the
system still starts and proves correctly on the card.

    python chip_smoke.py

Phases, in order, in one process (any failure exits non-zero):

1. device check: JAX must report a GPU (no CPU fallback of any kind);
2. field multiply, Tweedledee and BLS12-377 base fields, batch 2^16, exact
   against the python-int host oracle;
3. FFT -> iFFT round trip at 2^16 on the runtime-table path, exact, and
   FFT values checked against host polynomial evaluation;
4. Tweedledee MSM at 2^16 against a one-scalar-mul host oracle;
5. the trivial, sum-PI and curve-add fixture proofs with pinned RNG,
   byte-identical to tests/fixtures/proof_*.hex;
6. the reference demo's inner proof: a 2^14-gate Tweedledee circuit, built,
   witnessed, proved cold and warm, and verified with verify_g=True.

The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
T0 = time.time()


def log(msg: str) -> None:
    print(f"[{time.time() - T0:8.1f}s] {msg}", flush=True)


def timed(fn, *args):
    """(result, seconds) with every array of the result ready."""
    import jax

    t0 = time.time()
    out = jax.block_until_ready(fn(*args))
    return out, time.time() - t0


def columns_to_ints(digits) -> list:
    """Canonical [D, n] digit array (values < 256) -> n python ints."""
    cols = np.ascontiguousarray(np.asarray(digits).astype(np.uint8).T)
    return [int.from_bytes(row.tobytes(), "little") for row in cols]


def device_check() -> dict:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU; JAX reports "
                         f"platform {dev.platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    log(f"jax {jax.__version__}; device_kind {dev.device_kind}; "
        f"{len(jax.devices())} device(s)")
    print(smi.stdout.strip(), flush=True)
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def phase_field(log_n: int, seed: int = 0) -> None:
    """Field multiply over a batch of 2^log_n, exact against host ints."""
    import jax

    from plonky_tpu.fields import BLS12_377_BASE, TWEEDLEDEE_BASE
    from plonky_tpu.fields import ops as fops

    rng = np.random.default_rng(seed)
    n = 1 << log_n
    for F in (TWEEDLEDEE_BASE, BLS12_377_BASE):
        a = [int.from_bytes(rng.bytes(48), "little") % F.p for _ in range(n)]
        b = [int.from_bytes(rng.bytes(48), "little") % F.p for _ in range(n)]
        da, db = fops.from_ints(F, a), fops.from_ints(F, b)
        mul_canon = jax.jit(
            lambda x, y, F=F: fops.canonicalize(F, fops.mul(F, x, y)))
        _, cold = timed(mul_canon, da, db)
        out, warm = timed(mul_canon, da, db)
        got = columns_to_ints(out)
        want = [x * y % F.p for x, y in zip(a, b)]
        assert got == want, f"field mul mismatch in {F.name}"
        log(f"field mul {F.name} D={F.n_digits} 2^{log_n}: exact; "
            f"first call {cold:.2f}s, steady {warm * 1e3:.2f} ms")


def phase_fft(log_n: int, seed: int = 1) -> None:
    """FFT -> iFFT round trip on the runtime-table path, exact; FFT values
    at a few indices checked against host evaluation."""
    import jax

    from plonky_tpu.curves import TWEEDLEDEE
    from plonky_tpu.fields import ops as fops
    from plonky_tpu.poly.fft import FftPrecomputation, fft_t, ifft_t

    F = TWEEDLEDEE.scalar    # the prover's FFT field
    rng = np.random.default_rng(seed)
    n = 1 << log_n
    pre = FftPrecomputation(F, n)
    coeffs = [int.from_bytes(rng.bytes(40), "little") % F.p for _ in range(n)]
    dc = fops.from_ints(F, coeffs)
    fwd = jax.jit(lambda c, *t: fops.canonicalize(F, fft_t(pre, c, *t)))
    inv = jax.jit(lambda v, *t: fops.canonicalize(F, ifft_t(pre, v, *t)))
    tf, ti = pre.runtime_tables(False), pre.runtime_tables(True)
    vals, t_f = timed(fwd, dc, *tf)
    back, t_i = timed(inv, vals, *ti)
    assert columns_to_ints(back) == coeffs, "FFT round trip mismatch"
    got = columns_to_ints(vals)
    for k in rng.integers(0, n, 4):
        x = pow(pre.g, int(k), F.p)
        want = 0
        for c in reversed(coeffs):
            want = (want * x + c) % F.p
        assert got[int(k)] == want, f"FFT value {k} mismatch"
    _, steady = timed(fwd, dc, *tf)
    log(f"FFT {F.name} 2^{log_n}: round trip exact, values match host; "
        f"first calls {t_f:.2f}s + {t_i:.2f}s, steady FFT "
        f"{steady * 1e3:.2f} ms")


def phase_msm(log_n: int, seed: int = 0, chunk_log: int = 14) -> None:
    """Tweedledee MSM of 2^log_n points against one host scalar multiply.
    Runs in chunks of 2^chunk_log points, the basis size of the 2^14-gate
    proof's commitments, so this phase and the prover share one compiled
    group program."""
    import jax

    from plonky_tpu.curves import TWEEDLEDEE as curve
    from plonky_tpu.curves import host as chost
    from plonky_tpu.curves import msm as cmsm
    from plonky_tpu.curves import ops as cops
    from plonky_tpu.fields import ops as fops

    n = 1 << log_n
    xs, ys, dig, expected = chost.chain_msm_instance(curve, n, seed)
    P = cops.from_affine(curve, jax.numpy.asarray(xs), jax.numpy.asarray(ys),
                         jax.numpy.zeros(n, bool))
    scalars = jax.numpy.asarray(dig)

    def fn(P, S):
        return cmsm.msm_chunked(curve, P, S, window_bits=8,
                                chunk_log=chunk_log)

    out, cold = timed(fn, P, scalars)
    out, warm = timed(fn, P, scalars)
    x, y, zero = jax.jit(lambda q: cops.to_affine(curve, q))(out)
    got = chost.AffinePoint(curve, fops.to_ints(curve.base, x),
                            fops.to_ints(curve.base, y), bool(zero))
    assert got == expected, "MSM mismatch"
    log(f"MSM {curve.name} 2^{log_n} (w=8): matches host oracle; "
        f"first call {cold:.2f}s, steady {warm * 1e3:.1f} ms")


def phase_fixtures(names=("trivial", "sum_pi", "curve_add")) -> None:
    """Pinned-RNG fixture proofs, byte-identical to tests/fixtures."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import test_proof_fixture as tpf

    from plonky_tpu.curves import TWEEDLEDEE
    from plonky_tpu.protocol.serialization import proof_to_bytes

    for name in names:
        t0 = time.time()
        with tpf.pinned_rng():
            _, proof, _ = tpf.FIXTURES[name]()
        got = proof_to_bytes(TWEEDLEDEE, proof).hex()
        with open(os.path.join(tpf.FIXTURE_DIR, f"proof_{name}.hex")) as f:
            want = f.read().strip()
        assert got == want, f"fixture proof {name} differs from its bytes"
        log(f"fixture proof {name}: byte-identical "
            f"({time.time() - t0:.1f}s incl. build and compiles)")


def phase_main(log_gates: int):
    """Build -> witness -> prove (cold, warm) -> verify(verify_g=True) of
    the reference demo's inner circuit (src/bin/recursion.rs:6-97): buffer
    gates up to 2^log_gates.  Returns (record of seconds and peak device
    bytes, circuit)."""
    import jax

    from plonky_tpu.circuit import CircuitBuilder, PartialWitness
    from plonky_tpu.circuit.gates import BufferGate
    from plonky_tpu.curves import TWEEDLEDEE, TWEEDLEDUM
    from plonky_tpu.protocol import generate_proof, verify_proof
    from plonky_tpu.utils.timing import record_phases

    t0 = time.time()
    builder = CircuitBuilder(TWEEDLEDEE, security_bits=128)
    while builder.num_gates() < (1 << log_gates) - 3:
        builder.add_gate_no_constants(BufferGate(builder.num_gates()))
    circuit = builder.build()
    jax.block_until_ready(circuit.constants_8n)
    rec = {"build_s": time.time() - t0}
    log(f"main: circuit build {rec['build_s']:.2f}s "
        f"(degree 2^{circuit.degree().bit_length() - 1})")
    t0 = time.time()
    witness = circuit.generate_witness(PartialWitness())
    rec["witness_s"] = time.time() - t0
    log(f"main: witness {rec['witness_s']:.2f}s")
    for label in ("cold", "warm"):
        t0 = time.time()
        with record_phases() as phases:
            proof = generate_proof(circuit, witness, old_proofs=[],
                                   blinding=True)
        rec[f"{label}_prove_s"] = time.time() - t0
        rec[f"{label}_phases_s"] = {k.split(".")[-1]: v
                                    for k, v in phases.items()}
        log(f"main: {label} prove {rec[f'{label}_prove_s']:.2f}s; phases "
            + " ".join(f"{k}={v:.2f}"
                       for k, v in rec[f"{label}_phases_s"].items()))
    t0 = time.time()
    old = verify_proof(circuit.get_public_inputs(witness), proof, [],
                       circuit.to_vk(), TWEEDLEDUM, verify_g=True)
    assert old is None, f"2^{log_gates} proof did not verify"
    rec["verify_s"] = time.time() - t0
    log(f"main: verify (verify_g=True) {rec['verify_s']:.2f}s: "
        "proof verified")
    stats = jax.devices()[0].memory_stats() or {}
    rec["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    log(f"main: peak_bytes_in_use {rec['peak_bytes_in_use']}")
    return rec, circuit


def main() -> int:
    sys.path.insert(0, REPO)
    device = device_check()
    import plonky_tpu

    from plonky_tpu.hashing import blake3

    log(f"compile cache: {plonky_tpu.enable_compilation_cache()}")
    log("native BLAKE3: " + ("built from native/blake3.c"
                             if blake3._load_native() else
                             "not built; pure-Python fallback"))
    phase_field(16)
    phase_fft(16)
    phase_msm(16)
    phase_fixtures()
    phase_main(14)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
