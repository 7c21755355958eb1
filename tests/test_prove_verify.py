"""End-to-end prove -> verify (reference: tests/prove_and_verify.rs).

Deterministic: blinding disabled and the random source pinned, mirroring the
reference's test setup guidance (SURVEY.md section 4: run with blinding=false
/ injected RNG)."""

import numpy as np
import pytest

import plonky_tpu.circuit.builder as builder_mod
import plonky_tpu.protocol.halo as halo_mod
from plonky_tpu.circuit import CircuitBuilder, PartialWitness
from plonky_tpu.curves import TWEEDLEDEE, TWEEDLEDUM
from plonky_tpu.protocol import generate_proof, verify_proof


@pytest.fixture(autouse=True)
def deterministic_randomness(monkeypatch):
    rng = np.random.default_rng(314159)

    def fake_random(p):
        return int.from_bytes(rng.bytes(40), "little") % p

    monkeypatch.setattr(builder_mod, "RANDOM_SOURCE", fake_random)
    monkeypatch.setattr(halo_mod, "RANDOM_SOURCE", fake_random)
    yield


def prove_and_verify(build_fn, set_witness_fn, expected_pis=None):
    builder = CircuitBuilder(TWEEDLEDEE, security_bits=128)
    targets = build_fn(builder)
    circuit = builder.build()
    inputs = PartialWitness()
    set_witness_fn(inputs, targets)
    witness = circuit.generate_witness(inputs)
    proof = generate_proof(circuit, witness, old_proofs=[], blinding=True)
    vk = circuit.to_vk()
    pis = circuit.get_public_inputs(witness)
    if expected_pis is not None:
        assert pis == expected_pis
    old = verify_proof(pis, proof, [], vk, TWEEDLEDUM, verify_g=True)
    assert old is None
    return circuit, proof


def test_proof_trivial_circuit():
    """reference: prove_and_verify.rs:18-26 test_proof_trivial."""
    def build(b):
        t = b.constant_wire(42)
        b.assert_zero(b.sub(t, b.constant_wire(42)))
        return t

    prove_and_verify(build, lambda w, t: None)


def test_proof_sum_public_inputs():
    """x + y = z with public inputs (reference: prove_and_verify.rs:54-... )."""
    def build(b):
        x = b.add_public_input()
        y = b.add_public_input()
        z = b.add(x, y)
        out = b.add_public_input()
        b.copy(z, out)
        return (x, y, out)

    def set_w(w, ts):
        x, y, out = ts
        w.set_target(x, 3)
        w.set_target(y, 39)
        w.set_target(out, 42)

    prove_and_verify(build, set_w, expected_pis=[3, 39, 42])


def test_proof_quadratic():
    """t^2 + t + 1 - 7 == 0 at t = 2 (reference quadratic test shape)."""
    def build(b):
        one = b.one_wire()
        t = b.add_virtual_target()
        t_sq = b.square(t)
        quad = b.add_many([one, t, t_sq])
        seven = b.constant_wire(7)
        res = b.sub(quad, seven)
        b.assert_zero(res)
        return t

    def set_w(w, t):
        w.set_target(t, 2)

    prove_and_verify(build, set_w)


def test_proof_with_old_proofs():
    """OldProof accumulation: proof A defers its linear G check
    (verify_g=False), and proof B -- over the same curve -- consumes it,
    opening A's g polynomial at its own zeta (reference:
    prove_and_verify.rs:30-52, which accumulates x10; two proofs exercise
    the same produce/consume path)."""
    builder = CircuitBuilder(TWEEDLEDEE, security_bits=128)
    t = builder.constant_wire(42)
    builder.assert_zero(builder.sub(t, builder.constant_wire(42)))
    circuit = builder.build()
    vk = circuit.to_vk()

    witness = circuit.generate_witness(PartialWitness())
    proof_a = generate_proof(circuit, witness, old_proofs=[], blinding=True)
    old_a = verify_proof([], proof_a, [], vk, TWEEDLEDUM, verify_g=False)
    assert old_a is not None and len(old_a.halo_us) == circuit.degree_pow()

    proof_b = generate_proof(circuit, witness, old_proofs=[old_a],
                             blinding=True)
    assert verify_proof([], proof_b, [old_a], vk, TWEEDLEDUM,
                        verify_g=True) is None


def test_proof_factorial():
    """4! == 24 with the result as a public input (reference factorial test
    shape, prove_and_verify.rs:54-225)."""
    def build(b):
        acc = b.one_wire()
        for k in range(2, 5):
            acc = b.mul(acc, b.constant_wire(k))
        out = b.add_public_input()
        b.copy(acc, out)
        return out

    prove_and_verify(build, lambda w, out: w.set_target(out, 24),
                     expected_pis=[24])


def test_proof_random_public_inputs():
    """More PIs than one PI gate holds (spillover into the buffer gate;
    reference: prove_and_verify.rs:228-283)."""
    rng = np.random.default_rng(99)
    vals = [int(x) for x in rng.integers(1, 1 << 30, 12)]

    def build(b):
        return [b.add_public_input() for _ in vals]

    def set_w(w, ts):
        for t, v in zip(ts, vals):
            w.set_target(t, v)

    prove_and_verify(build, set_w, expected_pis=vals)


def test_second_proof_no_retrace():
    """Proof #2 of the same circuit must perform ZERO new jit traces: every
    protocol-path jit is cached and challenges enter as runtime columns
    (fresh jax.jit(lambda) objects would defeat the cache)."""
    from plonky_tpu.utils import TRACE_COUNT

    builder = CircuitBuilder(TWEEDLEDEE, security_bits=128)
    t = builder.constant_wire(7)
    builder.assert_zero(builder.sub(t, builder.constant_wire(7)))
    circuit = builder.build()
    witness = circuit.generate_witness(PartialWitness())
    vk = circuit.to_vk()

    proof1 = generate_proof(circuit, witness, old_proofs=[], blinding=True)
    before = TRACE_COUNT[0]
    proof2 = generate_proof(circuit, witness, old_proofs=[], blinding=True)
    assert TRACE_COUNT[0] == before, \
        f"proof #2 performed {TRACE_COUNT[0] - before} new traces"
    for proof in (proof1, proof2):
        assert verify_proof([], proof, [], vk, TWEEDLEDUM,
                            verify_g=True) is None


def test_invalid_witness_rejected():
    from plonky_tpu.protocol import VerificationError

    def build(b):
        t = b.add_virtual_target()
        sq = b.square(t)
        b.copy(sq, b.constant_wire(9))
        return t

    builder = CircuitBuilder(TWEEDLEDEE, security_bits=128)
    t = build(builder)
    circuit = builder.build()
    inputs = PartialWitness()
    inputs.set_target(t, 3)
    witness = circuit.generate_witness(inputs)
    # tamper with the witness: break the square relation
    witness.wire_values[2][0] = 12345
    proof = generate_proof(circuit, witness, old_proofs=[], blinding=True)
    with pytest.raises(VerificationError):
        verify_proof(circuit.get_public_inputs(witness), proof, [],
                     circuit.to_vk(), TWEEDLEDUM, verify_g=True)
