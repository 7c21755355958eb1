"""Byte-level proof regression fixture.

The driver target asks for bit-exact outputs.  This environment ships no
Rust toolchain, so fixtures cannot be dumped from /root/reference by
running cargo; instead every externally-specified primitive is pinned to
PUBLIC vectors (BLAKE3 official vectors, ChaCha core vs OpenSSL --
tests/test_hashing.py), and the full deterministic proof bytes for the
trivial circuit (reference: tests/prove_and_verify.rs:18-26
test_proof_trivial, with blinding off / RNG pinned per SURVEY.md section 4)
are committed here and asserted byte-identical on every run.  Any change
to transcript order, encodings, Rescue constants, k_i shifts, or
OpeningSet::to_vec order (reference: src/plonk_proof.rs:299-312) breaks
this test.

Regenerate (after a DELIBERATE protocol change only):
    PLONKY_WRITE_FIXTURES=1 python -m pytest tests/test_proof_fixture.py
"""

import contextlib
import os

import numpy as np
import pytest

import plonky_tpu.circuit.builder as builder_mod
import plonky_tpu.protocol.halo as halo_mod
from plonky_tpu.circuit import CircuitBuilder, PartialWitness
from plonky_tpu.curves import TWEEDLEDEE, TWEEDLEDUM
from plonky_tpu.protocol import generate_proof, verify_proof
from plonky_tpu.protocol.serialization import (
    proof_from_bytes,
    proof_to_bytes,
    vk_to_bytes,
)

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures")


@contextlib.contextmanager
def pinned_rng():
    """Replace the blinding/commitment randomness with a seeded stream, so
    proofs are byte-deterministic; restores the real source on exit."""
    rng = np.random.default_rng(1337)

    def fake_random(p):
        return int.from_bytes(rng.bytes(40), "little") % p

    saved = builder_mod.RANDOM_SOURCE, halo_mod.RANDOM_SOURCE
    builder_mod.RANDOM_SOURCE = halo_mod.RANDOM_SOURCE = fake_random
    try:
        yield
    finally:
        builder_mod.RANDOM_SOURCE, halo_mod.RANDOM_SOURCE = saved


@pytest.fixture(autouse=True)
def pinned_randomness():
    with pinned_rng():
        yield


def _trivial_proof():
    builder = CircuitBuilder(TWEEDLEDEE, security_bits=128)
    t = builder.constant_wire(42)
    builder.assert_zero(builder.sub(t, builder.constant_wire(42)))
    circuit = builder.build()
    witness = circuit.generate_witness(PartialWitness())
    # blinding=True like the reference's test (its challenger, like ours,
    # rejects the zero commitments an unblinded all-zero wire poly yields);
    # the pinned RANDOM_SOURCE keeps the proof fully deterministic
    proof = generate_proof(circuit, witness, old_proofs=[], blinding=True)
    return circuit, proof, []


def _sum_pi_proof():
    """x + y = z with public inputs (reference: prove_and_verify.rs:54
    test_proof_sum workload)."""
    builder = CircuitBuilder(TWEEDLEDEE, security_bits=128)
    x = builder.add_public_input()
    y = builder.add_public_input()
    z = builder.add(x, y)
    out = builder.add_public_input()
    builder.copy(z, out)
    circuit = builder.build()
    inputs = PartialWitness()
    inputs.set_target(x, 3)
    inputs.set_target(y, 39)
    inputs.set_target(out, 42)
    witness = circuit.generate_witness(inputs)
    proof = generate_proof(circuit, witness, old_proofs=[], blinding=True)
    return circuit, proof, circuit.get_public_inputs(witness)


def _curve_add_gadget_proof():
    """In-circuit curve add of two fixed points, result exported as PIs
    (reference: prove_and_verify.rs:310 curve-gadget workload)."""
    from plonky_tpu.circuit.gadgets.curve import (
        constant_affine_point,
        curve_add,
    )
    from plonky_tpu.curves import host as chost

    g = chost.generator(TWEEDLEDUM)
    p1 = chost.mul(g, 7)
    p2 = chost.mul(g, 11)
    builder = CircuitBuilder(TWEEDLEDEE, security_bits=128)
    t1 = constant_affine_point(builder, p1)
    t2 = constant_affine_point(builder, p2)
    s = curve_add(builder, t1, t2)
    pix, piy = builder.add_public_input(), builder.add_public_input()
    builder.copy(s.x, pix)
    builder.copy(s.y, piy)
    circuit = builder.build()
    witness = circuit.generate_witness(PartialWitness())
    proof = generate_proof(circuit, witness, old_proofs=[], blinding=True)
    return circuit, proof, circuit.get_public_inputs(witness)


FIXTURES = {"trivial": _trivial_proof, "sum_pi": _sum_pi_proof,
            "curve_add": _curve_add_gadget_proof}


def _assert_fixture(name: str, make_proof):
    circuit, proof, pis = make_proof()
    got_proof = proof_to_bytes(TWEEDLEDEE, proof).hex()
    got_vk = vk_to_bytes(circuit.to_vk()).hex()

    proof_path = os.path.join(FIXTURE_DIR, f"proof_{name}.hex")
    vk_path = os.path.join(FIXTURE_DIR, f"vk_{name}.hex")
    if os.environ.get("PLONKY_WRITE_FIXTURES"):
        os.makedirs(FIXTURE_DIR, exist_ok=True)
        with open(proof_path, "w") as f:
            f.write(got_proof + "\n")
        with open(vk_path, "w") as f:
            f.write(got_vk + "\n")

    with open(proof_path) as f:
        want_proof = f.read().strip()
    with open(vk_path) as f:
        want_vk = f.read().strip()
    assert got_proof == want_proof, \
        f"proof bytes diverged from fixture {name}"
    assert got_vk == want_vk, f"vk bytes diverged from fixture {name}"

    # the fixture proof round-trips and verifies
    rt = proof_from_bytes(TWEEDLEDEE, bytes.fromhex(want_proof))
    assert verify_proof(pis, rt, [], circuit.to_vk(), TWEEDLEDUM,
                        verify_g=True) is None


def test_trivial_proof_bytes_match_fixture():
    _assert_fixture("trivial", _trivial_proof)


def test_sum_pi_proof_bytes_match_fixture():
    """Second fixture: exercises the PI gates, PI-quotient poly and PI
    transcript observation beyond the trivial circuit."""
    _assert_fixture("sum_pi", _sum_pi_proof)


def test_curve_add_gadget_proof_bytes_match_fixture():
    """Third fixture: exercises CurveAddGate constraints + generators and
    the gadget witness path."""
    _assert_fixture("curve_add", _curve_add_gadget_proof)
