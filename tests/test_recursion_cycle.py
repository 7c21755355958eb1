"""Full 2-level recursion cycle, CI'd.

Level 0: trivial circuit over Tweedledum -> proof P0.
Level 1: circuit over Tweedledee verifying P0 -> proof P1 (P0's linear
G-point check deferred as an OldProof over Tweedledee).
Level 2: circuit over Tweedledum verifying P1 AND re-checking (via
verify_assumptions) everything level 1 deferred about P0 -> proof P2,
which CONSUMES P0's OldProof.  P2 is verified natively with the full
linear G check, and the chain is terminated natively with
verify_assumptions_native on P2's exports -- no further circuits needed.

The reference's equivalent (tests/prove_and_verify_recursive.rs) is
#[ignore]d ("Fails for the moment"); this cycle actually closes.
Marked slow: proves two degree-2^15+ recursion circuits.
"""

import numpy as np
import pytest

import plonky_tpu.circuit.builder as builder_mod
import plonky_tpu.protocol.halo as halo_mod
from plonky_tpu.circuit import CircuitBuilder, PartialWitness
from plonky_tpu.circuit.gates import BufferGate
from plonky_tpu.curves import TWEEDLEDEE, TWEEDLEDUM
from plonky_tpu.protocol import generate_proof, verify_proof
from plonky_tpu.protocol.recursion import (
    recursive_verification_circuit,
    verify_assumptions_native,
)

INNER_DEGREE_POW = 8


@pytest.fixture(autouse=True)
def pinned_randomness(monkeypatch):
    rng = np.random.default_rng(299792458)

    def fake_random(p):
        return int.from_bytes(rng.bytes(40), "little") % p

    monkeypatch.setattr(builder_mod, "RANDOM_SOURCE", fake_random)
    monkeypatch.setattr(halo_mod, "RANDOM_SOURCE", fake_random)
    yield


@pytest.mark.slow
def test_two_level_recursion_cycle():
    # --- level 0: inner proof over Tweedledum -------------------------------
    builder = CircuitBuilder(TWEEDLEDUM, security_bits=128)
    while builder.num_gates() < (1 << INNER_DEGREE_POW) - 3:
        builder.add_gate_no_constants(BufferGate(builder.num_gates()))
    inner_circuit = builder.build(inner_curve=TWEEDLEDEE)
    inner_witness = inner_circuit.generate_witness(PartialWitness())
    inner_proof = generate_proof(inner_circuit, inner_witness,
                                 old_proofs=[], blinding=True)
    inner_vk = inner_circuit.to_vk()
    # defer the linear G check: P0's OldProof rides the level-2 proof
    old0 = verify_proof([], inner_proof, [], inner_vk, TWEEDLEDEE,
                        verify_g=False)
    assert old0 is not None

    # --- level 1: Tweedledee circuit verifying P0 ---------------------------
    rc1 = recursive_verification_circuit(
        TWEEDLEDEE, TWEEDLEDUM, inner_circuit.degree_pow(),
        security_bits=128, num_public_inputs=0, num_old_proofs=0,
        inner_vk=inner_vk)
    inputs1 = PartialWitness()
    rc1.proof.populate_witness(inputs1, inner_proof, [])
    w1 = rc1.circuit.generate_witness(inputs1)
    pis1 = rc1.circuit.get_public_inputs(w1)
    proof1 = generate_proof(rc1.circuit, w1, old_proofs=[], blinding=True)
    vk1 = rc1.circuit.to_vk()
    old1 = verify_proof(pis1, proof1, [], vk1, TWEEDLEDUM, verify_g=False)
    assert old1 is not None

    # --- level 2: Tweedledum circuit verifying P1, consuming P0's OldProof --
    inner_recursion_desc = {
        "degree_pow": inner_circuit.degree_pow(),
        "num_old_proofs": 0,
        "num_inner_pis": 0,
        "num_gates_without_pis": inner_vk.num_gates_without_pis,
    }
    rc2 = recursive_verification_circuit(
        TWEEDLEDUM, TWEEDLEDEE, rc1.circuit.degree_pow(),
        security_bits=128, num_public_inputs=len(pis1), num_old_proofs=0,
        inner_vk=vk1, inner_recursion=inner_recursion_desc)
    inputs2 = PartialWitness()
    rc2.proof.populate_witness(inputs2, proof1, pis1)
    w2 = rc2.circuit.generate_witness(inputs2)
    pis2 = rc2.circuit.get_public_inputs(w2)
    proof2 = generate_proof(rc2.circuit, w2, old_proofs=[old0],
                            blinding=True)
    vk2 = rc2.circuit.to_vk()
    # full linear G check on P2 (chain ends here)
    assert verify_proof(pis2, proof2, [old0], vk2, TWEEDLEDEE,
                        verify_g=True) is None

    # --- native termination -------------------------------------------------
    # P1's own G-point: closed natively (its OldProof would ride level 3).
    assert verify_proof(pis1, proof1, [], vk1, TWEEDLEDUM,
                        verify_g=True) is None
    # Everything level 2 deferred about P1's openings: the host-native
    # terminal check (no throwaway circuit).
    verify_assumptions_native(
        pis2, TWEEDLEDEE, TWEEDLEDUM, rc1.circuit.degree_pow(),
        num_inner_pis=len(pis1),
        num_gates_without_pis=vk1.num_gates_without_pis)
