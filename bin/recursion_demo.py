"""End-to-end recursion demo (reference: src/bin/recursion.rs).

Flow: build an inner circuit -> prove it -> verify natively -> build the
recursion circuit (verifier-in-a-circuit over the cycle partner, with the
REAL inner vk wired in, unlike the reference's dummy points) -> generate the
recursion witness -> prove the recursion circuit -> verify THAT proof
natively, carrying the inner proof's G-point as a deferred OldProof check.

Prints per-phase timings, like the reference binary.

Usage: python bin/recursion_demo.py [--inner-degree-pow N] [--check-only]
  --check-only stops after host constraint checking (no recursive proving;
  useful on machines where device compiles are slow).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--inner-degree-pow", type=int, default=8)
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (the persistent compilation "
                    "cache makes repeat runs fast)")
    ap.add_argument("--levels", type=int, default=1, choices=(1, 2),
                    help="2 = full cycle: prove the level-1 recursion proof, "
                    "then a level-2 circuit over the partner curve verifies "
                    "it (verify_assumptions re-checks everything level 1 "
                    "deferred) while consuming the inner proof's OldProof")
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import plonky_tpu
    plonky_tpu.enable_compilation_cache()

    from plonky_tpu.circuit import CircuitBuilder, PartialWitness
    from plonky_tpu.circuit.gates import BufferGate
    from plonky_tpu.curves import TWEEDLEDEE, TWEEDLEDUM
    from plonky_tpu.protocol import generate_proof, verify_proof
    from plonky_tpu.protocol.checks import check_circuit_constraints
    from plonky_tpu.protocol.proof import OldProof
    from plonky_tpu.protocol.recursion import recursive_verification_circuit

    def phase(name):
        print(f"{name}...", flush=True)
        return time.time()

    def done(t0):
        print(f"  finished in {time.time() - t0:.2f}s", flush=True)

    # --- inner circuit: trivial, padded to the requested degree ----------
    t0 = phase("Generating inner circuit")
    builder = CircuitBuilder(TWEEDLEDUM, security_bits=128)
    while builder.num_gates() < (1 << args.inner_degree_pow) - 3:
        builder.add_gate_no_constants(BufferGate(builder.num_gates()))
    inner_circuit = builder.build(inner_curve=TWEEDLEDEE)
    done(t0)

    t0 = phase("Generating inner witness")
    inner_witness = inner_circuit.generate_witness(PartialWitness())
    done(t0)

    t0 = phase("Generating inner proof")
    inner_proof = generate_proof(inner_circuit, inner_witness,
                                 old_proofs=[], blinding=True)
    done(t0)

    t0 = phase("Verifying inner proof")
    inner_vk = inner_circuit.to_vk()
    # OldProof chaining: the inner proof's deferred G-point check is an
    # OldProof over Tweedledum, so it can only be carried by the next
    # Tweedledum-side proof -- the 2-cycle alternates.  At --levels 2 that
    # is the level-2 proof, which consumes it below; at --levels 1 we pay
    # the linear G check here instead.
    old0 = verify_proof([], inner_proof, [], inner_vk, TWEEDLEDEE,
                        verify_g=(args.levels == 1))
    done(t0)

    t0 = phase("Generating recursion circuit")
    rc = recursive_verification_circuit(
        TWEEDLEDEE, TWEEDLEDUM, inner_circuit.degree_pow(),
        security_bits=128, num_public_inputs=0, num_old_proofs=0,
        inner_vk=inner_vk, light=args.check_only)
    done(t0)
    print(f"  gate count: {rc.circuit.degree()}")

    t0 = phase("Generating recursion witness")
    inputs = PartialWitness()
    rc.proof.populate_witness(inputs, inner_proof, [])
    recursion_witness = rc.circuit.generate_witness(inputs)
    done(t0)

    t0 = phase("Checking recursion circuit constraints (host)")
    check_circuit_constraints(rc.circuit, recursion_witness)
    done(t0)

    pis1 = rc.circuit.get_public_inputs(recursion_witness)
    inner_recursion_desc = {
        "degree_pow": inner_circuit.degree_pow(),
        "num_old_proofs": 0,
        "num_inner_pis": 0,
        "num_gates_without_pis": inner_vk.num_gates_without_pis,
    }

    if args.check_only:
        if args.levels == 2:
            # Cheap wiring validation of the level-2 deferred checks: a
            # circuit containing only verify_assumptions, fed the level-1
            # circuit's real exported public inputs.
            t0 = phase("Checking level-2 verify_assumptions (host)")
            from plonky_tpu.protocol.recursion import verify_assumptions
            b2 = CircuitBuilder(TWEEDLEDUM, security_bits=128)
            pi_targets = b2.add_virtual_targets(len(pis1))
            verify_assumptions(b2, TWEEDLEDEE, inner_circuit.degree_pow(),
                               pi_targets,
                               num_gates_without_pis=(
                                   inner_vk.num_gates_without_pis))
            c2 = b2.build(inner_curve=TWEEDLEDEE, light=True)
            inputs2 = PartialWitness()
            inputs2.set_targets(pi_targets, pis1)
            w2 = c2.generate_witness(inputs2)
            check_circuit_constraints(c2, w2)
            done(t0)
        print("check-only: all recursion constraints satisfied; skipping "
              "recursive proof generation")
        return

    t0 = phase("Generating level-1 recursion proof")
    recursion_proof = generate_proof(rc.circuit, recursion_witness,
                                     old_proofs=[], blinding=True)
    done(t0)

    t0 = phase("Verifying level-1 recursion proof")
    print(f"  number of public inputs: {rc.circuit.num_public_inputs}")
    vk1 = rc.circuit.to_vk()
    # At --levels 2 the linear G check of the level-1 proof is deferred too;
    # its OldProof (over Tweedledee) would ride the NEXT Tweedledee-side
    # proof (level 3).  We close it natively at the end instead.
    old1 = verify_proof(pis1, recursion_proof, [], vk1, TWEEDLEDUM,
                        verify_g=(args.levels == 1))
    done(t0)
    print("Level-1 recursive proof verified.")

    if args.levels == 1:
        return

    t0 = phase("Generating level-2 recursion circuit")
    rc2 = recursive_verification_circuit(
        TWEEDLEDUM, TWEEDLEDEE, rc.circuit.degree_pow(),
        security_bits=128, num_public_inputs=len(pis1), num_old_proofs=0,
        inner_vk=vk1, inner_recursion=inner_recursion_desc)
    done(t0)
    print(f"  gate count: {rc2.circuit.degree()}")

    t0 = phase("Generating level-2 recursion witness")
    inputs2 = PartialWitness()
    rc2.proof.populate_witness(inputs2, recursion_proof, pis1)
    w2 = rc2.circuit.generate_witness(inputs2)
    done(t0)

    t0 = phase("Checking level-2 circuit constraints (host)")
    check_circuit_constraints(rc2.circuit, w2)
    done(t0)

    t0 = phase("Generating level-2 recursion proof (consuming inner OldProof)")
    proof2 = generate_proof(rc2.circuit, w2, old_proofs=[old0],
                            blinding=True)
    done(t0)

    t0 = phase("Verifying level-2 recursion proof")
    pis2 = rc2.circuit.get_public_inputs(w2)
    vk2 = rc2.circuit.to_vk()
    verify_proof(pis2, proof2, [old0], vk2, TWEEDLEDEE, verify_g=True)
    done(t0)

    t0 = phase("Closing the level-1 OldProof natively (final G check)")
    verify_proof(pis1, recursion_proof, [], vk1, TWEEDLEDUM, verify_g=True)
    done(t0)

    t0 = phase("Terminating the chain natively (verify_assumptions_native)")
    # Everything level 2 deferred about the level-1 proof's openings,
    # re-checked with host arithmetic -- no level-3 circuit needed.
    from plonky_tpu.protocol.recursion import verify_assumptions_native
    verify_assumptions_native(
        pis2, TWEEDLEDEE, TWEEDLEDUM, rc.circuit.degree_pow(),
        num_inner_pis=len(pis1),
        num_gates_without_pis=vk1.num_gates_without_pis)
    done(t0)
    print("Level-2 recursive proof verified; full cycle closed.")


if __name__ == "__main__":
    main()
