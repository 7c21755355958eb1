"""The prover: generate_proof (reference: src/plonk.rs:84-456).

Pipeline (SURVEY.md section 3.3), device mapping:
  host transcript <-> device bulk math (FFT/LDE, MSM commitments, the
  8n-point vanishing-polynomial evaluation with all ten gates fused, the
  permutation-polynomial cumulative product, polynomial openings, IPA).
"""

from __future__ import annotations

import functools
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..circuit.algebra import BatchAlgebra
from ..circuit.gates import evaluate_all_constraints
from ..circuit.partition import get_subgroup_shift
from ..circuit.target import GRID_WIDTH, NUM_ROUTED_WIRES, NUM_WIRES
from ..circuit.witness import Witness
from ..fields import ops as fops
from ..hashing.challenger import Challenger
from ..poly.fft import (N_TABLES, coset_fft_t, coset_ifft_t, fft_t, ifft_t,
                        lde_t, powers_dyn)
from ..poly.polynomial import divide_by_z_h_t, eval_at_dyn, z_h_inverses_dev
from ..utils import cached_jit, ceil_div
from ..utils.timing import phase
from . import halo as halo_mod
from .circuit import Circuit, ints_to_device_matrix
from .plonk_util import try_convert
from .proof import OpeningSet, Proof

QUOTIENT_POLYNOMIAL_DEGREE_MULTIPLIER = 7


def _col(spec, v: int) -> jnp.ndarray:
    """Host int -> [D, 1] device digit column.  Per-proof challenges enter
    jitted graphs through these runtime columns so one traced program
    serves every proof of a circuit shape (no per-challenge re-trace)."""
    return jnp.asarray(
        np.asarray(spec.to_digits(v % spec.p), dtype=np.int32))[:, None]


def _div_zh(sf, n, c, zh_inv, *flat):
    return divide_by_z_h_t(sf, c, n, zh_inv, *flat)


@functools.lru_cache(maxsize=None)
def _div_zh_consts(circuit: Circuit):
    """Runtime buffers for the t = vanishing / Z_H division at 8n."""
    sf = circuit.spec
    n = circuit.degree()
    zh_inv = z_h_inverses_dev(sf, n, 8 * n)
    fwd = circuit.fft_8n.runtime_tables(False)
    inv = circuit.fft_8n.runtime_tables(True)
    return (zh_inv,) + fwd + inv


def generate_proof(circuit: Circuit, witness: Witness,
                   old_proofs: List = (), blinding: bool = True) -> Proof:
    curve = circuit.curve
    sf = circuit.spec
    bf = curve.base
    p = sf.p
    n = circuit.degree()
    challenger = Challenger(bf, circuit.security_bits)

    # FFT twiddles/bit-rev travel as runtime buffers (NOT program
    # constants): the constant-baked form makes every FFT-bearing graph
    # multi-MB, slow to compile and to cache.  One cached upload per
    # (size, direction) serves every graph.
    tab_n = circuit.fft_n.runtime_tables(False)
    tab_n_inv = circuit.fft_n.runtime_tables(True)
    tab_8n = circuit.fft_8n.runtime_tables(False)

    # --- wires -> polynomials -> 8n LDE (plonk.rs:93-97) -----------------
    with phase("prover.wire_ldes"):
        wire_values = witness.transpose()          # host [9][n]
        wires_dev = ints_to_device_matrix(sf, wire_values)   # [D, 9, n]
        wire_polys = cached_jit(ifft_t, circuit.fft_n)(wires_dev, *tab_n_inv)
        wires_8n = cached_jit(lde_t, circuit.fft_8n)(wire_polys, *tab_8n)

    # --- commit wires (plonk.rs:100-105) ----------------------------------
    with phase("prover.commit_wires"):
        c_wires = circuit.commit_engine.commit_many(
            wire_polys, blinding, halo_mod.RANDOM_SOURCE)

    num_pi_gates = ceil_div(circuit.num_public_inputs, NUM_WIRES)
    # wire polynomials with PI-gate rows zeroed (plonk.rs:109-118)
    wire_values_no_pis = [list(col) for col in wire_values]
    for w in wire_values_no_pis:
        for i in range(num_pi_gates):
            w[circuit.num_gates_without_pis + 2 * i] = 0
    wires_no_pis_dev = ints_to_device_matrix(sf, wire_values_no_pis)
    wire_polys_no_pis = cached_jit(ifft_t, circuit.fft_n)(
        wires_no_pis_dev, *tab_n_inv)

    # --- beta, gamma -------------------------------------------------------
    challenger.observe_affine_points([c.commitment for c in c_wires])
    beta_bf, gamma_bf = challenger.get_2_challenges()
    beta = try_convert(beta_bf, sf)
    gamma = try_convert(gamma_bf, sf)

    # --- permutation polynomial Z (plonk_util.rs:234-262) ------------------
    with phase("prover.z_poly"):
        z_values = _permutation_polynomial(circuit, wires_dev, beta, gamma)
        z_poly = cached_jit(ifft_t, circuit.fft_n)(z_values, *tab_n_inv)
        c_z = circuit.commit_engine.commit_many(
            z_poly[:, None], blinding, halo_mod.RANDOM_SOURCE)[0]

    challenger.observe_affine_point(c_z.commitment)
    alpha = try_convert(challenger.get_challenge(), sf)

    # --- vanishing polynomial at 8n points (plonk.rs:375-456) --------------
    with phase("prover.vanishing_poly"):
        vanishing_coeffs = _vanishing_poly(circuit, wires_8n, z_poly,
                                           alpha, beta, gamma)

    # --- t = vanishing / Z_H, split into 7 chunks (plonk.rs:170-197) --------
    with phase("prover.t_quotient"):
        t_coeffs = cached_jit(_div_zh, sf, n)(vanishing_coeffs,
                                              *_div_zh_consts(circuit))
        # split into 7 degree-n chunks (the quotient has degree < 7n)
        t_chunks = t_coeffs[:, :QUOTIENT_POLYNOMIAL_DEGREE_MULTIPLIER * n
                            ].reshape(
            sf.n_digits, QUOTIENT_POLYNOMIAL_DEGREE_MULTIPLIER, n)
        c_t = circuit.commit_engine.commit_many(
            t_chunks, blinding, halo_mod.RANDOM_SOURCE)

    # --- public-input quotient (plonk.rs:200-235) ---------------------------
    with phase("prover.pi_quotient"):
        pi_quotient_poly = _pi_quotient(circuit, wire_polys_no_pis, alpha,
                                        num_pi_gates)
        c_pi_quotient = circuit.commit_engine.commit_many(
            pi_quotient_poly[:, None], blinding, halo_mod.RANDOM_SOURCE)[0]

    public_inputs = circuit.get_public_inputs(witness)

    # --- zeta ---------------------------------------------------------------
    challenger.observe_affine_points([c.commitment for c in c_t])
    challenger.observe_affine_point(c_pi_quotient.commitment)
    challenger.observe_elements([try_convert(pi, bf) for pi in public_inputs])
    for old in old_proofs:
        challenger.observe_affine_point(old.halo_g)
    zeta = try_convert(challenger.get_challenge(), sf)

    # --- open all polynomials at zeta, g zeta, g^65 zeta (plonk.rs:260-284) -
    g = circuit.subgroup_generator_n
    opening_points = [
        zeta,
        zeta * g % p,
        zeta * pow(g, GRID_WIDTH, p) % p,
    ]
    old_g_polys = [ints_to_device_matrix(sf, [op.coeffs(sf)])[:, 0]
                   for op in old_proofs]
    all_polys = _stack_polys(circuit, wire_polys, z_poly, t_chunks,
                             old_g_polys, pi_quotient_poly)
    with phase("prover.openings"):
        opening_sets = [
            _open_all(circuit, all_polys, old_proofs, pt)
            for pt in opening_points
        ]
    o_local, o_right, o_below = opening_sets

    all_opened_bf = []
    for os_ in opening_sets:
        for f in os_.to_vec():
            all_opened_bf.append(try_convert(f, bf))
    challenger.observe_elements(all_opened_bf)
    v_bf, u_bf, u_scaling_bf = challenger.get_3_challenges()
    v = try_convert(v_bf, sf)
    u = try_convert(u_bf, sf)
    u_scaling = try_convert(u_scaling_bf, sf)

    # commitment randomness in OpeningSet::to_vec order
    all_randomness = ([c.randomness for c in circuit.c_constants]
                      + [c.randomness for c in circuit.c_s_sigmas]
                      + [c.randomness for c in c_wires]
                      + [c_z.randomness]
                      + [c.randomness for c in c_t]
                      + [0] * len(old_proofs)
                      + [c_pi_quotient.randomness])

    with phase("prover.ipa"):
        opening_proof = halo_mod.batch_opening_proof(
            None, all_polys, all_randomness, opening_points,
            circuit.commit_engine.g_dev, circuit.pedersen_h, circuit.u,
            u, v, u_scaling, n, circuit.security_bits, challenger, curve)

    return Proof(
        c_wires=[c.commitment for c in c_wires],
        c_plonk_z=c_z.commitment,
        c_plonk_t=[c.commitment for c in c_t],
        c_pis_quotient=c_pi_quotient.commitment,
        o_local=o_local,
        o_right=o_right,
        o_below=o_below,
        halo_l=opening_proof.halo_l,
        halo_r=opening_proof.halo_r,
        halo_g=opening_proof.halo_g,
        schnorr_proof=opening_proof.schnorr_proof,
    )


@functools.lru_cache(maxsize=None)
def _circuit_perm_consts(circuit: Circuit):
    """Per-circuit device constants for the Z computation (built once, not
    per proof: the host->device transfer of [D, 6, n] sigma values is real
    wall-clock)."""
    sf = circuit.spec
    subgroup = ints_to_device_matrix(sf, [circuit.subgroup_n])[:, 0]  # [D, n]
    sigma_dev = ints_to_device_matrix(sf, circuit.sigma_values_n)     # [D, 6, n]
    return subgroup, sigma_dev


def _perm_poly_body(sf, wires, subgroup_d, sigma_d, beta_col, gamma_col):
    """Z running product, fully on device: per-point numerator/denominator
    over the 6 routed wires, batched inverse, then a cumulative product
    (`_cumprod`) -- the chunked-scan formulation of the reference's
    sequential loop (plonk_util.rs:242-261).  beta/gamma are
    runtime [D, 1] columns: one trace serves all proofs."""
    num = None
    den = None
    for j in range(NUM_ROUTED_WIRES):
        w = wires[:, j]
        k_j = fops.constant(sf, get_subgroup_shift(sf, j), (1,))
        kb = fops.mul(sf, k_j, beta_col)
        s_id = fops.product_sum(sf, [(kb, fops.WORK_DB, subgroup_d, fops.WORK_DB, 1)])
        f_term = fops.product_sum(sf, [
            (w, fops.WORK_DB, None, 0, 1),
            (s_id, fops.WORK_DB, None, 0, 1),
            (gamma_col, fops.WORK_DB, None, 0, 1)])
        s_sig = fops.product_sum(sf, [
            (beta_col, fops.WORK_DB, sigma_d[:, j], fops.WORK_DB, 1)])
        g_term = fops.product_sum(sf, [
            (w, fops.WORK_DB, None, 0, 1),
            (s_sig, fops.WORK_DB, None, 0, 1),
            (gamma_col, fops.WORK_DB, None, 0, 1)])
        num = f_term if num is None else fops.mul(sf, num, f_term)
        den = g_term if den is None else fops.mul(sf, den, g_term)
    ratio = fops.mul(sf, num, fops.inverse(sf, den))
    # cumulative product, exclusive: Z_0 = 1, Z_i = prod_{l<i} ratio_l
    inclusive = _cumprod(sf, ratio)
    one = fops.constant(sf, 1, (1,))
    return jnp.concatenate([one, inclusive[:, :-1]], axis=-1)


def _cumprod(sf, x: jnp.ndarray) -> jnp.ndarray:
    """Inclusive cumulative product along the last axis of x [D, n] (n a
    power of two), as two sequential scans of ~sqrt(n) steps: running
    products inside chunks of W, then the exclusive prefix of the chunk
    totals, folded back in.  Three field-mul instances in the program,
    where an associative scan instantiates ~2 log2(n) at shrinking shapes."""
    D, n = x.shape
    W = 1 << ((n.bit_length() - 1 + 1) // 2)
    C = n // W
    xs = jnp.moveaxis(x.reshape(D, C, W), -1, 0)          # [W, D, C]

    def run(acc, v):
        acc = fops.mul(sf, acc, v)
        return acc, acc

    one = fops.constant(sf, 1, (C,))
    totals, within = jax.lax.scan(run, one, xs)           # [D, C], [W, D, C]
    _, incl = jax.lax.scan(run, fops.constant(sf, 1, (1,)),
                           jnp.moveaxis(totals, -1, 0)[..., None])
    prefix = jnp.concatenate(                             # exclusive [D, C]
        [fops.constant(sf, 1, (1,)), jnp.moveaxis(incl[:-1, :, 0], 0, -1)],
        axis=-1)
    within = jnp.transpose(within, (1, 2, 0))             # [D, C, W]
    return fops.mul(sf, within, prefix[..., None]).reshape(D, n)


def _permutation_polynomial(circuit: Circuit, wires_dev: jnp.ndarray,
                            beta: int, gamma: int) -> jnp.ndarray:
    sf = circuit.spec
    subgroup, sigma_dev = _circuit_perm_consts(circuit)
    return cached_jit(_perm_poly_body, sf)(
        wires_dev, subgroup, sigma_dev, _col(sf, beta), _col(sf, gamma))


@functools.lru_cache(maxsize=None)
def _circuit_vanishing_consts(circuit: Circuit):
    """subgroup_8n and x^n - 1 over it, as per-circuit device constants."""
    sf = circuit.spec
    p = sf.p
    n = circuit.degree()
    n8 = 8 * n
    g8 = circuit.subgroup_generator_8n
    subgroup_8n = [0] * n8
    cur = 1
    for i in range(n8):
        subgroup_8n[i] = cur
        cur = cur * g8 % p
    sub8_dev = ints_to_device_matrix(sf, [subgroup_8n])[:, 0]   # [D, 8n]
    # x^n over the 8n subgroup is 8-periodic: (g8^i)^n = (g8^n)^i
    g8n = pow(g8, n, p)
    xn_minus_1 = [(pow(g8n, i % 8, p) - 1) % p for i in range(n8)]
    xn_m1_dev = ints_to_device_matrix(sf, [xn_minus_1])[:, 0]
    return sub8_dev, xn_m1_dev


def _vanishing_body(circuit, wires8, z_coeffs, consts8, sigma8, sub8,
                    xn_m1_arr, alpha_col, beta_col, gamma_col, *tabs8):
    """Evaluate all filtered gate constraints + permutation terms at all 8n
    points, fold by powers of alpha, interpolate (reference: plonk.rs:375-456).
    This is the prover's biggest compute (SURVEY.md P4): one fused batched
    evaluation over the [8n] batch axis.  All per-proof challenges are
    runtime [D, 1] columns so the trace is reused across proofs."""
    sf = circuit.spec
    n = circuit.degree()
    n8 = 8 * n
    k8 = N_TABLES
    assert len(tabs8) == 2 * k8
    # z on the 8n domain, plus its g-shifted version (shift by 8)
    z8 = fft_t(circuit.fft_8n,
               jnp.pad(z_coeffs, [(0, 0), (0, n8 - z_coeffs.shape[-1])]),
               *tabs8[:k8])
    z8_right = jnp.roll(z8, -8, axis=-1)
    wires_right = jnp.roll(wires8, -8, axis=-1)
    wires_below = jnp.roll(wires8, -8 * GRID_WIDTH, axis=-1)

    alg = BatchAlgebra(sf, (n8,))
    lc = [alg.wrap(consts8[:, j]) for j in range(consts8.shape[1])]
    lw = [alg.wrap(wires8[:, j]) for j in range(NUM_WIRES)]
    rw = [alg.wrap(wires_right[:, j]) for j in range(NUM_WIRES)]
    bw = [alg.wrap(wires_below[:, j]) for j in range(NUM_WIRES)]

    constraint_terms = evaluate_all_constraints(alg, circuit.ctx,
                                                lc, lw, rw, bw)

    # L_1(x) (z(x) - 1), with L_1(x) = (x^n - 1) / (n (x - 1)) on device,
    # special-cased at x = 1 (index 0)
    one = alg.one()
    xn_m1 = alg.wrap(xn_m1_arr)
    x_m1 = alg.sub(alg.wrap(sub8), one)
    denom = alg.mul_const(n, x_m1)
    denom_inv = (fops.inverse(sf, alg.unwrap(denom)), fops.WORK_DB)
    l1 = alg.mul(xn_m1, denom_inv)
    # fix index 0 (x = 1): L_1(1) = 1.  1/(x-1) is inverse(0)=0 there, so
    # l1[0] is 0; add indicator to make it 1.
    ind = np.zeros(n8, dtype=np.int32)
    ind[0] = 1
    l1 = alg.add(l1, alg.wrap(
        fops.constant(sf, 1, (n8,)) * jnp.asarray(ind)))
    z_term = alg.mul(l1, alg.sub(alg.wrap(z8), one))

    # permutation f'/g' terms
    f_prime = one
    g_prime = one
    for j in range(NUM_ROUTED_WIRES):
        w = alg.wrap(wires8[:, j])
        k_j = fops.constant(sf, get_subgroup_shift(sf, j), (1,))
        kb = fops.mul(sf, k_j, beta_col)
        s_id = alg.mul((kb, fops.WORK_DB), alg.wrap(sub8))
        f_part = alg.add(w, alg.add(s_id, (gamma_col, fops.WORK_DB)))
        s_sig = alg.mul((beta_col, fops.WORK_DB), alg.wrap(sigma8[:, j]))
        g_part = alg.add(w, alg.add(s_sig, (gamma_col, fops.WORK_DB)))
        f_prime = alg.mul(f_prime, f_part)
        g_prime = alg.mul(g_prime, g_part)
    v_shift = alg.sub(alg.mul(f_prime, alg.wrap(z8)),
                      alg.mul(g_prime, alg.wrap(z8_right)))

    terms = [z_term, v_shift] + constraint_terms
    # fold by powers of alpha: one fused product-sum
    ap = powers_dyn(sf, alpha_col, len(terms))   # [D, n_terms]
    ps_terms = [(ap[:, i:i + 1], fops.WORK_DB, arr, db, 1)
                for i, (arr, db) in enumerate(terms)]
    vanishing_values = fops.product_sum(sf, ps_terms)
    return ifft_t(circuit.fft_8n, vanishing_values, *tabs8[k8:])


def _vanishing_poly(circuit: Circuit, wires_8n: jnp.ndarray,
                    z_poly: jnp.ndarray, alpha: int, beta: int,
                    gamma: int) -> jnp.ndarray:
    sf = circuit.spec
    sub8_dev, xn_m1_dev = _circuit_vanishing_consts(circuit)
    tabs8 = (circuit.fft_8n.runtime_tables(False)
             + circuit.fft_8n.runtime_tables(True))
    return cached_jit(_vanishing_body, circuit)(
        wires_8n, z_poly, circuit.constants_8n, circuit.s_sigma_values_8n,
        sub8_dev, xn_m1_dev, _col(sf, alpha), _col(sf, beta), _col(sf, gamma),
        *tabs8)


@functools.lru_cache(maxsize=None)
def _circuit_pi_denom_inv(circuit: Circuit, num_pi_gates: int) -> jnp.ndarray:
    """1 / prod_k (s h_i - x_k) over the coset, per circuit (the PI gate
    positions are fixed at build time)."""
    sf = circuit.spec
    p = sf.p
    n = circuit.degree()
    pi_points = [circuit.subgroup_n[circuit.num_gates_without_pis + 2 * i]
                 for i in range(num_pi_gates)]
    shift = sf.generator
    denom_vals = [1] * n
    cur_pts = [shift * h % p for h in circuit.subgroup_n]
    for xk in pi_points:
        for i in range(n):
            denom_vals[i] = denom_vals[i] * ((cur_pts[i] - xk) % p) % p
    from ..fields import host as fhost
    denom_inv = fhost.batch_inverse(sf, denom_vals) if pi_points else [1] * n
    return ints_to_device_matrix(sf, [denom_inv])[:, 0]


def _pi_quotient_body(circuit, wire_polys_no_pis, alpha_col, dinv, *tabs):
    """alpha-combination of no-PI wire polys, divided exactly by
    prod_k (X - x_k) over the PI gate points, via coset evaluate/divide
    (reference: plonk.rs:200-235 uses Newton polynomial division; the coset
    form is the FFT-shaped equivalent for an exact division)."""
    sf = circuit.spec
    shift = sf.generator
    k = N_TABLES
    assert len(tabs) == 2 * k
    ap = powers_dyn(sf, alpha_col, NUM_WIRES)   # [D, 9]
    vanishing_pis = fops.product_sum(sf, [
        (ap[:, j:j + 1], fops.WORK_DB, wire_polys_no_pis[:, j],
         fops.WORK_DB, 1)
        for j in range(NUM_WIRES)])
    vals = coset_fft_t(circuit.fft_n, vanishing_pis, shift, *tabs[:k])
    q_vals = fops.mul(sf, vals, dinv)
    return coset_ifft_t(circuit.fft_n, q_vals, shift, *tabs[k:])


def _pi_quotient(circuit: Circuit, wire_polys_no_pis: jnp.ndarray,
                 alpha: int, num_pi_gates: int) -> jnp.ndarray:
    sf = circuit.spec
    dinv = _circuit_pi_denom_inv(circuit, num_pi_gates)
    tabs = (circuit.fft_n.runtime_tables(False)
            + circuit.fft_n.runtime_tables(True))
    return cached_jit(_pi_quotient_body, circuit)(
        wire_polys_no_pis, _col(sf, alpha), dinv, *tabs)


def _stack_polys(circuit: Circuit, wire_polys, z_poly, t_chunks, old_g_polys,
                 pi_quotient_poly) -> jnp.ndarray:
    """All committed polynomials in OpeningSet::to_vec order: [D, K, n]."""
    cols = [circuit.constant_polynomials, circuit.s_sigma_polynomials,
            wire_polys, z_poly[:, None], t_chunks]
    if old_g_polys:
        cols.append(jnp.stack(old_g_polys, axis=1))
    cols.append(pi_quotient_poly[:, None])
    return jnp.concatenate(cols, axis=1)


def _open_all(circuit: Circuit, all_polys: jnp.ndarray, old_proofs,
              zeta: int) -> OpeningSet:
    """Evaluate every polynomial at zeta: inner products against the powers
    of zeta (reference: plonk.rs:458-482)."""
    sf = circuit.spec
    vals = cached_jit(eval_at_dyn, sf)(all_polys, _col(sf, zeta))
    ints = fops.to_ints(sf, vals)
    K = all_polys.shape[1]
    idx = 0

    def take(k):
        nonlocal idx
        out = [int(v) for v in ints[idx:idx + k]]
        idx += k
        return out

    o_constants = take(6)
    o_sigmas = take(6)
    o_wires = take(NUM_WIRES)
    o_z = take(1)[0]
    o_t = take(QUOTIENT_POLYNOMIAL_DEGREE_MULTIPLIER)
    o_old = take(len(old_proofs))
    o_pi = take(1)[0]
    assert idx == K
    return OpeningSet(o_constants=o_constants, o_plonk_sigmas=o_sigmas,
                      o_wires=o_wires, o_plonk_z=o_z, o_plonk_t=o_t,
                      o_old_proofs=o_old, o_pi_quotient=o_pi)
