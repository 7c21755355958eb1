"""Plookup protocol (reference: plookup/src/plookup.rs; protocol of
ia.cr/2020/315): proves a multiset `f` is contained in a table `t`.

Bulk polynomial work (FFTs, commitments, the 4(n+1)-domain vanishing
evaluation, the Halo opening) runs on device; the grand-product and sorting
are host-side (small, data-dependent)."""

from __future__ import annotations

import functools

from dataclasses import dataclass
from typing import List, Tuple

import jax
import jax.numpy as jnp

from ..curves import host as chost
from ..curves.spec import CurveSpec
from ..fields import host as fhost
from ..fields import ops as fops
from ..hashing.challenger import Challenger
from ..hashing.hash_to_curve import blake_hash_usize_to_curve
from ..poly.fft import FftPrecomputation, fft, ifft, powers_dyn
from ..poly.polynomial import z_h_inverses_dev
from ..protocol import halo as halo_mod
from ..protocol.circuit import CommitmentEngine, ints_to_device_matrix
from ..protocol.plonk_util import reduce_with_powers, try_convert
from ..utils import log2_strict
from .proof import PlookupOpenings, PlookupProof, Opening

SECURITY_BITS = 128


def padded(s: List[int], n: int) -> List[int]:
    return list(s) + [0] * (n - len(s))


def pad_inputs(f: List[int], t: List[int]) -> Tuple[int, List[int], List[int]]:
    """reference: plookup.rs:157-167."""
    d = len(t)
    if len(f) + 1 < d:
        f = padded(f, d - 1)
    else:
        f = list(f)
    n = 1
    while n < len(f):
        n *= 2
    n -= 1 if n == len(f) else 0
    # next_power_of_two(len(f)) - 1
    npow = 1
    while npow < max(len(f), 1):
        npow *= 2
    n = npow - 1
    f = padded(f, n)
    t = padded(t, n + 1)
    return n, f, t


def sort_by(f: List[int], t: List[int]) -> List[int]:
    """Sort f by the order its elements appear in t (reference: :170-177)."""
    pos = {}
    for i, x in enumerate(t):
        if x not in pos:
            pos[x] = i
    return sorted(f, key=lambda a: pos[a])


def grand_polynomial(p: int, f, t, s, beta: int, gamma: int) -> List[int]:
    """The Plookup grand product Z (reference: :180-202)."""
    n = len(f)
    values = [1]
    beta1 = (beta + 1) % p
    gamma_beta1 = gamma * beta1 % p
    beta1_pow = beta1
    prod_a = (gamma + f[0]) % p
    prod_b = (gamma_beta1 + t[0] + beta * t[1]) % p
    prod_c = (gamma_beta1 + s[0] + beta * s[1]) % p \
        * ((gamma_beta1 + s[n] + beta * s[n + 1]) % p) % p
    for i in range(1, n):
        values.append(beta1_pow * prod_a % p * prod_b % p
                      * pow(prod_c, -1, p) % p)
        beta1_pow = beta1_pow * beta1 % p
        prod_a = prod_a * ((gamma + f[i]) % p) % p
        prod_b = prod_b * ((gamma_beta1 + t[i] + beta * t[i + 1]) % p) % p
        prod_c = prod_c * ((gamma_beta1 + s[i] + beta * s[i + 1]) % p) % p \
            * ((gamma_beta1 + s[n + i] + beta * s[n + i + 1]) % p) % p
    values.append(1)
    return values


def eval_l_i(spec, n: int, i: int, generator: int, x: int) -> int:
    """L_i(x) = w^i (x^n - 1) / (n (x - w^i)) (reference: :275-284)."""
    p = spec.p
    g = pow(generator, i, p)
    if x % p == g:
        return 0
    num = g * ((pow(x, n, p) - 1) % p) % p
    den = n % p * ((x - g) % p) % p
    return num * pow(den, -1, p) % p


def prove(curve: CurveSpec, f: List[int], t: List[int]) -> PlookupProof:
    """reference: plookup.rs:16-153."""
    sf = curve.scalar
    bf = curve.base
    p = sf.p
    n, f, t = pad_inputs(f, t)

    s = sort_by(list(f) + list(t), t)

    challenger = Challenger(bf, SECURITY_BITS)
    pre = FftPrecomputation(sf, n + 1)

    f_padded = padded(f, n + 1)
    polys_vals = ints_to_device_matrix(sf, [f_padded, t, s[:n + 1], s[n:]])
    from ..utils import cached_jit
    polys = cached_jit(ifft, pre)(polys_vals)  # [D, 4, n+1]

    gs = [blake_hash_usize_to_curve(curve, i) for i in range(2 * n + 2)]
    h = blake_hash_usize_to_curve(curve, 2 * n + 2)
    u_curve = blake_hash_usize_to_curve(curve, 2 * n + 3)
    engine_small = CommitmentEngine(curve, gs[:n + 1], h)
    engine_big = CommitmentEngine(curve, gs, h)

    rand = halo_mod.RANDOM_SOURCE
    c_f = engine_small.commit_many(polys[:, 0:1], True, rand)[0]
    c_t = engine_small.commit_many(polys[:, 1:2], False, rand)[0]
    c_h1 = engine_small.commit_many(polys[:, 2:3], True, rand)[0]
    c_h2 = engine_small.commit_many(polys[:, 3:4], True, rand)[0]

    challenger.observe_affine_points([c_f.commitment, c_t.commitment,
                                      c_h1.commitment, c_h2.commitment])
    beta_bf, gamma_bf = challenger.get_2_challenges()
    beta = try_convert(beta_bf, sf)
    gamma = try_convert(gamma_bf, sf)

    z_values = grand_polynomial(p, f, t, s, beta, gamma)
    z_poly = cached_jit(ifft, pre)(
        ints_to_device_matrix(sf, [z_values]))[:, 0]
    c_z = engine_small.commit_many(z_poly[:, None], True, rand)[0]

    challenger.observe_affine_point(c_z.commitment)
    alpha = try_convert(challenger.get_challenge(), sf)

    vanishing = _vanishing_polynomial(sf, polys, z_poly, beta, gamma, alpha, n)
    from ..protocol.prover import _div_zh
    quotient = cached_jit(_div_zh, sf, n + 1)(vanishing,
                                              *_quotient_consts(sf, n))
    quotient = quotient[:, :2 * n + 2]
    c_quotient = engine_big.commit_many(quotient[:, None], True, rand)[0]

    challenger.observe_affine_point(c_quotient.commitment)
    zeta = try_convert(challenger.get_challenge(), sf)

    generator = fhost.primitive_root_of_unity(sf, log2_strict(n + 1))
    openings = _open_all(sf, polys, z_poly, quotient, zeta, generator)

    challenger.observe_elements(
        [try_convert(x, bf) for x in openings.to_vec()])
    v_bf, u_bf, us_bf = challenger.get_3_challenges()
    v = try_convert(v_bf, sf)
    u = try_convert(u_bf, sf)
    u_scaling = try_convert(us_bf, sf)

    # pad all six polys to 2n+2 coefficients
    def pad_poly(q):
        return jnp.pad(q, [(0, 0), (0, 2 * n + 2 - q.shape[-1])])

    all_coeffs = jnp.stack([
        pad_poly(polys[:, 0]), pad_poly(polys[:, 1]), pad_poly(polys[:, 2]),
        pad_poly(polys[:, 3]), pad_poly(z_poly), quotient], axis=1)
    randomness = [c_f.randomness, c_t.randomness, c_h1.randomness,
                  c_h2.randomness, c_z.randomness, c_quotient.randomness]

    halo_proof = halo_mod.batch_opening_proof(
        None, all_coeffs, randomness, [zeta, zeta * generator % p],
        engine_big.g_dev, h, u_curve, u, v, u_scaling, 2 * n + 2,
        SECURITY_BITS, challenger, curve)

    return PlookupProof(
        c_f=c_f.commitment, c_t=c_t.commitment, c_h1=c_h1.commitment,
        c_h2=c_h2.commitment, c_z=c_z.commitment,
        c_quotient=c_quotient.commitment, openings=openings,
        halo_proof=halo_proof, n=n)


@functools.lru_cache(maxsize=None)
def _quotient_consts(sf, n: int):
    """Runtime buffers for quotient = vanishing / Z_H on the 4(n+1) domain:
    1/Z_H on the coset, then the forward and inverse FFT tables."""
    pre4 = FftPrecomputation(sf, 4 * (n + 1))
    return ((z_h_inverses_dev(sf, n + 1, 4 * (n + 1)),)
            + pre4.runtime_tables(False) + pre4.runtime_tables(True))


@functools.lru_cache(maxsize=None)
def _vanishing_consts(sf, n: int):
    """Per-(field, size) host constants of the 4(n+1) vanishing domain."""
    p = sf.p
    order = 4 * (n + 1)
    g4 = fhost.primitive_root_of_unity(sf, log2_strict(order))
    gen = pow(g4, 4, p)  # generator of the (n+1) subgroup
    sub4 = fhost.cyclic_subgroup_known_order(sf, g4, order)
    l0 = [eval_l_i(sf, n + 1, 0, gen, x) for x in sub4]
    ln = [eval_l_i(sf, n + 1, n, gen, x) for x in sub4]
    gn = pow(gen, n, p)
    x_m_gn = [(x - gn) % p for x in sub4]
    return (ints_to_device_matrix(sf, [l0])[:, 0],
            ints_to_device_matrix(sf, [ln])[:, 0],
            ints_to_device_matrix(sf, [x_m_gn])[:, 0])


def _vanishing_body(sf, n, polys_, z_, l0_d, ln_d, xg_d,
                    beta_col, gamma_col, alpha_col):
    order = 4 * (n + 1)
    pre4 = FftPrecomputation(sf, order)

    def lde(q):
        pad = [(0, 0)] * (q.ndim - 1) + [(0, order - q.shape[-1])]
        return fft(pre4, jnp.pad(q, pad))
    f4 = lde(polys_[:, 0:1])[:, 0]
    t4 = lde(polys_[:, 1:2])[:, 0]
    h14 = lde(polys_[:, 2:3])[:, 0]
    h24 = lde(polys_[:, 3:4])[:, 0]
    z4 = lde(z_[:, None])[:, 0]

    def sh(a):  # shift by one subgroup step (4 on this domain)
        return jnp.roll(a, -4, axis=-1)

    one = fops.constant(sf, 1, (order,))
    # beta + 1 and gamma * (beta + 1) as runtime columns
    beta1_col = fops.add(sf, beta_col, fops.constant(sf, 1, (1,)))
    gb1_col = fops.mul(sf, gamma_col, beta1_col)

    def addc(a, b):
        return fops.add(sf, a, b)

    def mulc(a, b):
        return fops.mul(sf, a, b)

    def cmul(col, a):  # runtime-column multiply
        return fops.product_sum(sf, [(col, fops.WORK_DB, a, fops.WORK_DB, 1)])

    z1_term = mulc(l0_d, fops.sub(sf, z4, one))
    t_shift = addc(gb1_col, addc(t4, cmul(beta_col, sh(t4))))
    lhs = mulc(mulc(cmul(beta1_col, mulc(xg_d, z4)),
                    addc(gamma_col, f4)), t_shift)
    h1_t = addc(gb1_col, addc(h14, cmul(beta_col, sh(h14))))
    h2_t = addc(gb1_col, addc(h24, cmul(beta_col, sh(h24))))
    rhs = mulc(mulc(mulc(xg_d, sh(z4)), h1_t), h2_t)
    shift_term = fops.sub(sf, lhs, rhs)
    hs_term = mulc(ln_d, fops.sub(sf, h14, sh(h24)))
    last_term = mulc(ln_d, fops.sub(sf, z4, one))

    # fold with powers of alpha
    terms = [z1_term, shift_term, hs_term, last_term]
    ap = powers_dyn(sf, alpha_col, len(terms))
    ps = [(ap[:, i:i + 1], fops.WORK_DB, tm, fops.WORK_DB, 1)
          for i, tm in enumerate(terms)]
    vals = fops.product_sum(sf, ps)
    return ifft(pre4, vals)


def _vanishing_polynomial(sf, polys, z_poly, beta, gamma, alpha, n):
    """Evaluate the Plookup vanishing identity on the 4(n+1) domain
    (reference: plookup.rs:205-271).  Challenges enter as runtime columns
    so one trace serves all lookups of a size."""
    from ..protocol.prover import _col
    from ..utils import cached_jit
    l0_d, ln_d, xg_d = _vanishing_consts(sf, n)
    return cached_jit(_vanishing_body, sf, n)(
        polys, z_poly, l0_d, ln_d, xg_d,
        _col(sf, beta), _col(sf, gamma), _col(sf, alpha))


def _open_all(sf, polys, z_poly, quotient, zeta, generator) -> PlookupOpenings:
    from ..poly.polynomial import eval_at_dyn
    from ..protocol.prover import _col
    from ..utils import cached_jit
    p = sf.p
    right = zeta * generator % p

    def ev(q, pt):
        return fops.to_ints(sf, cached_jit(eval_at_dyn, sf)(q, _col(sf, pt)))

    local = ev(polys, zeta)      # [4]
    rightv = ev(polys, right)
    z_l = ev(z_poly[:, None], zeta)[0]
    z_r = ev(z_poly[:, None], right)[0]
    q_l = ev(quotient[:, None], zeta)[0]
    q_r = ev(quotient[:, None], right)[0]
    return PlookupOpenings(
        f=Opening(int(local[0]), int(rightv[0])),
        t=Opening(int(local[1]), int(rightv[1])),
        h1=Opening(int(local[2]), int(rightv[2])),
        h2=Opening(int(local[3]), int(rightv[3])),
        z=Opening(z_l, z_r),
        quotient=Opening(q_l, q_r),
    )


def verify(curve: CurveSpec, t: List[int], proof: PlookupProof):
    """reference: plookup/src/verifier.rs."""
    from ..protocol.halo import verify_ipa
    from ..protocol.plonk_util import (
        halo_g,
        halo_n,
        halo_n_mul,
        powers,
        scalar_to_bits_le,
    )

    sf = curve.scalar
    p = sf.p
    n = proof.n
    t = padded(t, n + 1)
    pre = FftPrecomputation(sf, n + 1)
    gs = [blake_hash_usize_to_curve(curve, i) for i in range(2 * n + 2)]
    h = blake_hash_usize_to_curve(curve, 2 * n + 2)
    u_curve = blake_hash_usize_to_curve(curve, 2 * n + 3)

    from ..utils import cached_jit
    t_coeffs = cached_jit(ifft, pre)(
        ints_to_device_matrix(sf, [t]))
    engine = CommitmentEngine(curve, gs[:n + 1], h)
    c_t = engine.commit_many(t_coeffs, False, None)[0]
    if c_t.commitment != proof.c_t:
        raise ValueError("Incorrect table commitment")

    ch = proof.get_challenges(curve)
    generator = fhost.primitive_root_of_unity(sf, log2_strict(n + 1))
    beta, gamma, alpha, zeta = ch.beta, ch.gamma, ch.alpha, ch.zeta
    beta1 = (beta + 1) % p
    gamma_beta1 = gamma * beta1 % p
    o = proof.openings

    z1_term = eval_l_i(sf, n + 1, 0, generator, zeta) * ((o.z.local - 1) % p) % p
    gn = pow(generator, n, p)
    lhs = (zeta - gn) % p * o.z.local % p * beta1 % p \
        * ((gamma + o.f.local) % p) % p \
        * ((gamma_beta1 + o.t.local + beta * o.t.right) % p) % p
    rhs = (zeta - gn) % p * o.z.right % p \
        * ((gamma_beta1 + o.h1.local + beta * o.h1.right) % p) % p \
        * ((gamma_beta1 + o.h2.local + beta * o.h2.right) % p) % p
    shift_term = (lhs - rhs) % p
    eval_last = eval_l_i(sf, n + 1, n, generator, zeta)
    hs_term = eval_last * ((o.h1.local - o.h2.right) % p) % p
    last_term = eval_last * ((o.z.local - 1) % p) % p

    numerator = reduce_with_powers(sf, [z1_term, shift_term, hs_term,
                                        last_term], alpha)
    denominator = (pow(zeta, n + 1, p) - 1) % p
    if numerator * pow(denominator, -1, p) % p != o.quotient.local:
        raise ValueError("Incorrect quotient opening")

    c_all = [proof.c_f, proof.c_t, proof.c_h1, proof.c_h2, proof.c_z,
             proof.c_quotient]
    actual_scalars = [halo_n(curve, scalar_to_bits_le(pu, SECURITY_BITS))
                      for pu in powers(sf, ch.u, len(c_all))]
    c_reduction = chost.zero_point(curve)
    for c, sc in zip(c_all, actual_scalars):
        c_reduction = chost.add(c_reduction, chost.mul(c, sc))
    red_local = sum(a * b for a, b in zip(actual_scalars, o.local())) % p
    red_right = sum(a * b for a, b in zip(actual_scalars, o.right())) % p
    reduced_opening = reduce_with_powers(sf, [red_local, red_right], ch.v)
    u_prime = halo_n_mul(curve, scalar_to_bits_le(ch.u_scaling, SECURITY_BITS),
                         u_curve)
    halo_bs = [halo_g(sf, pt, ch.halo_us)
               for pt in (zeta, zeta * generator % p)]
    halo_b = reduce_with_powers(sf, halo_bs, ch.v)
    ok = verify_ipa(curve, proof.halo_proof.halo_l, proof.halo_proof.halo_r,
                    proof.halo_proof.halo_g, c_reduction, reduced_opening,
                    halo_b, ch.halo_us, u_prime, h, ch.schnorr_challenge,
                    proof.halo_proof.schnorr_proof)
    if not ok:
        raise ValueError("Invalid IPA proof.")
