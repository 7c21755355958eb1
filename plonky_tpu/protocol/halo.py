"""Halo inner-product argument: batched opening proof and verification
(reference: src/halo.rs).

Host drives the sequential log(n) round structure and the transcript /
retry loop (blinding until n(r) is a square, reference: halo.rs:82-114);
the vector work per round (inner products, scalar combinations, MSMs, G
folding) runs on device.
"""

from __future__ import annotations

import functools
import secrets
from dataclasses import dataclass
from typing import List

import jax
import jax.numpy as jnp

from ..curves import host as chost
from ..curves import msm as cmsm
from ..curves import ops as cops
from ..curves.spec import CurveSpec
from ..fields import host as fhost
from ..fields import ops as fops
from ..poly.fft import powers_dyn
from .plonk_util import (
    halo_n,
    halo_n_mul,
    powers,
    reduce_with_powers,
    scalar_to_bits_le,
    try_convert,
)
from .proof import SchnorrProof

# Deterministic-test hook (blinding factors + schnorr nonces).
RANDOM_SOURCE = lambda p: secrets.randbelow(p)

IPA_MSM_WINDOW = 8


@dataclass
class OpeningProof:
    halo_l: List[chost.AffinePoint]
    halo_r: List[chost.AffinePoint]
    halo_g: chost.AffinePoint
    schnorr_proof: SchnorrProof


def _inner_product_body(spec, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return fops.sum_reduce(spec, fops.mul(spec, a, b), 0)


def _inner_product_device(spec, a: jnp.ndarray, b: jnp.ndarray) -> int:
    from ..utils import cached_jit
    return fops.to_ints(spec, cached_jit(_inner_product_body, spec)(a, b))


def _scale_add_device(spec, ca_d: jnp.ndarray, a: jnp.ndarray,
                      cb_d: jnp.ndarray, b: jnp.ndarray):
    """ca * a + cb * b elementwise over [D, m] vectors, fused.
    ca_d/cb_d are [D, 1] device constants (runtime args so the per-round
    scalars don't force recompilation)."""
    return fops.product_sum(spec, [
        (ca_d, fops.WORK_DB, a, fops.WORK_DB, 1),
        (cb_d, fops.WORK_DB, b, fops.WORK_DB, 1),
    ])


@functools.lru_cache(maxsize=None)
def _scale_add_jit(spec):
    return jax.jit(functools.partial(_scale_add_device, spec))


# ---------------------------------------------------------------------------
# Weight-tracked IPA rounds.  The naive formulation folds the G basis every
# round (u_inv*G_lo + u*G_hi): two 255-step batched double-and-add chains
# per round, which made the IPA most of a degree-2^14 prove and compiled 14
# distinct fold graphs.  Instead the basis NEVER folds: original index k carries a
# running weight w_k (the partial product of u_j / u_j_inv factors chosen
# by bit j-1 of k -- exactly the halo_s tensor structure,
# plonk_util.halo_s), and each round's
#   L_j = <a_lo, G'_hi>,  R_j = <a_hi, G'_lo>
# becomes ONE K=2 multi-MSM over the original points with scalars
#   s_L[k] = w_k * a[k mod half] * bit_{j-1}(k)
#   s_R[k] = w_k * a[(k mod half) + half] * (1 - bit_{j-1}(k)),
# a/b stay FULL-WIDTH (live entries in the first n_j positions, masked
# folds via roll), so every round reuses the same three compiled programs
# whatever its size, and the final halo_g is one more MSM with w_final
# (= halo_s(us), the quantity the verifier's G check recomputes anyway).
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ipa_round_scalars_jit(curve):
    sf = curve.scalar

    def body(w, a, b, idx_lo, idx_hi, bit, mask_lo, shift_half):
        # gathered current-a values per original index
        a_lo_g = jnp.take(a, idx_lo, axis=-1)       # a[k mod half]
        a_hi_g = jnp.take(a, idx_hi, axis=-1)       # a[k mod half + half]
        bitc = bit[None].astype(jnp.int32)
        # masking by the 0/1 bit keeps the loose digit bound; msm
        # canonicalizes its scalar input itself
        s_l = fops.mul_loose(sf, w, a_lo_g) * bitc
        s_r = fops.mul_loose(sf, w, a_hi_g) * (1 - bitc)
        # inner products <a_lo, b_hi>, <a_hi, b_lo> over live entries
        b_roll = jnp.roll(b, -shift_half, axis=-1)
        a_roll = jnp.roll(a, -shift_half, axis=-1)
        maskc = mask_lo[None].astype(jnp.int32)
        ip_lo_hi = fops.sum_reduce(
            sf, fops.mul_loose(sf, a, b_roll) * maskc, 0)
        ip_hi_lo = fops.sum_reduce(
            sf, fops.mul_loose(sf, a_roll, b) * maskc, 0)
        return s_l, s_r, ip_lo_hi, ip_hi_lo

    return jax.jit(body)


@functools.lru_cache(maxsize=None)
def _ipa_fold_jit(curve):
    sf = curve.scalar

    def body(w, a, b, u_col, u_inv_col, bit, mask_lo, shift_half):
        maskc = mask_lo[None].astype(jnp.int32)
        bitc = bit[None].astype(jnp.int32)
        # a' = u_inv a_hi + u a_lo ; b' = u_inv b_lo + u b_hi (live < half)
        a_new = _scale_add_device(
            sf, u_inv_col, jnp.roll(a, -shift_half, axis=-1),
            u_col, a) * maskc
        b_new = _scale_add_device(
            sf, u_inv_col, b, u_col,
            jnp.roll(b, -shift_half, axis=-1)) * maskc
        # w_k *= u if bit_{j-1}(k) else u_inv
        factor = fops.select(bitc[0], u_col, u_inv_col)
        w_new = fops.mul_loose(sf, w, factor)
        return w_new, a_new, b_new

    return jax.jit(body)


def _sc(spec, v: int) -> jnp.ndarray:
    return jnp.asarray(spec.to_digits(v))[:, None]


def _bits_col(spec, v: int) -> jnp.ndarray:
    return jnp.asarray([[(v >> i) & 1] for i in range(spec.bits)],
                       dtype=jnp.int32)


def batch_opening_proof(
    circuit_or_none,
    polynomials_coeffs: jnp.ndarray,   # [D, K, n] device
    commitments_randomness: List[int],
    opening_points: List[int],
    pedersen_g_dev: cops.Point,        # [D, n] device projective
    pedersen_h: chost.AffinePoint,
    u_curve: chost.AffinePoint,
    u: int,
    v: int,
    u_scaling: int,
    degree: int,
    security_bits: int,
    challenger,
    curve: CurveSpec,
) -> OpeningProof:
    """reference: src/halo.rs:16-141."""
    sf = curve.scalar
    p = sf.p
    K = polynomials_coeffs.shape[1]

    # n(u^i) scalars (reference: halo.rs:33-38)
    actual_scalars = [
        halo_n(curve, scalar_to_bits_le(ui, security_bits))
        for ui in powers(sf, u, K)
    ]

    # reduce all coefficient vectors into one: sum_i n(u^i) * coeffs_i
    scal_dev = jnp.stack([jnp.asarray(sf.to_digits(s))
                          for s in actual_scalars], axis=1)  # [D, K]
    halo_a = _reduce_polys_jit(sf, K)(polynomials_coeffs, scal_dev)

    u_prime = halo_n_mul(curve, scalar_to_bits_le(u_scaling, security_bits),
                         u_curve)

    # halo_b: v-weighted combination of powers of the opening points
    # (reference: halo.rs:143-155); points and v enter as runtime columns so
    # the trace is shared across proofs
    from ..utils import cached_jit
    pts_cols = jnp.concatenate([_sc(sf, pt) for pt in opening_points], axis=1)
    halo_b = cached_jit(_build_halo_b_dyn, sf, degree)(pts_cols, _sc(sf, v))

    halo_l: List[chost.AffinePoint] = []
    halo_r: List[chost.AffinePoint] = []
    randomness = 0
    for s, r in zip(actual_scalars, commitments_randomness):
        randomness = (randomness + s * r) % p

    degree_pow = degree.bit_length() - 1
    from .circuit import commit_window_bits, device_point_to_host

    import numpy as np
    msm_fn = cmsm.msm_jit(curve, commit_window_bits(degree))
    round_fn = _ipa_round_scalars_jit(curve)
    fold_fn = _ipa_fold_jit(curve)

    k_idx = np.arange(degree)
    w_dev = fops.constant(sf, 1, (degree,))
    a_dev = halo_a
    b_dev = halo_b

    for j in range(degree_pow, 0, -1):
        half = 1 << (j - 1)
        bit = jnp.asarray(((k_idx >> (j - 1)) & 1).astype(np.int32))
        idx_lo = jnp.asarray((k_idx % half).astype(np.int32))
        idx_hi = jnp.asarray((k_idx % half + half).astype(np.int32))
        mask_lo = jnp.asarray((k_idx < half).astype(np.int32))

        s_l, s_r, ip_lo_d, ip_hi_d = round_fn(
            w_dev, a_dev, b_dev, idx_lo, idx_hi, bit, mask_lo,
            jnp.int32(half))
        both = msm_fn(pedersen_g_dev, jnp.stack([s_l, s_r], axis=1))
        l_msm = device_point_to_host(curve, tuple(t[..., 0] for t in both))
        r_msm = device_point_to_host(curve, tuple(t[..., 1] for t in both))
        ip_lo_hi = fops.to_ints(sf, ip_lo_d)
        ip_hi_lo = fops.to_ints(sf, ip_hi_d)

        while True:
            l_blind = RANDOM_SOURCE(p)
            r_blind = RANDOM_SOURCE(p)
            halo_l_j = chost.add(chost.add(l_msm, chost.mul(pedersen_h, l_blind)),
                                 chost.mul(u_prime, ip_lo_hi))
            halo_r_j = chost.add(chost.add(r_msm, chost.mul(pedersen_h, r_blind)),
                                 chost.mul(u_prime, ip_hi_lo))
            fork = _clone_challenger(challenger)
            fork.observe_affine_points([halo_l_j, halo_r_j])
            r_bf = fork.get_challenge()
            r_sf = try_convert(r_bf, sf)
            u_j_squared = halo_n(curve, scalar_to_bits_le(r_sf, security_bits))
            u_j = fhost.canonical_square_root(sf, u_j_squared)
            if u_j is not None:
                u_sq_inv = pow(u_j_squared, -1, p)
                halo_l.append(halo_l_j)
                halo_r.append(halo_r_j)
                randomness = (randomness + u_j_squared * l_blind
                              + u_sq_inv * r_blind) % p
                _copy_challenger(fork, challenger)
                break

        u_j_inv = pow(u_j, -1, p)
        w_dev, a_dev, b_dev = fold_fn(
            w_dev, a_dev, b_dev, _sc(sf, u_j), _sc(sf, u_j_inv), bit,
            mask_lo, jnp.int32(half))

    # halo_g = <w_final, G> (w_final is exactly halo_s(us)); reuse the same
    # K=2 multi-MSM program with a zero second row
    zero_row = fops.zeros(sf, (degree,))
    gpt = msm_fn(pedersen_g_dev, jnp.stack([w_dev, zero_row], axis=1))
    halo_g_pt = device_point_to_host(curve, tuple(t[..., 0] for t in gpt))
    a0 = fops.to_ints(sf, a_dev[:, 0])
    b0 = fops.to_ints(sf, b_dev[:, 0])

    schnorr = schnorr_protocol(curve, a0, b0, halo_g_pt, randomness,
                               u_prime, pedersen_h, challenger)
    return OpeningProof(halo_g=halo_g_pt, halo_l=halo_l, halo_r=halo_r,
                        schnorr_proof=schnorr)


@functools.lru_cache(maxsize=None)
def _reduce_polys_jit(sf, K: int):
    def body(polys, sc):
        return fops.product_sum(sf, [
            (sc[:, i:i + 1], fops.WORK_DB, polys[:, i], fops.WORK_DB, 1)
            for i in range(K)])
    return jax.jit(body)


def _build_halo_b_dyn(spec, degree, pts_cols, v_col):
    """b_i = sum_j v^j point_j^i (reference: halo.rs:143-155).
    pts_cols: [D, P] runtime opening points, v_col: [D, 1]."""
    P = pts_cols.shape[1]
    vp = powers_dyn(spec, v_col, P)   # [D, P]
    terms = []
    for j in range(P):
        pw = powers_dyn(spec, pts_cols[:, j:j + 1], degree)
        terms.append((vp[:, j:j + 1], fops.WORK_DB, pw, fops.WORK_DB, 1))
    return fops.product_sum(spec, terms)


def schnorr_protocol(curve, halo_a: int, halo_b: int,
                     halo_g: chost.AffinePoint, randomness: int,
                     u_prime: chost.AffinePoint, pedersen_h: chost.AffinePoint,
                     challenger) -> SchnorrProof:
    """reference: halo.rs:157-182."""
    sf = curve.scalar
    p = sf.p
    d = RANDOM_SOURCE(p)
    s = RANDOM_SOURCE(p)
    r_curve = chost.add(
        chost.mul(chost.add(halo_g, chost.mul(u_prime, halo_b)), d),
        chost.mul(pedersen_h, s))
    challenger.observe_affine_point(r_curve)
    chall = try_convert(challenger.get_challenge(), sf)
    z1 = (halo_a * chall + d) % p
    z2 = (randomness * chall + s) % p
    return SchnorrProof(r=r_curve, z1=z1, z2=z2)


def verify_ipa(curve, halo_l, halo_r, halo_g, commitment, value, halo_b,
               halo_us, u_prime, pedersen_h, schnorr_challenge,
               schnorr_proof) -> bool:
    """reference: halo.rs:186-223 (host: the point count is ~2 log n)."""
    sf = curve.scalar
    p = sf.p
    p_prime = chost.add(commitment, chost.mul(u_prime, value))
    q = p_prime
    for l, u_j in zip(halo_l, halo_us):
        q = chost.add(q, chost.mul(l, u_j * u_j % p))
    for r, u_j in zip(halo_r, halo_us):
        inv = pow(u_j, -1, p)
        q = chost.add(q, chost.mul(r, inv * inv % p))
    lhs = chost.add(chost.mul(q, schnorr_challenge), schnorr_proof.r)
    rhs = chost.add(
        chost.mul(chost.add(halo_g, chost.mul(u_prime, halo_b)),
                  schnorr_proof.z1),
        chost.mul(pedersen_h, schnorr_proof.z2))
    return lhs == rhs


def _clone_challenger(ch):
    from ..hashing.challenger import Challenger
    fork = Challenger(ch.spec, ch.security_bits)
    fork.sponge_state = list(ch.sponge_state)
    fork.input_buffer = list(ch.input_buffer)
    fork.output_buffer = list(ch.output_buffer)
    return fork


def _copy_challenger(src, dst):
    dst.sponge_state = list(src.sponge_state)
    dst.input_buffer = list(src.input_buffer)
    dst.output_buffer = list(src.output_buffer)
