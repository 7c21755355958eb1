"""Polynomial operations in coefficient form (device).

Batched device equivalents of the reference's `Polynomial<F>`
(reference: src/polynomial.rs): a polynomial is a digit array [D, ..., n]
with the coefficient axis last.  FFT-based multiplication, batched Horner /
inner-product evaluation, `divide_by_z_h` via the coset trick
(reference: src/polynomial.rs:330-380 -- on a coset s*H the vanishing
polynomial X^n - 1 depends only on the 8-periodic h^n, so the division is a
pointwise multiply by a precomputed inverse vector), and Newton-iteration
polynomial division (reference: src/polynomial.rs:262-327).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from ..fields import host as fhost
from ..fields import ops as fops
from ..fields.spec import FieldSpec
from ..utils import log2_ceil
from .fft import (FftPrecomputation, coset_fft, coset_ifft, fft, ifft,
                  powers_device, powers_dyn)


def eval_at(spec: FieldSpec, coeffs: jnp.ndarray, point: int) -> jnp.ndarray:
    """Evaluate [D, ..., n] polynomials at a host scalar point: inner product
    with powers (reference `eval_from_power`: src/polynomial.rs:130)."""
    n = coeffs.shape[-1]
    pw = powers_device(spec, point, n)
    pwb = pw.reshape((spec.n_digits,) + (1,) * (coeffs.ndim - 2) + (n,))
    prod = fops.mul(spec, coeffs, pwb)
    return fops.sum_reduce(spec, prod, prod.ndim - 2)


def eval_at_dyn(spec: FieldSpec, coeffs: jnp.ndarray,
                point_col: jnp.ndarray) -> jnp.ndarray:
    """Like eval_at, but the point is a TRACED [D, 1] array so one jit serves
    every opening point / proof (no per-challenge re-trace)."""
    n = coeffs.shape[-1]
    pw = powers_dyn(spec, point_col, n)
    pwb = pw.reshape((spec.n_digits,) + (1,) * (coeffs.ndim - 2) + (n,))
    prod = fops.mul(spec, coeffs, pwb)
    return fops.sum_reduce(spec, prod, prod.ndim - 2)


def mul_polys(spec: FieldSpec, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """FFT-based product (reference: src/polynomial.rs:208-227).
    Output length = len(a) + len(b) rounded to a power of two."""
    na, nb = a.shape[-1], b.shape[-1]
    n = 1 << log2_ceil(na + nb)
    pre = FftPrecomputation(spec, n)
    pad = lambda x, m: jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, m - x.shape[-1])])
    fa = fft(pre, pad(a, n))
    fb = fft(pre, pad(b, n))
    return ifft(pre, fops.mul(spec, fa, fb))


@functools.lru_cache(maxsize=None)
def _z_h_inverses_on_coset(spec: FieldSpec, n: int, big_n: int, shift: int):
    """1 / ((shift*h)^n - 1) for h in H_{big_n}, as a [D, big_n] constant."""
    p = spec.p
    g_big = fhost.primitive_root_of_unity(spec, log2_ceil(big_n))
    period = big_n // n
    s_n = pow(shift, n, p)
    vals = []
    h_n = 1
    g_n = pow(g_big, n, p)  # order `period`
    for _ in range(period):
        vals.append(pow((s_n * h_n - 1) % p, -1, p))
        h_n = h_n * g_n % p
    tiled = [vals[i % period] for i in range(big_n)]
    return np.stack([spec.to_digits(v) for v in tiled], axis=-1)


def divide_by_z_h(spec: FieldSpec, coeffs: jnp.ndarray, n: int) -> jnp.ndarray:
    """Divide a polynomial (exactly divisible) by Z_H = X^n - 1.

    Evaluate on the coset g*H_N (g = multiplicative group generator, N =
    len(coeffs)), multiply by precomputed 1/Z_H values, interpolate back.
    (reference: src/polynomial.rs:330-380)
    """
    N = coeffs.shape[-1]
    shift = spec.generator
    pre = FftPrecomputation(spec, N)
    values = coset_fft(pre, coeffs, shift)
    inv = jnp.asarray(_z_h_inverses_on_coset(spec, n, N, shift))
    invb = inv.reshape((spec.n_digits,) + (1,) * (coeffs.ndim - 2) + (N,))
    return coset_ifft(pre, fops.mul(spec, values, invb), shift)


def divide_by_z_h_t(spec: FieldSpec, coeffs: jnp.ndarray, n: int,
                    zh_inv: jnp.ndarray, *flat) -> jnp.ndarray:
    """divide_by_z_h with the 1/Z_H values and FFT twiddles as runtime
    buffers (`flat` = forward tables then inverse tables, N_TABLES each)
    -- keeps the traced program free of [D, N] constants."""
    from .fft import N_TABLES as k
    from .fft import coset_fft_t, coset_ifft_t
    N = coeffs.shape[-1]
    shift = spec.generator
    pre = FftPrecomputation(spec, N)
    assert len(flat) == 2 * k
    values = coset_fft_t(pre, coeffs, shift, *flat[:k])
    invb = zh_inv.reshape((spec.n_digits,) + (1,) * (coeffs.ndim - 2) + (N,))
    return coset_ifft_t(pre, fops.mul(spec, values, invb), shift, *flat[k:])


def z_h_inverses_dev(spec: FieldSpec, n: int, big_n: int) -> jnp.ndarray:
    """[D, big_n] device array of 1/Z_H on the generator coset (runtime
    companion of divide_by_z_h_t)."""
    return jnp.asarray(
        _z_h_inverses_on_coset(spec, n, big_n, spec.generator))


def _const_poly(spec: FieldSpec, v: int, like: jnp.ndarray, n: int) -> jnp.ndarray:
    """[D, ..., n] polynomial equal to the constant v (batch dims from `like`)."""
    c = fops.constant(spec, v, like.shape[1:-1] + (1,))
    return jnp.pad(c, [(0, 0)] * (c.ndim - 1) + [(0, n - 1)])


def inv_mod_xn(spec: FieldSpec, f: jnp.ndarray, n: int) -> jnp.ndarray:
    """g with f*g == 1 (mod x^n); f's constant term must be invertible.

    Newton iteration g_{2k} = g_k * (2 - f*g_k) mod x^{2k}, log2(n) doubling
    steps, each a batched FFT multiply (reference: src/polynomial.rs:262-294,
    which runs the same iteration host-side per coefficient).
    """
    g = fops.inverse(spec, f[..., :1])
    k = 1
    while k < n:
        k = min(2 * k, n)
        fg = mul_polys(spec, f[..., : min(f.shape[-1], k)], g)[..., :k]
        t = fops.sub(spec, _const_poly(spec, 2, fg, k), fg)
        g = mul_polys(spec, g, t)[..., :k]
    return g[..., :n]


def degree_host(spec: FieldSpec, f: jnp.ndarray) -> int:
    """Host readback of the degree (index of last nonzero coefficient; -1 for
    the zero polynomial).  Utility path only — not used by the prover."""
    ints = fops.to_ints(spec, f)
    arr = np.asarray(ints).reshape(-1, f.shape[-1])
    nz = np.nonzero(arr.any(axis=0))[0]
    return int(nz[-1]) if nz.size else -1


def polynomial_division(spec: FieldSpec, a: jnp.ndarray, b: jnp.ndarray,
                        deg_a: int | None = None, deg_b: int | None = None):
    """(q, r) with a = q*b + r, deg r < deg b (reference:
    src/polynomial.rs:299-327).

    Fast division by power-series inversion of the reversed divisor:
    rev(q) = rev(a) * inv_mod_xn(rev(b), k) mod x^k, k = deg a - deg b + 1.
    Degrees are host-known (pass them to avoid a readback).
    """
    if deg_a is None:
        deg_a = degree_host(spec, a)
    if deg_b is None:
        deg_b = degree_host(spec, b)
    if deg_b < 0:
        raise ZeroDivisionError("division by zero polynomial")
    if deg_a < deg_b:
        return fops.zeros(spec, a.shape[1:-1] + (1,)), a
    k = deg_a - deg_b + 1
    rev_a = jnp.flip(a[..., : deg_a + 1], axis=-1)
    rev_b = jnp.flip(b[..., : deg_b + 1], axis=-1)
    inv_rb = inv_mod_xn(spec, rev_b, k)
    rev_q = mul_polys(spec, rev_a[..., :k], inv_rb)[..., :k]
    q = jnp.flip(rev_q, axis=-1)
    qb = mul_polys(spec, q, b[..., : deg_b + 1])
    r = fops.sub(spec, a[..., :deg_b], qb[..., :deg_b]) if deg_b else \
        fops.zeros(spec, a.shape[1:-1] + (1,))
    return q, r


def poly_from_ints(spec: FieldSpec, coeffs) -> jnp.ndarray:
    return fops.from_ints(spec, coeffs)


def eval_host(spec: FieldSpec, coeffs, x: int) -> int:
    """Host Horner evaluation on python-int coefficients."""
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % spec.p
    return acc
