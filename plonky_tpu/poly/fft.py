"""Batched radix-2 FFT over prime fields on device.

Replaces the reference's rayon-chunked butterfly loops
(reference: src/fft.rs:103-156) with layer-vectorized butterflies over the
whole domain: each of the log2(n) layers is ONE batched field multiply plus
an add/sub pair (SURVEY.md P1).  Twiddle
tables are precomputed per (field, size) like the reference's
`FftPrecomputation` (src/fft.rs:28-59).

Supports leading poly-batch dims: values shaped [D, ..., n] with the domain
axis LAST (contiguous).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..fields import host as fhost
from ..fields import ops as fops
from ..fields.spec import FieldSpec
from ..utils import log2_strict


def _digit_columns(spec: FieldSpec, vals) -> np.ndarray:
    """Python ints in [0, p) -> [D, len(vals)] int32 digit columns."""
    D = spec.n_digits
    raw = b"".join(int(v).to_bytes(D, "little") for v in vals)
    return np.frombuffer(raw, dtype=np.uint8).reshape(len(vals), D).T \
        .astype(np.int32)


@functools.lru_cache(maxsize=None)
class FftPrecomputation:
    """Twiddle tables for a size-n FFT over `spec` (n a power of two)."""

    def __init__(self, spec: FieldSpec, n: int):
        self.spec = spec
        self.n = n
        self.lg_n = log2_strict(n)
        self.g = fhost.primitive_root_of_unity(spec, self.lg_n)
        self.g_inv = pow(self.g, -1, spec.p)
        self.n_inv = pow(n, -1, spec.p)
        # [w^i for i < n/2]: every stage's twiddles are a gather from it.
        p = spec.p
        tw, twi, cw, cwi = [], [], 1, 1
        for _ in range(n // 2):
            tw.append(cw)
            twi.append(cwi)
            cw = cw * self.g % p
            cwi = cwi * self.g_inv % p
        self.half_powers = _digit_columns(spec, tw)
        self.half_powers_inv = _digit_columns(spec, twi)
        # bit-reversal permutation
        idx = np.arange(n)
        rev = np.zeros(n, dtype=np.int64)
        for b in range(self.lg_n):
            rev |= ((idx >> b) & 1) << (self.lg_n - 1 - b)
        self.bit_rev = rev
        self.n_inv_digits = spec.to_digits(self.n_inv)

    def runtime_tables(self, inverse: bool = False):
        """(twiddles [D, n/2], bit reversal [n]) as device arrays, cached,
        for threading as extra ARGUMENTS through jitted protocol graphs.

        Closed-over tables are baked into the compiled program as constants
        ([D, n/2] digits), which the compiler processes again in every graph
        and which bloats the persistent-cache entries.  As runtime buffers
        the tables upload ONCE and every program stays small."""
        key = bool(inverse)
        cache = self.__dict__.setdefault("_runtime_tables", {})
        if key not in cache:
            tw = self.half_powers_inv if inverse else self.half_powers
            cache[key] = (jnp.asarray(tw), jnp.asarray(self.bit_rev))
        return cache[key]

    @functools.cached_property
    def subgroup(self):
        """[1, g, g^2, ...] as python ints (host)."""
        return fhost.cyclic_subgroup_known_order(self.spec, self.g, self.n)


# Number of runtime table arrays per FFT direction (see runtime_tables).
N_TABLES = 2


def butterfly_stage(spec: FieldSpec, x: jnp.ndarray,
                    tw: jnp.ndarray) -> jnp.ndarray:
    """One constant-geometry radix-2 stage over the last axis of x [D, .., n]:
    pair the adjacent elements (a, b) = (x[2i], x[2i+1]) and write
    a + w_i b to position i and a - w_i b to position n/2 + i.  tw is
    [D, .., n/2], broadcastable against the pairs."""
    n = x.shape[-1]
    y = x.reshape(*x.shape[:-1], n // 2, 2)
    a, b = y[..., 0], y[..., 1]
    t = fops.mul(spec, b, tw)
    return jnp.concatenate([fops.add(spec, a, t), fops.sub(spec, a, t)],
                           axis=-1)


def _stage_twiddles(tw_half: jnp.ndarray, s, lg_n: int) -> jnp.ndarray:
    """Stage s twiddles [D, n/2]: pair i takes w^(i with its low
    lg_n-1-s bits cleared)."""
    i = jnp.arange(tw_half.shape[-1], dtype=jnp.int32)
    sh = lg_n - 1 - s
    return jnp.take(tw_half, (i >> sh) << sh, axis=-1)


def _fft_core(pre: FftPrecomputation, x: jnp.ndarray, inverse: bool,
              tables=None) -> jnp.ndarray:
    """Radix-2 DIT on bit-reversed input in constant geometry (Pease): every
    stage has the same shapes, so the lg n stages run as ONE fori_loop body
    and the compiled program does not grow with lg n.  After stage s an
    element's position is its DIT index rotated right by s+1 bits, so the
    output is in natural order after the last stage."""
    spec, n, lg = pre.spec, pre.n, pre.lg_n
    assert x.shape[-1] == n
    if tables is None:
        tables = (jnp.asarray(pre.half_powers_inv if inverse
                              else pre.half_powers),
                  jnp.asarray(pre.bit_rev))
    tw_half, bit_rev = tables
    x = x[..., bit_rev]
    lead = (1,) * (x.ndim - 2)

    def stage(s, x):
        tw = _stage_twiddles(tw_half, s, lg)
        return butterfly_stage(
            spec, x, tw.reshape(spec.n_digits, *lead, n // 2))

    x = jax.lax.fori_loop(0, lg, stage, x)
    if inverse:
        ninv = jnp.asarray(pre.n_inv_digits).reshape(
            (spec.n_digits,) + (1,) * (x.ndim - 1))
        x = fops.mul(spec, x, ninv)
    return x


def fft(pre: FftPrecomputation, coeffs: jnp.ndarray, tables=None) -> jnp.ndarray:
    """Coefficients -> evaluations over the order-n subgroup [g^0..g^(n-1)].

    `tables` (from `pre.runtime_tables()`) ships twiddles/bit-rev as
    runtime buffers instead of program constants, which keeps large-n
    programs small."""
    return _fft_core(pre, coeffs, inverse=False, tables=tables)


def ifft(pre: FftPrecomputation, values: jnp.ndarray, tables=None) -> jnp.ndarray:
    """Evaluations -> coefficients (reference: src/fft.rs:82-101)."""
    return _fft_core(pre, values, inverse=True, tables=tables)


def fft_t(pre: FftPrecomputation, x: jnp.ndarray, *flat) -> jnp.ndarray:
    """fft with the runtime tables passed flat (see runtime_tables)."""
    assert len(flat) == N_TABLES, len(flat)
    return _fft_core(pre, x, inverse=False, tables=flat)


def ifft_t(pre: FftPrecomputation, x: jnp.ndarray, *flat) -> jnp.ndarray:
    assert len(flat) == N_TABLES, len(flat)
    return _fft_core(pre, x, inverse=True, tables=flat)


def lde_t(pre: FftPrecomputation, coeffs: jnp.ndarray, *flat) -> jnp.ndarray:
    pad = [(0, 0)] * (coeffs.ndim - 1) + [(0, pre.n - coeffs.shape[-1])]
    return fft_t(pre, jnp.pad(coeffs, pad), *flat)


def coset_fft_t(pre: FftPrecomputation, coeffs: jnp.ndarray, shift: int,
                *flat) -> jnp.ndarray:
    powers = powers_device(pre.spec, shift, pre.n)
    powb = powers.reshape(
        (pre.spec.n_digits,) + (1,) * (coeffs.ndim - 2) + (pre.n,))
    return fft_t(pre, fops.mul(pre.spec, coeffs, powb), *flat)


def coset_ifft_t(pre: FftPrecomputation, values: jnp.ndarray, shift: int,
                 *flat) -> jnp.ndarray:
    coeffs = ifft_t(pre, values, *flat)
    powers = powers_device(pre.spec, pow(shift, -1, pre.spec.p), pre.n)
    powb = powers.reshape(
        (pre.spec.n_digits,) + (1,) * (coeffs.ndim - 2) + (pre.n,))
    return fops.mul(pre.spec, coeffs, powb)


@functools.lru_cache(maxsize=None)
def _four_step_subpres(spec: FieldSpec, n: int, lg_n1: int):
    n1 = 1 << lg_n1
    return FftPrecomputation(spec, n1), FftPrecomputation(spec, n // n1)


@functools.lru_cache(maxsize=None)
def four_step_twiddles(spec: FieldSpec, n: int, lg_n1: int,
                       inverse: bool = False) -> jnp.ndarray:
    """The middle-stage twiddle table w_n^(+-i1*k2) as a [D, n1, n2] device
    buffer (cached: it is data-sized, so it must travel as a runtime buffer
    like FftPrecomputation.runtime_tables, not as program constants).

    Built ON DEVICE: host bases w_n^i1 for the n1 rows, then a doubling
    construction along k2 (~n field muls in lg(n2) batched steps) -- a
    Python-loop host build at n = 2^22 would take minutes."""
    n1 = 1 << lg_n1
    n2 = n // n1
    lg_n = log2_strict(n)
    g = fhost.primitive_root_of_unity(spec, lg_n)
    if inverse:
        g = pow(g, -1, spec.p)
    bases = powers_device(spec, g, n1)          # [D, n1]
    acc = fops.constant(spec, 1, (n1, 1))       # [D, n1, 1]
    top = bases[..., None]                      # invariant: top = base^width
    while acc.shape[-1] < n2:
        acc = jnp.concatenate([acc, fops.mul(spec, acc, top)], axis=-1)
        top = fops.square(spec, top)
    return jax.block_until_ready(acc[..., :n2])


def fft_four_step(spec: FieldSpec, x: jnp.ndarray, tw: jnp.ndarray,
                  lg_n1: int, inverse: bool = False,
                  tables2=None, tables1=None) -> jnp.ndarray:
    """Single-chip four-step FFT over a domain n = n1 * n2 (n1 = 2^lg_n1).

    The flat layer-vectorized FFT streams the full [D, n] array through
    device memory once per layer.  The transpose
    factorization (same decimation as parallel/fft.py:fft_sharded_domain,
    reference: src/fft.rs:103-156) replaces the lg(n) full-size layers with
    two batched SMALL-domain stages whose butterflies never exceed n2 (resp.
    n1) points, plus one data-sized twiddle multiply and two transposes:

        X[k2 + n2*k1] = sum_i1 w_n1^(i1 k1) [ w_n^(i1 k2)
                        * (sum_i2 w_n2^(i2 k2) C[i1, i2]) ],
        C[i1, i2] = c[i1 + n1*i2].

    `tw` comes from `four_step_twiddles(spec, n, lg_n1, inverse)`; pass
    `inverse=True` for the inverse transform (sub-IFFTs contribute
    1/n1 * 1/n2 = 1/n, the twiddle table flips to negative powers)."""
    n = x.shape[-1]
    n1 = 1 << lg_n1
    n2 = n // n1
    assert n1 * n2 == n, (n, n1)
    pre1, pre2 = _four_step_subpres(spec, n, lg_n1)
    C = x.reshape(*x.shape[:-1], n2, n1)
    C = jnp.swapaxes(C, -1, -2)                       # [.., n1, n2]
    inner = _fft_core(pre2, C, inverse, tables=tables2)
    y = fops.mul(spec, inner, tw)
    yt = jnp.swapaxes(y, -1, -2)                      # [.., n2, n1]
    out = _fft_core(pre1, yt, inverse, tables=tables1)
    out = jnp.swapaxes(out, -1, -2)                   # [.., k1, k2]
    return out.reshape(*out.shape[:-2], n)


def powers_device(spec: FieldSpec, base: int, n: int) -> jnp.ndarray:
    """[base^0, .., base^(n-1)] as [D, n] for a host-int base."""
    return powers_dyn(spec, fops.constant(spec, base % spec.p, (1,)), n)


def powers_dyn(spec: FieldSpec, base_col: jnp.ndarray, n: int) -> jnp.ndarray:
    """[base^0 .. base^(n-1)] as [D, n] from a [D, 1] base column, which may
    be a traced runtime input (so jits over it serve every proof).

    Bit j of each exponent selects one multiply by base^(2^j): log2(n)
    batched muls in ONE fori_loop body, so the program does not grow with
    log2(n)."""
    lg = max(1, (n - 1).bit_length())
    idx = jnp.arange(n, dtype=jnp.int32)

    def step(j, carry):
        acc, sq = carry
        acc = fops.select((idx >> j) & 1, fops.mul(spec, acc, sq), acc)
        return acc, fops.square(spec, sq)

    one = jnp.broadcast_to(fops.constant(spec, 1, (1,)), (spec.n_digits, n))
    acc, _ = jax.lax.fori_loop(0, lg, step, (one, base_col))
    return acc


def lde(pre: FftPrecomputation, coeffs: jnp.ndarray) -> jnp.ndarray:
    """Zero-pad the coefficient axis to pre.n and FFT (the 8x low-degree
    extension; reference: src/plonk_util.rs:179-190)."""
    pad = [(0, 0)] * (coeffs.ndim - 1) + [(0, pre.n - coeffs.shape[-1])]
    return fft(pre, jnp.pad(coeffs, pad))


def coset_fft(pre: FftPrecomputation, coeffs: jnp.ndarray, shift: int) -> jnp.ndarray:
    """Evaluations over the coset shift*H: scale coeff i by shift^i, then FFT."""
    powers = powers_device(pre.spec, shift, pre.n)
    powb = powers.reshape((pre.spec.n_digits,) + (1,) * (coeffs.ndim - 2) + (pre.n,))
    return fft(pre, fops.mul(pre.spec, coeffs, powb))


def coset_ifft(pre: FftPrecomputation, values: jnp.ndarray, shift: int) -> jnp.ndarray:
    coeffs = ifft(pre, values)
    powers = powers_device(pre.spec, pow(shift, -1, pre.spec.p), pre.n)
    powb = powers.reshape((pre.spec.n_digits,) + (1,) * (coeffs.ndim - 2) + (pre.n,))
    return fops.mul(pre.spec, coeffs, powb)
