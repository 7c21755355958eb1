"""Batched prime-field arithmetic on digit vectors (device layer).

Every function here operates on arrays of shape ``[L, *batch]`` where axis 0
holds little-endian 8-bit digits stored as int32 and the trailing axes are an
arbitrary batch.  Putting the batch last makes it the contiguous (minor)
dimension, so every digit row is one coalesced vector.

Replaces the reference's u64 Montgomery engine (reference:
src/field/monty.rs:66-160, src/bigint/bigint_arithmetic.rs) with a
convolution + fold-matrix + carry-lookahead formulation:

* multiplication  = digit convolution (int32 multiply-adds)
* modular fold    = contraction against precomputed ``2^(8i) mod p`` digit rows
* exact carrying  = O(log D) carry-lookahead via ``lax.associative_scan``
                    (never a sequential per-digit ripple)
* canonical form  = exact Barrett reduction (HAC 14.42) at boundaries

All digit/value bounds are tracked STATICALLY (python ints at trace time),
so overflow-safety is decided at trace time, not at run time.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .spec import DIGIT_BASE, DIGIT_BITS, DIGIT_MASK, FieldSpec

# ---------------------------------------------------------------------------
# Bounded digit-vector helpers.  A "bounded array" is (array, digit_bound,
# value_bound) with both bounds plain python ints.
# ---------------------------------------------------------------------------

INT32_SAFE = (1 << 31) - 1

# Digit bound of the LOOSE working form.  Chained device ops keep digits in
# [0, 511] instead of fully carrying to [0, 255]: the exact carry-lookahead
# (two log-depth cummax scans, the most expensive part of every reduction)
# then runs only at observation boundaries (canonicalize), not between
# chained muls/adds.  With digits <= 511 a digit convolution sums at most
# min(La, Lb) * 511^2 < 2^24 (D <= 50 for BLS12-377's 377-bit base field),
# far inside int32, so a product of two working-form values needs no carry
# round before its convolution.
WORK_DB = 2 * DIGIT_MASK + 1


def _pad_len(x: jnp.ndarray, n: int) -> jnp.ndarray:
    """Zero-pad (or keep) the digit axis to length n."""
    L = x.shape[0]
    if L == n:
        return x
    assert L < n
    pad = [(0, n - L)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pad)


def _shift_up(x: jnp.ndarray) -> jnp.ndarray:
    """Multiply by 256: move every digit one position up, dropping the top."""
    pad = [(1, 0)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pad)[: x.shape[0]]


def _loose_carry_round(x: jnp.ndarray) -> jnp.ndarray:
    """One round of carry extraction: digit_bound b -> 255 + b // 256.

    Preserves the represented value provided the top digit cannot overflow
    (caller guarantees via value_bound-derived length).
    """
    return (x & DIGIT_MASK) + _shift_up(x >> DIGIT_BITS)


def _carry_lookahead(x: jnp.ndarray) -> jnp.ndarray:
    """Exact normalization of digits in [0, 511] to [0, 255].

    Carry resolution as a carry-lookahead expressed with TWO cumulative-max
    primitives (instead of a sequential per-digit ripple or a
    generate/propagate associative_scan, which compiles much slower):
    a carry enters digit i iff the most recent carry-GENERATING position
    (s == 256) below i is more recent than the most recent carry-KILLING
    position (s < 255).  Requires the true value to fit in the given length
    (no carry out of the top digit).
    """
    lo = x & DIGIT_MASK
    hi = x >> DIGIT_BITS          # in {0, 1}
    s = lo + _shift_up(hi)        # in [0, 256]
    L = s.shape[0]
    idx = jnp.arange(L, dtype=jnp.int32).reshape((L,) + (1,) * (s.ndim - 1))
    gen = jnp.where(s == DIGIT_BASE, idx, -1)
    kill = jnp.where(s < DIGIT_MASK, idx, -1)
    G = jax.lax.cummax(gen, axis=0)
    K = jax.lax.cummax(kill, axis=0)
    carry_in = _shift_up((G > K).astype(jnp.int32))
    return (s + carry_in) & DIGIT_MASK


def normalize(x: jnp.ndarray, digit_bound: int, value_bound: int) -> Tuple[jnp.ndarray, int]:
    """Return (digits in [0,255] of length ceil(bits(value_bound)/8), vb).

    value_bound is an EXCLUSIVE upper bound on the represented value.
    """
    out_len = max(1, -(-((value_bound - 1).bit_length()) // DIGIT_BITS))
    x = _pad_len(x, max(out_len, x.shape[0]))
    while digit_bound > 2 * DIGIT_MASK + 1:  # > 511
        x = _loose_carry_round(x)
        digit_bound = DIGIT_MASK + digit_bound // DIGIT_BASE
    x = _carry_lookahead(x)
    return x[:out_len], value_bound


def conv(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Full digit convolution: out[k] = sum_{i+j=k} a[i] b[j].

    Safe when min(La,Lb) * digit_bound(a) * digit_bound(b) < INT32_SAFE.

    Outer product P[i, j] = a[i] b[j] over the batch, skewed so that row i
    is shifted right by i (pad the columns, flatten, drop the tail, reshape:
    Q[i, k] = P[i, k - i]), then summed over i.  Only elementwise ops,
    pad/reshape/slice and one reduction: XLA fuses them into a single
    reduction whose input is computed from a and b on the fly, so the
    [La, Lout, B] intermediate is never written to memory, and the traced
    graph stays a handful of ops per field multiply (a shift-add loop would
    add O(D) ops per multiply and make the protocol graphs slow to trace).
    A grouped 1-D convolution (feature_group_count = B) is NOT used: XLA:CPU
    expands grouped convs to a dense conv, i.e. O(B^2*La*Lb) work.
    """
    La, Lb = a.shape[0], b.shape[0]
    batch = jnp.broadcast_shapes(a.shape[1:], b.shape[1:])
    if La > Lb:
        a, b, La, Lb = b, a, Lb, La   # reduce over the shorter axis
    Lout = La + Lb - 1
    prod = a.reshape(La, 1, *a.shape[1:]) * b.reshape(1, Lb, *b.shape[1:])
    prod = jnp.broadcast_to(prod, (La, Lb, *batch))
    prod = jnp.pad(prod, [(0, 0), (0, La)] + [(0, 0)] * len(batch))
    skew = prod.reshape(La * (Lb + La), *batch)[:La * Lout]
    return skew.reshape(La, Lout, *batch).sum(axis=0)


def _value_bound_of_digits(L: int, digit_bound: int) -> int:
    return ((1 << (DIGIT_BITS * L)) - 1) // DIGIT_MASK * digit_bound + 1


def _fold_value_bound(value_bound: int, cap: int, k: int, p: int,
                      db_hi: int = DIGIT_MASK,
                      db_lo: int = DIGIT_MASK) -> int:
    """Exact (exclusive) bound on lo + fold(hi) where v = lo + hi*cap < vb,
    lo is the value of the low D digits and hi the value of the k high
    digits.

    With digit bounds db_lo/db_hi (loose digits may exceed 255, so lo may
    exceed cap-1): lo <= min(lo_max, V - hi*cap) where
    lo_max = (cap-1)/255 * db_lo; fold(hi) <= digitsum(hi)*p with
    digitsum(hi) <= min(db_hi*k, hi).  Maximize over the critical hi values.
    """
    V = value_bound - 1
    H = V // cap                          # hi*cap <= v  (lo >= 0)
    lo_max = (cap - 1) // DIGIT_MASK * db_lo
    hi1 = max(0, (V - lo_max) // cap)     # where the lo-clamp ends
    candidates = {0, 1, hi1, hi1 + 1, db_hi * k, H}
    best = 0
    for hi in candidates:
        hi = max(0, min(hi, H))
        lo = min(lo_max, V - hi * cap)
        best = max(best, lo + min(db_hi * k, hi) * p)
    return best + 1


def reduce_work(spec: FieldSpec, x: jnp.ndarray, digit_bound: int,
                value_bound: int, loose: bool = True) -> jnp.ndarray:
    """Reduce a bounded digit array to the working form, value preserved
    mod p.

    loose=True (chained device ops): D digits, each in [0, WORK_DB=511],
    value < ~2*256^D.  Only cheap loose carry rounds and folds are used --
    NO exact carry-lookahead (the two log-depth cummax scans that dominate
    the exact path run only at observation boundaries).

    loose=False (boundaries, e.g. canonicalize entry): D digits in
    [0, 255], value < 256^D -- the exact form the Barrett reduction needs.

    Static-bound-driven loop: every step is decided from python-int bounds
    at trace time.
    """
    D = spec.n_digits
    fold_rows = spec.fold_rows  # numpy [D+4, D]
    cap = 1 << (DIGIT_BITS * D)
    # The fold accumulates k products each <= db*255 in int32.
    fold_cap = INT32_SAFE

    def fold(x, k, hi_db):
        """Fold digit rows >= D back into the low D digits: a broadcast
        multiply against the constant ``2^(8i) mod p`` rows and a sum over
        the k high rows (XLA fuses both into one reduction)."""
        assert k <= fold_rows.shape[0], (k, D)
        hi = x[D:]
        rows = jnp.asarray(fold_rows[:k]).reshape(
            (k, D) + (1,) * (x.ndim - 1))
        folded = (hi[:, None] * rows).sum(axis=0)
        return x[:D] + folded

    if loose:
        for _ in range(24):
            L = x.shape[0]
            k = max(0, L - D)
            # Cheap carry rounds: digits under WORK_DB and fold exact.
            while digit_bound > WORK_DB or (
                    k and k * digit_bound * DIGIT_MASK + digit_bound > fold_cap):
                x = _pad_len(x, max(
                    L, -(-((value_bound - 1).bit_length()) // DIGIT_BITS)))
                x = _loose_carry_round(x)
                digit_bound = DIGIT_MASK + digit_bound // DIGIT_BASE
                L = x.shape[0]
                k = max(0, L - D)
            # Rows above the value-bound length are provably zero
            # (non-negative digits are each bounded by the total value).
            need = max(1, -(-((value_bound - 1).bit_length()) // DIGIT_BITS))
            if need < L:
                x = x[:need]
                L = need
                k = max(0, L - D)
            if k == 0:
                return _pad_len(x, D)
            if value_bound <= 2 * cap:
                # Terminal: value < 2*cap, so after ONE exact normalize the
                # top digit is <= 1 and one fold lands digits at <= 510.
                # This is the ONLY carry-lookahead in a loose reduction
                # (the exact path runs one per iteration).
                x, value_bound = normalize(x, digit_bound, value_bound)
                if x.shape[0] <= D:
                    return _pad_len(x, D)
                assert x.shape[0] == D + 1
                return fold(x, 1, 1)
            # Generic fold with value-tightened per-row hi bounds: row D+j
            # holds at most (vb-1) >> (8*(D+j)) whatever the digit bound.
            hi_bounds = [min(digit_bound,
                             (value_bound - 1) >> (DIGIT_BITS * (D + j)))
                         for j in range(k)]
            x = fold(x, k, digit_bound)
            digitsum = sum(hi_bounds)
            value_bound = min(
                _fold_value_bound(value_bound, cap, k, spec.p,
                                  db_hi=digit_bound, db_lo=digit_bound),
                (cap - 1) // DIGIT_MASK * digit_bound + digitsum * spec.p + 1)
            digit_bound = digit_bound + digitsum * DIGIT_MASK
        raise AssertionError("reduce_work(loose) did not converge (bound bug)")

    for _ in range(8):
        # Make the fold matmul overflow-safe, then normalize exactly.
        L = x.shape[0]
        k = max(0, L - D)
        while k and k * digit_bound * DIGIT_MASK + digit_bound > fold_cap:
            # One cheap loose round drops digit_bound by ~256x.
            x = _pad_len(x, max(L, -(-((value_bound - 1).bit_length()) // DIGIT_BITS)))
            x = _loose_carry_round(x)
            digit_bound = DIGIT_MASK + digit_bound // DIGIT_BASE
            L = x.shape[0]
            k = max(0, L - D)

        x, value_bound = normalize(x, digit_bound, value_bound)
        digit_bound = DIGIT_MASK
        L = x.shape[0]
        if L <= D and value_bound <= cap:
            return _pad_len(x, D)

        # Fold digits at positions >= D back into the low D digits.
        k = L - D
        x = fold(x, k, digit_bound)
        digit_bound = DIGIT_MASK + k * DIGIT_MASK * DIGIT_MASK
        value_bound = _fold_value_bound(value_bound, cap, k, spec.p)
    raise AssertionError("reduce_work did not converge (bound bug)")


# ---------------------------------------------------------------------------
# Public field ops.  Inputs/outputs are in the LOOSE working form:
# [D, *batch] int32 digits in [0, WORK_DB=511], congruent to the field
# element mod p (value < ~2*256^D, not necessarily < p; use canonicalize()
# at observation boundaries, which first restores the exact form).
# ---------------------------------------------------------------------------


def _work_vb(spec: FieldSpec) -> int:
    """Exclusive value bound of the loose working form."""
    return _value_bound_of_digits(spec.n_digits, WORK_DB)

def _add_one_lsd(x: jnp.ndarray) -> jnp.ndarray:
    """x with 1 added to the least-significant digit row (slice+concat
    instead of .at[0].add, which lowers to a scatter-add)."""
    return jnp.concatenate([x[:1] + 1, x[1:]], axis=0)


def zeros(spec: FieldSpec, batch=()) -> jnp.ndarray:
    return jnp.zeros((spec.n_digits, *batch), dtype=jnp.int32)


def add(spec: FieldSpec, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return reduce_work(spec, a + b, 2 * WORK_DB, 2 * (_work_vb(spec) - 1) + 1)


def sub(spec: FieldSpec, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """a - b via the borrow-free complement at width 2^cb >= WORK_DB+1 plus
    an additive mod-p fixup constant (see sub_raw), so everything stays
    non-negative int32 for loose-form inputs."""
    s = sub_raw(spec, a, b, WORK_DB)
    cb = max(8, WORK_DB.bit_length())
    D = spec.n_digits
    comp_vb = ((1 << cb) - 1) * (((1 << (DIGIT_BITS * D)) - 1) // DIGIT_MASK)
    vb = (_work_vb(spec) - 1) + comp_vb + spec.p + 1
    return reduce_work(spec, s, sub_bound(WORK_DB, WORK_DB), vb)


def neg(spec: FieldSpec, b: jnp.ndarray) -> jnp.ndarray:
    return sub(spec, zeros(spec, b.shape[1:]), b)


def mul(spec: FieldSpec, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    D = spec.n_digits
    c = conv(a, b)  # [2D-1], digit bound D*511^2 < 2^24
    vb = _work_vb(spec)
    return reduce_work(spec, c, D * WORK_DB * WORK_DB, vb * vb)


def square(spec: FieldSpec, a: jnp.ndarray) -> jnp.ndarray:
    return mul(spec, a, a)


def mul_small(spec: FieldSpec, a: jnp.ndarray, c: int) -> jnp.ndarray:
    """Multiply by a small non-negative python int (c < 2^20)."""
    assert 0 <= c < (1 << 20)
    return reduce_work(spec, a * c, WORK_DB * c,
                       (_work_vb(spec) - 1) * c + 1)


# ---------------------------------------------------------------------------
# Lazy (bound-threaded) ops: additions/subtractions cost O(1) vector ops; all
# carry work is deferred into the next multiply's reduction.  Callers thread
# static digit bounds.  Used by the hot composite kernels (curve formulas).
# ---------------------------------------------------------------------------

def add_raw(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Lazy add: digit bound of result = da + db (caller tracks)."""
    return a + b


@functools.lru_cache(maxsize=None)
def _comp_constant(spec: FieldSpec, comp_bits: int) -> np.ndarray:
    """K = (-(2^cb - 1) * (256^D - 1)/255) mod p as D digits: the additive
    fixup for the borrow-free complement subtraction at width 2^cb."""
    D = spec.n_digits
    comp_base = ((1 << comp_bits) - 1) * (((1 << (DIGIT_BITS * D)) - 1) // DIGIT_MASK)
    from .spec import int_to_digits
    return int_to_digits((-comp_base) % spec.p, D)


def sub_raw(spec: FieldSpec, a: jnp.ndarray, b: jnp.ndarray, db_b: int) -> jnp.ndarray:
    """Lazy subtract via complement at width 2^ceil(bits(db_b)):
    result digit bound = da + 2^cb - 1 + 255 (caller tracks);
    value is congruent to a - b mod p."""
    cb = max(8, db_b.bit_length())
    comp = ((1 << cb) - 1) - b
    K = jnp.asarray(_comp_constant(spec, cb)).reshape(
        (spec.n_digits,) + (1,) * (a.ndim - 1))
    return a + comp + K


def sub_bound(da: int, db_b: int) -> int:
    cb = max(8, db_b.bit_length())
    return da + (1 << cb) - 1 + DIGIT_MASK


def normalize_partial(x: jnp.ndarray, digit_bound: int, value_bound: int):
    """One loose carry round with length derived from the value bound."""
    out_len = max(x.shape[0], -(-((value_bound - 1).bit_length()) // DIGIT_BITS))
    x = _pad_len(x, out_len)
    return _loose_carry_round(x), DIGIT_MASK + digit_bound // DIGIT_BASE


def product_sum(spec: FieldSpec, terms) -> jnp.ndarray:
    """Fused sum of signed products with ONE carry reduction:

        result = sum_i sign_i * a_i * b_i   (mod p)

    terms: list of (a, da, b_or_None, db, sign).  b=None means the term is
    `sign * a` alone.  Inputs may be loose (bounds threaded); negative terms
    use the borrow-free complement at a power-of-two width plus an additive
    mod-p fixup constant, so everything stays non-negative int32.

    This is the workhorse primitive: a batched point addition is 9 of these
    instead of 12 independent reductions; an MDS row and the
    vanishing-polynomial alpha-combination are each ONE.
    """
    from .spec import int_to_digits
    D = spec.n_digits
    parts = []   # (arr, db, vb)
    k_fixup = 0  # accumulated python-int congruence fixups (mod p)
    batch = None
    for a, da, b, db, sign in terms:
        if b is None:
            c = a
            dcb = da
            vb = _value_bound_of_digits(a.shape[0], da)
        else:
            # conv overflow guard (int32)
            while min(a.shape[0], b.shape[0]) * da * db > INT32_SAFE:
                if da >= db:
                    a, da = normalize_partial(
                        a, da, _value_bound_of_digits(a.shape[0], da))
                else:
                    b, db = normalize_partial(
                        b, db, _value_bound_of_digits(b.shape[0], db))
            va = _value_bound_of_digits(a.shape[0], da)
            vbb = _value_bound_of_digits(b.shape[0], db)
            c = conv(a, b)
            dcb = min(a.shape[0], b.shape[0]) * da * db
            vb = va * vbb
        # keep each part small enough that summing a handful stays in int32
        while dcb > (1 << 26):
            c, dcb = normalize_partial(c, dcb, vb)
        if sign < 0:
            cb = max(8, dcb.bit_length())
            L = c.shape[0]
            comp_base = ((1 << cb) - 1) * (((1 << (DIGIT_BITS * L)) - 1) // DIGIT_MASK)
            k_fixup = (k_fixup - comp_base) % spec.p
            c = ((1 << cb) - 1) - c
            dcb = (1 << cb) - 1
            vb = _value_bound_of_digits(L, dcb)
        parts.append((c, dcb, vb))
        batch = jnp.broadcast_shapes(batch or (), c.shape[1:])

    assert sum(db for _, db, _ in parts) + DIGIT_MASK <= INT32_SAFE
    L = max(c.shape[0] for c, _, _ in parts)
    total = None
    for c, _, _ in parts:
        c = _pad_len(c, L)
        total = c if total is None else total + c
    db_tot = sum(db for _, db, _ in parts)
    vb_tot = sum(vb for _, _, vb in parts)
    if k_fixup:
        Lm = max(L, D)
        K = jnp.asarray(int_to_digits(k_fixup, D)).reshape(
            (D,) + (1,) * (total.ndim - 1))
        total = _pad_len(total, Lm) + _pad_len(K, Lm)
        db_tot += DIGIT_MASK
        vb_tot += spec.p
    return reduce_work(spec, total, db_tot, vb_tot)


def mul_loose(spec: FieldSpec, a: jnp.ndarray, b: jnp.ndarray,
              da: int = WORK_DB, db: int = WORK_DB) -> jnp.ndarray:
    """Multiply two loose-digit values; output is in the loose working
    form (digits <= WORK_DB, length D)."""
    return product_sum(spec, [(a, da, b, db, 1)])


def sum_reduce(spec: FieldSpec, x: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Sum many field elements along a batch axis: a digitwise int32 sum
    followed by ONE reduction -- field addition is linear in the digit
    representation, so n-term sums cost (nearly) one add.  axis is an index
    into the batch dims (axis=0 is the first batch axis, i.e. array axis 1)."""
    assert axis >= 0
    n = x.shape[axis + 1]
    assert n * WORK_DB < INT32_SAFE
    s = jnp.sum(x, axis=axis + 1)
    return reduce_work(spec, s, n * WORK_DB, n * (_work_vb(spec) - 1) + 1)


def select(mask: jnp.ndarray, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Elementwise field select: mask shaped like the batch (bool/int)."""
    return jnp.where(mask[None].astype(bool), a, b)


def exp_const(spec: FieldSpec, x: jnp.ndarray, e: int) -> jnp.ndarray:
    """x^e for a static python-int exponent, via a bit scan.

    Uses lax.scan so the traced program stays small regardless of e.
    (reference semantics: src/field/field.rs:309-331 `exp`)
    """
    if e == 0:
        return _one_like(spec, x)
    assert e > 0
    nbits = e.bit_length()
    bits = jnp.asarray([(e >> i) & 1 for i in range(nbits)], dtype=jnp.int32)

    def body(carry, bit):
        acc, cur = carry
        acc = select(jnp.full(acc.shape[1:], bit, jnp.int32),
                     mul(spec, acc, cur), acc)
        cur = square(spec, cur)
        return (acc, cur), None

    one = _one_like(spec, x)
    (acc, _), _ = jax.lax.scan(body, (one, x), bits)
    return acc


def exp_dyn(spec: FieldSpec, x: jnp.ndarray, e_bits: jnp.ndarray) -> jnp.ndarray:
    """x^e where e is given as a runtime little-endian bit array [nbits, *batch]."""
    def body(carry, bit):
        acc, cur = carry
        acc = select(bit, mul(spec, acc, cur), acc)
        cur = square(spec, cur)
        return (acc, cur), None

    one = _one_like(spec, x)
    (acc, _), _ = jax.lax.scan(body, (one, x), e_bits)
    return acc


def inverse(spec: FieldSpec, x: jnp.ndarray) -> jnp.ndarray:
    """Multiplicative inverse via Fermat: x^(p-2).  inverse(0) = 0.

    Branch-free (the reference uses binary GCD, src/bigint/bigint_inverse.rs;
    an exponentiation is the batched equivalent: fixed-depth, no branches).
    """
    return exp_const(spec, x, spec.p - 2)


def kth_root(spec: FieldSpec, x: jnp.ndarray, k: int) -> jnp.ndarray:
    """x^(1/k) assuming x -> x^k is a permutation.

    Host-precomputed exponent (reference: src/field/field.rs:346-375), then a
    single batched exponentiation on device.
    """
    e = kth_root_exponent(spec, k)
    return exp_const(spec, x, e)


@functools.lru_cache(maxsize=None)
def kth_root_exponent(spec: FieldSpec, k: int) -> int:
    """Find e with (x^e)^k = x: e = (p + n(p-1))/k for the smallest valid n.

    Mirrors the search in the reference (src/field/field.rs:346-375) so the
    same root is chosen.
    """
    p = spec.p
    p_minus_1 = p - 1
    numerator = p
    n = 0
    while n < k:
        n += 1
        numerator += p_minus_1
        if numerator % k == 0:
            return (numerator // k) % p_minus_1
    raise ValueError(f"x^{k} is not a permutation in {spec.name}")


# ---------------------------------------------------------------------------
# Canonicalization (exact Barrett reduction) and comparisons
# ---------------------------------------------------------------------------

def canonicalize(spec: FieldSpec, x: jnp.ndarray) -> jnp.ndarray:
    """Working form -> canonical digits: value < p, shape [D, *batch].

    First restores the EXACT working form (digits <= 255, value < 256^D)
    from the loose form chained ops produce, then runs an exact Barrett
    reduction, HAC Algorithm 14.42 in base 256.
    """
    D, k = spec.n_digits, spec.k_digits
    assert x.shape[0] == D
    x = reduce_work(spec, x, WORK_DB, _work_vb(spec), loose=False)
    mu = jnp.asarray(spec.barrett_mu)          # [Lmu]
    p_k1 = jnp.asarray(spec.p_digits_k1)       # [k+1]
    Lmu = mu.shape[0]

    # q1 = floor(v / 256^(k-1)):  digits k-1 .. D-1
    q1 = x[k - 1:]
    Lq1 = D - (k - 1)
    # q2 = q1 * mu   (digit bounds: min(Lq1,Lmu)*255*255 < 2^31 easily)
    bshape = x.shape[1:]
    q2 = conv(q1, mu.reshape((Lmu,) + (1,) * len(bshape)))
    q2_vb = _value_bound_of_digits(Lq1, DIGIT_MASK) * _value_bound_of_digits(Lmu, DIGIT_MASK)
    q2n, _ = normalize(q2, min(Lq1, Lmu) * DIGIT_MASK * DIGIT_MASK, q2_vb)
    # q3 = floor(q1*mu / 256^(k+1))
    q3 = q2n[k + 1:]
    Lq3 = q2n.shape[0] - (k + 1)
    assert Lq3 >= 1
    # r2 = (q3 * p) mod 256^(k+1)
    r2c = conv(q3, p_k1.reshape((k + 1,) + (1,) * len(bshape)))
    r2_vb = _value_bound_of_digits(Lq3, DIGIT_MASK) * spec.p
    r2n, _ = normalize(r2c, min(Lq3, k + 1) * DIGIT_MASK * DIGIT_MASK, r2_vb)
    r2 = _pad_len(r2n, max(k + 1, r2n.shape[0]))[:k + 1]
    # r = (v - q3*p) mod 256^(k+1), via complement add; true r in [0, 3p)
    r1 = x[:k + 1]
    s = r1 + (DIGIT_MASK - r2)
    s = _add_one_lsd(s)
    sn, _ = normalize(s, 2 * DIGIT_MASK + 1, 1 << (DIGIT_BITS * (k + 2)))
    r = _pad_len(sn, k + 2)[:k + 1]   # drop the wrap-around carry: mod 256^(k+1)

    # r < 3p: conditionally subtract 2p then p.
    for j in (1, 0):  # csub_tables[1] = 256^(k+2) - 2p, [0] = 256^(k+2) - p
        tbl = jnp.asarray(spec.csub_tables[j]).reshape((k + 2,) + (1,) * len(bshape))
        w = _pad_len(r, k + 2) + tbl
        wn, _ = normalize(w, 2 * DIGIT_MASK, 1 << (DIGIT_BITS * (k + 3)))
        wn = _pad_len(wn, k + 3)
        ge = wn[k + 2]  # 1 iff r >= (j+1)*p
        r = jnp.where(ge[None].astype(bool), wn[:k + 1], r)

    return _pad_len(r, D)


def is_zero(spec: FieldSpec, x: jnp.ndarray) -> jnp.ndarray:
    c = canonicalize(spec, x)
    return jnp.all(c == 0, axis=0)


def eq(spec: FieldSpec, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    ca = canonicalize(spec, a)
    cb = canonicalize(spec, b)
    return jnp.all(ca == cb, axis=0)


def to_bits(spec: FieldSpec, x: jnp.ndarray, n_bits: int) -> jnp.ndarray:
    """Canonical little-endian bits [n_bits, *batch] of x."""
    c = canonicalize(spec, x)
    idx = np.arange(n_bits)
    dig = c[idx // DIGIT_BITS]
    shifts = jnp.asarray(idx % DIGIT_BITS, dtype=jnp.int32).reshape(
        (n_bits,) + (1,) * (x.ndim - 1))
    return (dig >> shifts) & 1


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jitted(name: str, spec: FieldSpec, *static):
    """Cached jit of a module function with the spec (and any trailing static
    args) closed over.  e.g. jitted('mul', spec)(a, b)."""
    fn = globals()[name]
    return jax.jit(functools.partial(fn, spec, *static))


def _one_like(spec: FieldSpec, x: jnp.ndarray) -> jnp.ndarray:
    one = jnp.zeros_like(x)
    return one.at[0].set(1)


def constant(spec: FieldSpec, v: int, batch=()) -> jnp.ndarray:
    """Embed a python int as a working-form array broadcast over batch."""
    d = spec.to_digits(v)
    arr = jnp.asarray(d, dtype=jnp.int32)
    return jnp.broadcast_to(arr.reshape((spec.n_digits,) + (1,) * len(batch)),
                            (spec.n_digits, *batch))


def from_ints(spec: FieldSpec, values, batch_shape=None) -> jnp.ndarray:
    """Stack python ints into [D, len(values)] working form (host helper)."""
    arr = np.stack([spec.to_digits(int(v) % spec.p) for v in values], axis=-1)
    return jnp.asarray(arr)


def to_ints(spec: FieldSpec, x: jnp.ndarray):
    """Device array [D, *batch] -> nested python ints (host, canonical)."""
    c = np.asarray(jitted('canonicalize', spec)(x))
    flat = c.reshape(spec.n_digits, -1)
    vals = []
    for j in range(flat.shape[1]):
        v = 0
        for i in range(spec.n_digits):
            v |= int(flat[i, j]) << (DIGIT_BITS * i)
        vals.append(v)
    shape = x.shape[1:]
    out = np.array(vals, dtype=object).reshape(shape) if shape else vals[0]
    return out
