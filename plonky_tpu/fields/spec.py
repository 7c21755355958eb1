"""Field specification: static per-field constants and derived device tables.

Batched data model (see SURVEY.md section 7): a field element is NOT a
scalar; it is a little-endian vector of 8-bit digits stored as int32, with
the digit axis FIRST (shape ``[D, *batch]``) so that large batches are the
contiguous dimension.  All arithmetic operates on such digit vectors with
explicit, statically-bounded carries; multiplication is a digit convolution
followed by a "fold" against a precomputed reduction matrix (a contraction,
the batched formulation of modular reduction) plus a final exact Barrett
pass for canonicalization.

This replaces the reference's 4/6-limb u64 Montgomery engine
(reference: src/field/monty.rs, src/bigint/bigint_arithmetic.rs) with a
representation that maps onto hardware lacking wide integer multiply.
Values are canonical integers throughout (no Montgomery form); canonical
encodings therefore agree with the reference's ``to_canonical`` outputs.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np

DIGIT_BITS = 8
DIGIT_BASE = 1 << DIGIT_BITS
DIGIT_MASK = DIGIT_BASE - 1


def int_to_digits(v: int, n: int) -> np.ndarray:
    """Little-endian base-256 digits of v as int32[n]."""
    assert 0 <= v < (1 << (DIGIT_BITS * n)), (v, n)
    out = np.zeros(n, dtype=np.int32)
    i = 0
    while v:
        out[i] = v & DIGIT_MASK
        v >>= DIGIT_BITS
        i += 1
    return out


def digits_to_int(d) -> int:
    """Inverse of int_to_digits (accepts any digit values, not just [0,256))."""
    v = 0
    for i, x in enumerate(np.asarray(d).astype(object)):
        v += int(x) << (DIGIT_BITS * i)
    return v


@dataclass(frozen=True)
class FieldSpec:
    """Static description of a prime field plus derived device tables.

    The six instances mirror the reference's six concrete fields
    (reference: src/field/*.rs); only the mathematical constants are taken
    from the reference -- the representation and all tables are new.
    """

    name: str
    p: int                      # field order
    generator: int              # MULTIPLICATIVE_SUBGROUP_GENERATOR (canonical)
    alpha: int                  # smallest a with x^a a permutation
    two_adicity: int

    # ------------------------------------------------------------------
    # Derived scalars
    # ------------------------------------------------------------------
    @property
    def bits(self) -> int:
        return self.p.bit_length()

    @property
    def bytes_(self) -> int:
        return -(-self.bits // 8)

    @property
    def t(self) -> int:
        """T = (p - 1) / 2^two_adicity (reference: src/field/field.rs:53)."""
        return (self.p - 1) >> self.two_adicity

    @property
    def k_digits(self) -> int:
        """Number of digits that exactly cover p's bit length (Barrett k)."""
        return -(-self.bits // DIGIT_BITS)

    @property
    def n_digits(self) -> int:
        """Working representation width D: >= bits+16 bits of headroom.

        Invariant of the working representation: D int32 digits, each in
        [0, 256), little-endian, encoding a value in [0, 256^D) congruent
        to the represented field element mod p.  The 2-digit headroom makes
        the post-multiplication fold terminate in a single select-add.
        """
        return -(-(self.bits + 16) // DIGIT_BITS)

    # Montgomery radix of the *reference* implementation: R = 2^(64*ceil)
    # Used only to replicate `rand_from_rng` (which fills the Montgomery
    # limbs with uniform bits; reference: src/field/tweedledee_base.rs:203).
    @property
    def ref_monty_r(self) -> int:
        n_u64 = -(-self.bits // 64)
        return pow(2, 64 * n_u64, self.p)

    # ------------------------------------------------------------------
    # Derived device tables (numpy; moved to device lazily by ops.py)
    # ------------------------------------------------------------------
    @functools.cached_property
    def p_digits(self) -> np.ndarray:
        return int_to_digits(self.p, self.n_digits)

    @functools.cached_property
    def fold_rows(self) -> np.ndarray:
        """FOLD[j] = digits of (2^(8*(D+j)) mod p), j = 0..D+3. [D+4, D] int32.

        Folding digit d at position D+j into the low D digits is adding
        d * FOLD[j]; this turns modular reduction of a 2D-digit convolution
        result into a small matmul.
        """
        D = self.n_digits
        return np.stack([
            int_to_digits(pow(2, DIGIT_BITS * (D + j), self.p), D)
            for j in range(D + 4)
        ])

    @functools.cached_property
    def top_fold(self) -> np.ndarray:
        """Digits of 2^(8*D) mod p: the single-digit select-add constant."""
        return int_to_digits(pow(2, DIGIT_BITS * self.n_digits, self.p), self.n_digits)

    @functools.cached_property
    def sub_pad(self) -> np.ndarray:
        """Digits of (ceil(256^D / p) * p - 256^D).

        sub(a, b) = a + (255... - b) + sub_pad + 1: the complement trick,
        borrow-free (any multiple of p may be added without changing the
        residue; this one makes the complement sum non-negative).
        """
        D = self.n_digits
        k_c = -(-(1 << (DIGIT_BITS * D)) // self.p)
        return int_to_digits(k_c * self.p - (1 << (DIGIT_BITS * D)), D)

    # ---- Barrett canonicalization tables (HAC 14.42, base 256) ----
    @functools.cached_property
    def barrett_mu(self) -> np.ndarray:
        """mu = floor(256^(2k) / p), k = k_digits. Width 2k+1-k+1 digits."""
        k = self.k_digits
        mu = (1 << (DIGIT_BITS * 2 * k)) // self.p
        width = -(-mu.bit_length() // DIGIT_BITS)
        return int_to_digits(mu, width)

    @functools.cached_property
    def p_digits_k1(self) -> np.ndarray:
        """p as k+1 digits (for the Barrett mod-b^(k+1) subtraction)."""
        return int_to_digits(self.p, self.k_digits + 1)

    @functools.cached_property
    def csub_tables(self) -> np.ndarray:
        """CSUB[j] = digits of (256^(k+2) - (j+1)*p), j = 0, 1. [2, k+2]."""
        k = self.k_digits
        top = 1 << (DIGIT_BITS * (k + 2))
        return np.stack([
            int_to_digits(top - (j + 1) * self.p, k + 2) for j in range(2)
        ])

    # ------------------------------------------------------------------
    # Host-side helpers
    # ------------------------------------------------------------------
    def to_digits(self, v: int) -> np.ndarray:
        """Canonical int -> working digit vector [D]."""
        v = v % self.p
        return int_to_digits(v, self.n_digits)

    def from_digits(self, d) -> int:
        """Working digit vector -> canonical int (reduces mod p on host)."""
        return digits_to_int(d) % self.p

    def __hash__(self):
        return hash((self.name, self.p))
