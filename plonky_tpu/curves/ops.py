"""Batched, branch-free curve arithmetic on device.

Replaces the reference's branchy affine/projective formulas
(reference: src/curve/curve_adds.rs:5-128, which special-cases zero/equal/
inverse points) with the COMPLETE projective formulas of Renes-Costello-Batina
2015 (eprint 2015/1060, Algorithms 7 & 9 for a = 0).  Complete formulas have
no exceptional cases, so they vectorize with zero control flow (SURVEY.md
section 7 "hard parts" #3).  Case-equivalence
against the reference's branchy semantics is covered by tests.

A batched point is a (X, Y, Z) tuple of digit arrays [D, *batch]; the
identity is (0, 1, 0).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from ..fields import ops as fops
from .spec import CurveSpec

Point = Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]


def identity(curve: CurveSpec, batch=()) -> Point:
    f = curve.base
    return (fops.zeros(f, batch),
            fops.constant(f, 1, batch),
            fops.zeros(f, batch))


def from_affine(curve: CurveSpec, x: jnp.ndarray, y: jnp.ndarray,
                zero_mask=None) -> Point:
    """Affine coords (+ optional zero mask over the batch) -> projective."""
    f = curve.base
    one = fops.constant(f, 1, x.shape[1:])
    if zero_mask is None:
        return (x, y, one)
    z = fops.select(~zero_mask, one, fops.zeros(f, x.shape[1:]))
    xx = fops.select(~zero_mask, x, fops.zeros(f, x.shape[1:]))
    yy = fops.select(~zero_mask, y, one)
    return (xx, yy, z)


class _LV:
    """Loose field value: a digit array with a statically tracked bound.
    Additions/subtractions/small-scalings are O(1) vector ops; all carry
    work happens inside fused product_sum reductions."""
    __slots__ = ("arr", "db", "f")

    def __init__(self, f, arr, db=fops.WORK_DB):
        self.f = f
        self.arr = arr
        self.db = db

    def __add__(self, o):
        return _LV(self.f, fops.add_raw(self.arr, o.arr), self.db + o.db)

    def small(self, c: int):
        return _LV(self.f, self.arr * c, self.db * c)


def _ps(f, *terms) -> _LV:
    """terms: (sign, x [, y]) with x/y _LV -> fused signed product sum."""
    packed = []
    for t in terms:
        if len(t) == 2:
            sign, x = t
            packed.append((x.arr, x.db, None, 0, sign))
        else:
            sign, x, y = t
            packed.append((x.arr, x.db, y.arr, y.db, sign))
    return _LV(f, fops.product_sum(f, packed))


def add(curve: CurveSpec, p1: Point, p2: Point) -> Point:
    """Complete projective addition, RCB15 Algorithm 7 (a = 0): lazy adds
    plus 9 fused product-sum reductions keep the traced graph of a batched
    point add small."""
    f = curve.base
    b3 = 3 * curve.b % f.p
    X1, Y1, Z1 = (_LV(f, t) for t in p1)
    X2, Y2, Z2 = (_LV(f, t) for t in p2)
    ps = lambda *ts: _ps(f, *ts)

    t0 = ps((1, X1, X2))
    t1 = ps((1, Y1, Y2))
    t2 = ps((1, Z1, Z2))
    # t3 = (X1+Y1)(X2+Y2) - t0 - t1
    t3 = ps((1, X1 + Y1, X2 + Y2), (-1, t0), (-1, t1))
    # t4 = (Y1+Z1)(Y2+Z2) - t1 - t2
    t4 = ps((1, Y1 + Z1, Y2 + Z2), (-1, t1), (-1, t2))
    # xz = (X1+Z1)(X2+Z2) - t0 - t2   ("Y3" intermediate in RCB)
    xz = ps((1, X1 + Z1, X2 + Z2), (-1, t0), (-1, t2))
    t0_3 = t0.small(3)
    t2b3 = t2.small(b3)
    z3p = t1 + t2b3                  # Z3 intermediate
    t1m = _LV(f, fops.sub_raw(f, t1.arr, t2b3.arr, t2b3.db),
              fops.sub_bound(t1.db, t2b3.db))   # t1 - b3*t2
    yb3 = xz.small(b3)
    X3 = ps((1, t3, t1m), (-1, t4, yb3))
    Y3 = ps((1, yb3, t0_3), (1, t1m, z3p))
    Z3 = ps((1, z3p, t4), (1, t0_3, t3))
    return (X3.arr, Y3.arr, Z3.arr)


def double(curve: CurveSpec, p: Point) -> Point:
    """Complete projective doubling, RCB15 Algorithm 9 (a = 0)."""
    f = curve.base
    b3 = 3 * curve.b % f.p
    X, Y, Z = (_LV(f, t) for t in p)
    ps = lambda *ts: _ps(f, *ts)

    t0 = ps((1, Y, Y))
    z3p = t0.small(8)                # 8*Y^2
    t1 = ps((1, Y, Z))
    t2 = ps((1, Z, Z))
    t2b3 = t2.small(b3)
    X3p = ps((1, t2b3, z3p))         # b3*Z^2 * 8Y^2
    y3p = t0 + t2b3
    Z3 = ps((1, t1, z3p))
    t0m = _LV(f, fops.sub_raw(f, t0.arr, t2b3.small(3).arr, t2b3.db * 3),
              fops.sub_bound(t0.db, t2b3.db * 3))   # t0 - 3*b3*Z^2
    Y3 = ps((1, t0m, y3p), (1, X3p))
    txy = ps((1, X, Y))
    X3 = ps((1, t0m.small(2), txy))
    return (X3.arr, Y3.arr, Z3.arr)


def neg(curve: CurveSpec, p: Point) -> Point:
    X, Y, Z = p
    return (X, fops.neg(curve.base, Y), Z)


def select(mask: jnp.ndarray, p1: Point, p2: Point) -> Point:
    return tuple(fops.select(mask, a, b) for a, b in zip(p1, p2))


def is_identity(curve: CurveSpec, p: Point) -> jnp.ndarray:
    return fops.is_zero(curve.base, p[2])


def to_affine(curve: CurveSpec, p: Point) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Projective -> (x, y, zero_mask).  Batched Fermat inversion
    (reference batch_to_affine: src/curve/curve.rs:216-232 uses Montgomery's
    trick; a fixed-depth exponentiation is the branch-free equivalent)."""
    f = curve.base
    X, Y, Z = p
    zinv = fops.inverse(f, Z)
    x = fops.mul(f, X, zinv)
    y = fops.mul(f, Y, zinv)
    return x, y, fops.is_zero(f, Z)


def scalar_mul_bits(curve: CurveSpec, p: Point, bits: jnp.ndarray) -> Point:
    """Double-and-add over a little-endian bit array [nbits, *batch]."""
    import jax

    def body(carry, bit):
        acc, cur = carry
        acc = select(bit, add(curve, acc, cur), acc)
        cur = double(curve, cur)
        return (acc, cur), None

    acc0 = identity(curve, p[0].shape[1:])
    (acc, _), _ = jax.lax.scan(body, (acc0, p), bits)
    return acc


def eq_points(curve: CurveSpec, p1: Point, p2: Point) -> jnp.ndarray:
    """Projective equality: X1 Z2 == X2 Z1, Y1 Z2 == Y2 Z1, both-zero match."""
    f = curve.base
    x_eq = fops.eq(f, fops.mul(f, p1[0], p2[2]), fops.mul(f, p2[0], p1[2]))
    y_eq = fops.eq(f, fops.mul(f, p1[1], p2[2]), fops.mul(f, p2[1], p1[2]))
    z1z = fops.is_zero(f, p1[2])
    z2z = fops.is_zero(f, p2[2])
    return (x_eq & y_eq & ~z1z & ~z2z) | (z1z & z2z)
