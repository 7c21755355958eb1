"""Multi-scalar multiplication (Pippenger), dense and branch-free.

Replaces the reference's digit-multimap Yao method
(reference: src/curve/curve_msm.rs:63-157, pointer-chasing and rayon-chunked)
with a sort + segmented-scan bucket accumulation that is fully static-shaped
and batched -- the data-parallel restructuring called for by SURVEY.md P2.

Pipeline per window (all under one jit, windows processed by lax.scan):
  1. extract c-bit digits from canonical scalar bits
  2. argsort points by digit
  3. segmented inclusive scan with the complete-addition combiner
     (log2 N batched point adds) -> per-segment sums at segment ends
  4. gather bucket sums, reduce  sum_j j*B_j  via constant-shape chunked
     cumulative point-add scans (reversed cumsum + total)
  5. Horner combine across windows (c doublings per window), batched
     across the MSMs of a multi-MSM call
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from ..fields import ops as fops
from ..fields import spec as fspec
from . import ops as cops
from .spec import CurveSpec


def scalar_window_digits(spec, scalars: jnp.ndarray, c: int) -> jnp.ndarray:
    """Canonical scalars [Ds, N] -> window digits [n_windows, N] (LSW first)."""
    n_bits = spec.bits
    n_windows = -(-n_bits // c)
    # to_bits indexes digit idx//DIGIT_BITS; never ask past the digit array
    n_avail = spec.n_digits * fspec.DIGIT_BITS
    bits = fops.to_bits(spec, scalars, min(n_windows * c, n_avail))
    pad = n_windows * c - bits.shape[0]
    if pad:
        bits = jnp.concatenate(
            [bits, jnp.zeros((pad, *bits.shape[1:]), bits.dtype)], axis=0)
    bits = bits.reshape(n_windows, c, *scalars.shape[1:])
    weights = jnp.asarray([1 << k for k in range(c)], dtype=jnp.int32)
    return jnp.einsum('wc...,c->w...', bits, weights)


def scalar_window_digits_signed(spec, scalars: jnp.ndarray, c: int):
    """Signed window digits: (magnitudes, signs), both [n_windows+1, .., N].

    Standard signed-window recoding: a digit d >= 2^(c-1) becomes d - 2^c
    with a carry into the next window, so magnitudes lie in [0, 2^(c-1)]
    -- HALF the bucket range of the unsigned form at the same window width
    (the negation that pays for it is a free Y-negation on the gathered
    points).  One extra all-{0,1} window absorbs the final carry.
    Replaces the unsigned digit split of src/curve/curve_msm.rs:63-80 with
    the classic bucket-halving trick the reference leaves on the table."""
    d = scalar_window_digits(spec, scalars, c)          # [W, .., N]
    d = jnp.concatenate([d, jnp.zeros_like(d[:1])], axis=0)
    half, full = 1 << (c - 1), 1 << c

    def step(carry, dw):
        t = dw + carry
        ge = t >= half
        mag = jnp.where(ge, full - t, t)
        sign = jnp.where(ge, -1, 1).astype(jnp.int32)
        return ge.astype(dw.dtype), (mag, sign)

    _, (mags, signs) = jax.lax.scan(
        step, jnp.zeros(d.shape[1:], d.dtype), d)
    return mags, signs


def _segmented_add_scan(curve: CurveSpec, pts: cops.Point, first_flags: jnp.ndarray):
    """Inclusive segmented scan along the last axis with point addition.

    first_flags[i] = 1 iff element i starts a new segment.  Returns the
    running per-segment sums (value at the last index of a segment is that
    segment's total).
    """
    # All scan-pytree leaves must share the scan axis: lift flags to [1, ..].
    out, _ = _seg_scan_pair(curve, pts, first_flags[None])
    return out


# Chunked-scan shape policy (module constants so tests can shrink them):
# fall back to associative_scan below _CHUNK_MIN_TOTAL flat elements, keep
# per-step batches >= _CHUNK_MIN_BATCH, sequential depth <= _CHUNK_MAX_DEPTH.
_CHUNK_MIN_TOTAL = 4096
_CHUNK_MIN_BATCH = 1024
_CHUNK_MAX_DEPTH = 64


def _seg_combine(curve: CurveSpec):
    def combine(a, b):
        pa, fa = a
        pb, fb = b
        merged = cops.add(curve, pa, pb)
        out = cops.select(fb[0].astype(bool), pb, merged)
        return out, fa | fb
    return combine


def _chunk_width(N: int, total: int) -> int:
    """Largest power-of-two chunk width W per the shape policy; 1 means
    chunking is not applicable (odd N, tiny batch) and callers must fall
    back to the associative form (recursing at W == 1 would not shrink)."""
    W = 1
    while (W < _CHUNK_MAX_DEPTH and N % (W * 2) == 0
           and total // (W * 2) >= _CHUNK_MIN_BATCH):
        W *= 2
    return W


def _chunked_scan_parts(curve: CurveSpec, pts: cops.Point, flags: jnp.ndarray):
    """Shared core of the chunked segmented scan.  The axis is split into C
    contiguous chunks of W:

      1. a lax.scan over the W within-chunk positions (body traced ONCE,
         one fixed kernel shape [.., C]) yields per-chunk inclusive scans
         and chunk totals,
      2. the C chunk totals are scanned recursively (base case: the
         associative form at sizes small enough for the compact XLA path),
      3. the caller folds each chunk's exclusive prefix into its elements
         (valid because the segmented-scan operator is associative, with
         flags deciding whether the prefix crosses a segment boundary) --
         either full-width (`_seg_scan_pair`) or only at queried positions
         (`_seg_scan_gather`).

    Returns (incl_pts, incl_flags, excl_pts, excl_flags, W) with incl_* the
    within-chunk inclusive values in ORIGINAL element order [.., N] and
    excl_* the exclusive chunk prefixes [.., C]; or None when chunking is
    not applicable and the caller must use jax.lax.associative_scan.
    Work is ~2N combines in ~3 kernel shapes regardless of N, with
    sequential depth W <= _CHUNK_MAX_DEPTH."""
    combine = _seg_combine(curve)
    N = pts[0].shape[-1]
    lead = pts[0].shape[1:-1]
    total = N
    for d in lead:
        total *= d
    if total < _CHUNK_MIN_TOTAL or N < 4:
        return None
    W = _chunk_width(N, total)
    if W == 1:
        return None
    C = N // W

    def to_scan(x):  # [.., N] -> [W, .., C]
        x = x.reshape(*x.shape[:-1], C, W)
        return jnp.moveaxis(x, -1, 0)

    def to_flat(x):  # [W, .., C] -> [.., N] in original element order
        x = jnp.moveaxis(x, 0, -1)          # [.., C, W]; element n = i*W + j
        return x.reshape(*x.shape[:-2], N)

    xs = (tuple(to_scan(t) for t in pts), to_scan(flags))
    ident = cops.identity(curve, (*lead, C))
    init = (ident, jnp.zeros((1, *lead, C), flags.dtype))

    def step(state, x):
        new = combine(state, x)
        return new, new

    (tail_pts, tail_flags), (ys_pts, ys_flags) = jax.lax.scan(step, init, xs)

    # chunk-level inclusive scan of the totals, then shift to exclusive
    rec_pts, rec_flags = _seg_scan_pair(curve, tail_pts, tail_flags)
    ident1 = cops.identity(curve, (*lead, 1))
    excl_pts = tuple(jnp.concatenate([i1, t[..., :-1]], axis=-1)
                     for i1, t in zip(ident1, rec_pts))
    excl_flags = jnp.concatenate(
        [jnp.zeros((1, *lead, 1), flags.dtype), rec_flags[..., :-1]], axis=-1)

    incl_pts = tuple(to_flat(t) for t in ys_pts)
    incl_flags = to_flat(ys_flags)
    return incl_pts, incl_flags, excl_pts, excl_flags, W


def _seg_scan_pair(curve: CurveSpec, pts: cops.Point, flags: jnp.ndarray):
    """Inclusive segmented scan of (point, first-flag) pairs, chunked.

    `jax.lax.associative_scan` is work-efficient but instantiates the
    point-add combiner at ~2*log2(N) DISTINCT shrinking shapes, each a
    separate copy of the point-add graph to compile.  The chunked form
    (`_chunked_scan_parts`) keeps the number of distinct shapes constant."""
    combine = _seg_combine(curve)
    parts = _chunked_scan_parts(curve, pts, flags)
    if parts is None:
        out, fl = jax.lax.associative_scan(
            combine, (pts, flags), axis=pts[0].ndim - 1)
        return out, fl
    incl_pts, incl_flags, excl_pts, excl_flags, W = parts
    N = pts[0].shape[-1]
    C = N // W

    def to_cw(x):  # [.., N] -> [.., C, W]
        return x.reshape(*x.shape[:-1], C, W)

    out_pts, out_flags = combine(
        (tuple(t[..., None] for t in excl_pts), excl_flags[..., None]),
        (tuple(to_cw(t) for t in incl_pts), to_cw(incl_flags)))
    out_pts = tuple(t.reshape(*t.shape[:-2], N) for t in out_pts)
    out_flags = out_flags.reshape(*out_flags.shape[:-2], N)
    return out_pts, out_flags


def _seg_scan_gather(curve: CurveSpec, pts: cops.Point, flags: jnp.ndarray,
                     pos: jnp.ndarray) -> cops.Point:
    """Segmented inclusive-scan values at K query positions only.

    pts leaves are [D, .., N], flags [1, .., N], pos [.., K] (int, already
    clipped to [0, N-1]).  Equivalent to gathering from the full
    `_segmented_add_scan` output, but the chunk-prefix fold is paid only at
    the K queried positions instead of all N: the level-1 chunked scan
    yields within-chunk inclusive values, the recursive chunk-total scan
    yields exclusive chunk prefixes, and ONE [.., K]-batch combine joins
    the two at the queries.  For Pippenger (K = n_buckets << N per window)
    this halves the MSM's point-add count back to the classic
    one-add-per-point-per-window cost (reference work shape:
    src/curve/curve_msm.rs:102-157; here dense and static-shaped)."""
    combine = _seg_combine(curve)

    def gather(t, idx):
        return jnp.take_along_axis(
            t, jnp.broadcast_to(idx[None], (t.shape[0], *idx.shape)), axis=-1)

    parts = _chunked_scan_parts(curve, pts, flags)
    if parts is None:
        out, fl = jax.lax.associative_scan(
            combine, (pts, flags), axis=pts[0].ndim - 1)
        return tuple(gather(t, pos) for t in out)
    incl_pts, incl_flags, excl_pts, excl_flags, W = parts

    chunk_idx = pos // W
    g_incl = tuple(gather(t, pos) for t in incl_pts)
    g_incl_flags = gather(incl_flags, pos)
    g_excl = tuple(gather(t, chunk_idx) for t in excl_pts)
    g_excl_flags = gather(excl_flags, chunk_idx)
    out_pts, _ = combine((g_excl, g_excl_flags), (g_incl, g_incl_flags))
    return out_pts


def _tree_reduce(curve: CurveSpec, pts: cops.Point) -> cops.Point:
    """Sum a batch of points [.., N] down to a single point via halving."""
    X, Y, Z = pts
    n = X.shape[-1]
    while n > 1:
        half = n // 2
        even = (X[..., :2 * half:2], Y[..., :2 * half:2], Z[..., :2 * half:2])
        odd = (X[..., 1:2 * half:2], Y[..., 1:2 * half:2], Z[..., 1:2 * half:2])
        summed = cops.add(curve, even, odd)
        if n % 2:
            tail = (X[..., -1:], Y[..., -1:], Z[..., -1:])
            summed = tuple(jnp.concatenate([s, t], axis=-1)
                           for s, t in zip(summed, tail))
            n = half + 1
        else:
            n = half
        X, Y, Z = summed
    return (X[..., 0], Y[..., 0], Z[..., 0])


def _window_rows(curve: CurveSpec, scalars: jnp.ndarray, c: int, G: int,
                 signed: bool):
    """Canonical scalars [Ds, *B, N] -> (digits, signs), each
    [n_groups, G, N]: every (scalar, window) row, scalar-major (LSW first
    within a scalar), padded with zero windows to a multiple of G."""
    if signed:
        digits, signs = scalar_window_digits_signed(curve.scalar, scalars, c)
    else:
        digits = scalar_window_digits(curve.scalar, scalars, c)  # [W, *B, N]
        signs = jnp.ones_like(digits)
    n_windows, N = digits.shape[0], digits.shape[-1]
    K = _batch_size(digits.shape[1:-1])

    def rows(t):
        return jnp.moveaxis(t.reshape(n_windows, K, N), 0, 1) \
            .reshape(K * n_windows, N)

    digits, signs = rows(digits), rows(signs)
    pad = (-K * n_windows) % G
    if pad:
        # pad with zero windows (bucket 0 is discarded; rows sliced off)
        digits = jnp.concatenate(
            [digits, jnp.zeros((pad, N), digits.dtype)], axis=0)
        signs = jnp.concatenate(
            [signs, jnp.ones((pad, N), signs.dtype)], axis=0)
    return digits.reshape(-1, G, N), signs.reshape(-1, G, N)


def _batch_size(lead) -> int:
    K = 1
    for d in lead:
        K *= d
    return K


def _n_windows(curve: CurveSpec, c: int, signed: bool) -> int:
    return -(-curve.scalar.bits // c) + (1 if signed else 0)


def _canonical_points(curve: CurveSpec, points: cops.Point) -> cops.Point:
    """Coordinates as canonical uint8 digits, the form the bucket gather
    reads.  Canonical digits fit one byte, so the per-group [D, G, N]
    gather moves 4x fewer bytes (it is the MSM's dominant pure-memory stage
    at N >= 2^18), and canonical inputs are required for the uint8 cast
    anyway (callers like the Halo fold pass loose-digit points).  uint8
    inputs are taken as ALREADY canonical -- the fixed-base path
    (`precompute_base`): a basis reused across calls (the prover's Pedersen
    generators; reference src/curve/curve_msm.rs:16-52 amortizes
    precomputation the same way) skips three canonicalize passes per
    commitment."""
    assert fspec.DIGIT_BITS <= 8, (
        "uint8 coordinate gather assumes canonical digits fit one byte; "
        f"DIGIT_BITS={fspec.DIGIT_BITS} needs a wider gather dtype")
    if points[0].dtype == jnp.uint8:
        return points
    return tuple(fops.jitted('canonicalize', curve.base)(t).astype(jnp.uint8)
                 for t in points)


def _group_sum(curve: CurveSpec, points: cops.Point, dig: jnp.ndarray,
               sgn: jnp.ndarray, c: int, signed: bool) -> cops.Point:
    """Per-window sums of G windows: dig, sgn [G, N] -> a [D, G] point."""
    G, N = dig.shape
    n_buckets = (1 << (c - 1)) + 1 if signed else 1 << c
    bucket_ids = jnp.arange(n_buckets)
    order = jnp.argsort(dig, axis=-1)
    d_sorted = jnp.take_along_axis(dig, order, axis=-1)
    pts = tuple(jnp.take_along_axis(
        jnp.broadcast_to(t[:, None, :], (t.shape[0], G, N)),
        order[None], axis=-1).astype(jnp.int32) for t in points)
    if signed:
        s_sorted = jnp.take_along_axis(sgn, order, axis=-1)
        # a negative digit contributes -P: negate Y on the gathered copy
        pts = cops.select(s_sorted >= 0, pts, cops.neg(curve, pts))
    first = jnp.concatenate([
        jnp.ones((G, 1), jnp.int32),
        (d_sorted[:, 1:] != d_sorted[:, :-1]).astype(jnp.int32)], axis=-1)
    # last position of each bucket's run, per window row
    pos = jax.vmap(lambda row: jnp.searchsorted(
        row, bucket_ids, side='right'))(d_sorted) - 1      # [G, B]
    lo = jax.vmap(lambda row: jnp.searchsorted(
        row, bucket_ids, side='left'))(d_sorted)           # [G, B]
    present = lo <= pos
    ident = cops.identity(curve, (G, n_buckets))
    gathered = _seg_scan_gather(curve, pts, first[None],
                                jnp.clip(pos, 0, N - 1))
    buckets = cops.select(present, gathered, ident)
    # zero out bucket 0 (digit 0 contributes nothing)
    buckets = cops.select(bucket_ids[None, :] > 0, buckets, ident)
    # sum_j j * B_j via T_k = sum_{j>=k} B_j (reversed cumsum), then
    # sum_j j*B_j = sum_{k>=0} T_k - T_0.  Both passes go through the
    # CHUNKED scan (zero first-flags = one segment): the associative-
    # scan + halving-tree form instantiated the point-add at
    # ~2*log2(n_buckets) distinct shrinking shapes -- a separate
    # compile each, which is what made windows > 8 (4096+ buckets)
    # compile-prohibitive.  A constant shape count unlocks them.
    zflags = jnp.zeros((1, G, n_buckets), jnp.int32)
    rev = tuple(jnp.flip(t, axis=-1) for t in buckets)
    Trev, _ = _seg_scan_pair(curve, rev, zflags)
    T = tuple(jnp.flip(t, axis=-1) for t in Trev)
    tot = _seg_scan_gather(curve, T, zflags,
                           jnp.full((G, 1), n_buckets - 1))
    t0 = tuple(t[..., 0] for t in T)
    return cops.add(curve, tuple(t[..., 0] for t in tot),
                    cops.neg(curve, t0))   # [D, G]


def _horner(curve: CurveSpec, ws: cops.Point, c: int, n_windows: int,
            lead) -> cops.Point:
    """Combine per-window sums ws (leaves [D, n_groups*G], scalar-major
    rows) across windows, batched over the K MSMs (MSW first)."""
    K = _batch_size(lead)
    ws = tuple(t[:, :K * n_windows].reshape(t.shape[0], K, n_windows)
               for t in ws)
    acc = tuple(t[..., n_windows - 1] for t in ws)   # [D, K]

    def horner_step(j, acc):
        # 2^c * acc via a rolled loop: each doubling is ONE instance of the
        # point-double graph in the compiled program (an unrolled chain of
        # c*G=32+ doublings made compile times explode).
        acc = jax.lax.fori_loop(
            0, c, lambda _i, q: cops.double(curve, q), acc)
        w = n_windows - 2 - j
        win = tuple(jax.lax.dynamic_index_in_dim(
            t, w, axis=t.ndim - 1, keepdims=False) for t in ws)
        return cops.add(curve, acc, win)

    acc = jax.lax.fori_loop(0, n_windows - 1, horner_step, acc)
    if lead:
        return tuple(t.reshape(t.shape[0], *lead) for t in acc)
    return tuple(t[..., 0] for t in acc)


def msm(curve: CurveSpec, points: cops.Point, scalars: jnp.ndarray,
        window_bits: int = 8, window_group: int = 8,
        signed: bool = False) -> cops.Point:
    """MSM over projective points [D, N] x canonical scalars [Ds, *B, N].

    Returns a [.., *B] point: with a leading scalar batch this is a
    MULTI-MSM over shared points (the prover's polynomial commitments: one
    Pedersen basis, 6-9 scalar vectors).  Windows are processed
    `window_group` at a time: one batched argsort, one segmented scan and
    one bucket reduction over a [G, N] batch -- larger kernels amortize
    launch overhead and fill the device.  A batched multi-MSM feeds the
    SAME group pipeline (batch scalars only multiply the group count) and
    batches the final Horner double-and-add across the B MSMs, so the
    ~bits-of-p sequential batch-1 doublings (latency-bound) are paid once
    per CALL, not once per polynomial.

    Traceable as one program (lax.scan over the groups); `msm_jit` runs the
    same stages as separately compiled programs."""
    c = window_bits
    lead = scalars.shape[1:-1]
    G = min(window_group, _batch_size(lead) * _n_windows(curve, c, signed))
    points = _canonical_points(curve, points)
    digits, signs = _window_rows(curve, scalars, c, G, signed)
    _, ws = jax.lax.scan(
        lambda _c, gs: (None, _group_sum(curve, points, *gs, c, signed)),
        None, (digits, signs))
    # ws leaves: [n_grp, D, G] -> [D, n_grp*G]
    ws = tuple(jnp.moveaxis(t, 0, 1).reshape(t.shape[1], -1) for t in ws)
    return _horner(curve, ws, c, _n_windows(curve, c, signed), lead)


def precompute_base(curve: CurveSpec, points: cops.Point) -> cops.Point:
    """Canonicalize a fixed MSM basis ONCE into the uint8 device form `msm`
    gathers from.  Amortizes the per-call canonicalization over every
    commitment against the same basis (the reference precomputes windowed
    generator powers at circuit build for the same reason,
    src/curve/curve_msm.rs:16-52 via circuit_builder.rs:1131-1133)."""
    return tuple(jax.block_until_ready(
        fops.jitted('canonicalize', curve.base)(t).astype(jnp.uint8))
        for t in points)


@functools.lru_cache(maxsize=None)
def msm_jit(curve: CurveSpec, window_bits: int, window_group: int = 8,
            signed: bool = False):
    """`msm` as host-driven compiled stages: the large group program is
    compiled once per (basis size, G) and called once per group of windows,
    so a multi-MSM of any batch K reuses it; only the small digit and Horner
    programs are compiled per K.  (One program for the whole MSM would be
    compiled again for every K the prover uses -- 6, 9, 1, 7, 2.)"""
    c = window_bits
    W = _n_windows(curve, c, signed)
    group = jax.jit(functools.partial(_group_sum, curve, c=c, signed=signed))

    @functools.lru_cache(maxsize=None)
    def stages(lead):
        G = min(window_group, _batch_size(lead) * W)
        rows = jax.jit(functools.partial(_window_rows, curve, c=c, G=G,
                                         signed=signed))

        def combine(ws):
            ws = tuple(jnp.concatenate(t, axis=-1) for t in zip(*ws))
            return _horner(curve, ws, c, W, lead)

        return rows, jax.jit(combine)

    def run(points, scalars):
        rows, combine = stages(scalars.shape[1:-1])
        points = _canonical_points(curve, points)
        digits, signs = rows(scalars)
        return combine([group(points, digits[g], signs[g])
                        for g in range(digits.shape[0])])

    return run


def msm_chunked(curve: CurveSpec, points: cops.Point, scalars: jnp.ndarray,
                window_bits: int = 8, window_group: int = 8,
                chunk_log: int = 18, signed: bool = False) -> cops.Point:
    """MSM with host-side point chunking for very large N.

    MSM is linear over its points, so an N-point MSM is the sum of
    independent MSMs over point chunks.  Above 2^chunk_log this loops the
    jitted 2^chunk_log program over slices instead of compiling (and
    holding live in device memory) one giant graph: the per-group bucket
    gather materializes [D, G, N] tensors, which at N=2^22, G=8 would be
    ~1 GB per coordinate before scan intermediates pile on.  The
    per-chunk Horner tail is the only duplicated work."""
    N = points[0].shape[-1]
    C = 1 << chunk_log
    fn = msm_jit(curve, window_bits, window_group, signed)
    if N <= C:
        return fn(points, scalars)
    if N % C:
        raise ValueError(f"N={N} not a multiple of chunk {C}")
    add_fn = jax.jit(functools.partial(cops.add, curve))
    acc = None
    for i in range(0, N, C):
        part = fn(tuple(t[..., i:i + C] for t in points),
                  scalars[..., i:i + C])
        acc = part if acc is None else add_fn(acc, part)
    return acc
