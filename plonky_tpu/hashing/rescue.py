"""Rescue permutation and sponge (host + device).

Behavioral parity with the reference (src/rescue.rs): width-4 sponge with
rate 3, rounds = max(ceil(security_bits / (2*width)), 10), round constants
sampled from ChaCha8Rng seeded with 1337 exactly as `generate_rescue_constants`
does (reference: src/rescue.rs:97-121).

Two implementations:
* host (python ints)  -- used by the sequential Fiat-Shamir challenger.
* device (digit vectors, batched over trailing axes) -- used for bulk hashing
  benchmarks and for in-circuit Rescue witness generation.  The inverse S-box
  x^(1/alpha) is a fixed-exponent chain; MDS is a small constant matrix
  combination (width 4), unrolled into madds.
"""

from __future__ import annotations

import functools

from ..fields import host, ops
from ..fields.spec import FieldSpec
from .chacha import ChaCha8Rng

RESCUE_SPONGE_WIDTH = 4
RESCUE_SPONGE_RATE = 3


def recommended_rounds(width: int, security_bits: int) -> int:
    """reference: src/rescue.rs:123-125."""
    return max(-(-security_bits // (2 * width)), 10)


@functools.lru_cache(maxsize=None)
def mds_matrix(spec: FieldSpec, n: int):
    """Cauchy MDS matrix: entry (r, c) = 1/(x_r - y_c), x_r = n+r, y_c = c.
    (reference: src/mds.rs:63-77)"""
    p = spec.p
    return tuple(
        tuple(pow((n + r - c) % p, -1, p) for c in range(n))
        for r in range(n)
    )


@functools.lru_cache(maxsize=None)
def rescue_constants(spec: FieldSpec, width: int, security_bits: int):
    """Round constants, identical to the reference's ChaCha8(1337) stream
    (reference: src/rescue.rs:97-121)."""
    rng = ChaCha8Rng.seed_from_u64(1337)
    rounds = recommended_rounds(width, security_bits)
    out = []
    for _ in range(rounds):
        step_a = tuple(host.rand_from_rng(spec, rng) for _ in range(width))
        step_b = tuple(host.rand_from_rng(spec, rng) for _ in range(width))
        out.append((step_a, step_b))
    return tuple(out)


# ---------------------------------------------------------------------------
# Host implementation (python ints)
# ---------------------------------------------------------------------------

def _apply_mds_host(spec: FieldSpec, state):
    p = spec.p
    n = len(state)
    mds = mds_matrix(spec, n)
    return [sum(mds[r][c] * state[c] for c in range(n)) % p for r in range(n)]


def rescue_permutation_host(spec: FieldSpec, state, security_bits: int):
    """reference: src/rescue.rs:70-88."""
    p = spec.p
    state = list(state)
    inv_alpha = host.kth_root_exponent(spec, spec.alpha)
    for step_a_c, step_b_c in rescue_constants(spec, len(state), security_bits):
        state = [pow(x, inv_alpha, p) for x in state]
        state = _apply_mds_host(spec, state)
        state = [(x + c) % p for x, c in zip(state, step_a_c)]
        state = [pow(x, spec.alpha, p) for x in state]
        state = _apply_mds_host(spec, state)
        state = [(x + c) % p for x, c in zip(state, step_b_c)]
    return state


def rescue_sponge_host(spec: FieldSpec, inputs, num_outputs: int,
                       security_bits: int):
    """reference: src/rescue.rs:40-68."""
    rate, width = RESCUE_SPONGE_RATE, RESCUE_SPONGE_WIDTH
    state = [0] * width
    for i in range(0, len(inputs), rate):
        chunk = inputs[i:i + rate]
        for j, x in enumerate(chunk):
            state[j] = (state[j] + x) % spec.p
        state = rescue_permutation_host(spec, state, security_bits)
    outputs = []
    while True:
        for j in range(rate):
            outputs.append(state[j])
            if len(outputs) == num_outputs:
                return outputs
        state = rescue_permutation_host(spec, state, security_bits)


def rescue_hash_n_to_1_host(spec: FieldSpec, inputs, security_bits: int) -> int:
    return rescue_sponge_host(spec, inputs, 1, security_bits)[0]


# ---------------------------------------------------------------------------
# Device implementation (batched digit vectors)
# ---------------------------------------------------------------------------

def apply_mds(spec: FieldSpec, state):
    """state: list of width arrays [D, *batch] -> MDS-mixed list.

    One broadcast field multiply over a [W, W]-shaped batch plus one
    digitwise sum (field addition is linear in the digit representation),
    instead of W^2 separate mul/add kernels."""
    S = _stack_state(spec, state)
    out = _apply_mds_stacked(spec, S, _mds_digits(spec, len(state)))
    return [out[:, r] for r in range(len(state))]


def _stack_state(spec: FieldSpec, state):
    """list of width arrays [D, *batch] -> one [D, W, *batch] array."""
    import jax.numpy as jnp
    batch = jnp.broadcast_shapes(*[x.shape[1:] for x in state])
    return jnp.stack(
        [jnp.broadcast_to(x, (spec.n_digits, *batch)) for x in state], axis=1)


@functools.lru_cache(maxsize=None)
def _mds_digits(spec: FieldSpec, width: int):
    """MDS matrix as a [D, W(row), W(col)] canonical digit array."""
    import numpy as np
    mds = mds_matrix(spec, width)
    m = np.stack([np.stack([spec.to_digits(mds[r][c]) for c in range(width)],
                           axis=-1) for r in range(width)], axis=1)
    return m  # [D, W, W]


def _apply_mds_stacked(spec: FieldSpec, S, m_np):
    """S: [D, W, *batch] -> MDS(S), via out_r = sum_c M[r,c] * S_c."""
    import jax.numpy as jnp
    from ..fields.spec import DIGIT_MASK
    batch = S.shape[2:]
    M = jnp.asarray(m_np.reshape(*m_np.shape, *([1] * len(batch))))
    prod = ops.mul_loose(spec, M, S[:, None], da=DIGIT_MASK)  # [D, W, W, *b]
    return ops.sum_reduce(spec, prod, axis=1)                 # [D, W, *b]


@functools.lru_cache(maxsize=None)
def _round_constant_digits(spec: FieldSpec, width: int, security_bits: int):
    """Stacked ChaCha8(1337) round constants as [rounds, D, W] digit arrays."""
    import numpy as np
    consts = rescue_constants(spec, width, security_bits)
    a = np.stack([np.stack([spec.to_digits(c) for c in sa], axis=-1)
                  for sa, _ in consts], axis=0)
    b = np.stack([np.stack([spec.to_digits(c) for c in sb], axis=-1)
                  for _, sb in consts], axis=0)
    return a, b  # each [rounds, D, W]


def rescue_permutation(spec: FieldSpec, state, security_bits: int):
    """Batched Rescue permutation on device; state: width arrays [D,*batch].

    Batched form: ONE ``lax.scan`` over rounds with the width axis
    batched, so the compiled graph holds a single round body (two S-box
    exponent scans + two broadcast MDS products) however many rounds run.
    A direct transcription of the reference's round loop
    (src/rescue.rs:70-88) unrolled 2*rounds*width exponent chains into the
    graph -- a multi-minute compile for one permutation.
    """
    import jax
    import jax.numpy as jnp

    width = len(state)
    inv_alpha = host.kth_root_exponent(spec, spec.alpha)
    S = _stack_state(spec, state)                      # [D, W, *batch]
    batch = S.shape[2:]
    ones = (1,) * len(batch)
    a_np, b_np = _round_constant_digits(spec, width, security_bits)
    m_np = _mds_digits(spec, width)
    A = jnp.asarray(a_np.reshape(*a_np.shape, *ones))  # [R, D, W, 1...]
    B = jnp.asarray(b_np.reshape(*b_np.shape, *ones))

    def round_body(S, consts):
        c_a, c_b = consts
        S = ops.exp_const(spec, S, inv_alpha)
        S = ops.add(spec, _apply_mds_stacked(spec, S, m_np), c_a)
        S = ops.exp_const(spec, S, spec.alpha)
        S = ops.add(spec, _apply_mds_stacked(spec, S, m_np), c_b)
        return S, None

    S, _ = jax.lax.scan(round_body, S, (A, B))
    return [S[:, i] for i in range(width)]
