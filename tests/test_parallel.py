"""Multi-chip sharding paths at non-trivial sizes on the 8-virtual-device
CPU mesh (conftest.py): sharded FFT (batch + domain) and sharded MSM must
equal their single-device results, including odd mesh sizes and
identity-heavy scalar sets.

Reference parity: the reference's only parallelism is rayon shared-memory
(src/fft.rs:128-150, src/curve/curve_msm.rs:102-157); these tests cover
the device-mesh replacement (SURVEY.md P1/P2/P8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from plonky_tpu.curves import TWEEDLEDEE as CURVE
from plonky_tpu.curves import host as chost
from plonky_tpu.curves import msm as cmsm
from plonky_tpu.curves import ops as cops
from plonky_tpu.fields import TWEEDLEDEE_BASE as F
from plonky_tpu.fields import ops as fops
from plonky_tpu.parallel.fft import fft_sharded_batch, fft_sharded_domain
from plonky_tpu.parallel.mesh import default_mesh
from plonky_tpu.parallel.msm import msm_sharded
from plonky_tpu.poly.fft import FftPrecomputation, fft


def _rand_coeffs(rng, k, n):
    vals = [[int.from_bytes(rng.bytes(40), "little") % F.p for _ in range(n)]
            for _ in range(k)]
    flat = [v for row in vals for v in row]
    return fops.from_ints(F, flat).reshape(F.n_digits, k, n)


def test_fft_sharded_batch_matches_single():
    rng = np.random.default_rng(0)
    n, k = 1 << 10, 8
    coeffs = _rand_coeffs(rng, k, n)
    pre = FftPrecomputation(F, n)
    want = jax.jit(lambda c: fft(pre, c))(coeffs)
    mesh = default_mesh(8)
    got = fft_sharded_batch(mesh, pre, coeffs)
    assert fops.to_ints(F, got).tolist() == fops.to_ints(F, want).tolist()


def test_fft_sharded_batch_odd_mesh():
    """Mesh of 3 devices over a 3-polynomial batch."""
    rng = np.random.default_rng(1)
    n, k = 1 << 10, 3
    coeffs = _rand_coeffs(rng, k, n)
    pre = FftPrecomputation(F, n)
    want = jax.jit(lambda c: fft(pre, c))(coeffs)
    mesh = default_mesh(3)
    got = fft_sharded_batch(mesh, pre, coeffs)
    assert fops.to_ints(F, got).tolist() == fops.to_ints(F, want).tolist()


def test_fft_sharded_domain_matches_single():
    """Four-step domain-sharded FFT at 2^12 over all 8 devices."""
    rng = np.random.default_rng(2)
    n = 1 << 12
    coeffs = _rand_coeffs(rng, 1, n)[:, 0]
    pre = FftPrecomputation(F, n)
    want = jax.jit(lambda c: fft(pre, c))(coeffs)
    mesh = default_mesh(8)
    got = fft_sharded_domain(mesh, F, coeffs)
    assert fops.to_ints(F, got).tolist() == fops.to_ints(F, want).tolist()


def _chain_points(n):
    """Doubling-chain points (device tensors + host affine list)."""
    rng = np.random.default_rng(3)
    g = chost.generator(CURVE)
    cur = chost.mul(g, int(rng.integers(1, 1 << 60)))
    pts = []
    for _ in range(n):
        pts.append(cur)
        cur = chost.add(cur, cur)
    xs = fops.from_ints(CURVE.base, [p.x for p in pts])
    ys = fops.from_ints(CURVE.base, [p.y for p in pts])
    P = cops.from_affine(CURVE, xs, ys, jnp.asarray(np.zeros(n, bool)))
    return P, pts


def _affine_ints(pt):
    x, y, zero = jax.jit(lambda q: cops.to_affine(CURVE, q))(pt)
    return (bool(np.asarray(zero)), fops.to_ints(CURVE.base, x),
            fops.to_ints(CURVE.base, y))


@pytest.mark.parametrize("n_dev,n,seed", [(8, 1 << 10, 4), (5, 5 * 256, 5)])
def test_msm_sharded_matches_single(n_dev, n, seed):
    """Point-sharded MSM vs the single-device pipeline, power-of-two and
    odd mesh splits, with an identity-heavy scalar set (zeros + repeats)."""
    rng = np.random.default_rng(seed)
    P, _ = _chain_points(n)
    scal = [int.from_bytes(rng.bytes(40), "little") % CURVE.scalar.p
            for _ in range(n)]
    # identity-heavy: zero out a quarter, duplicate another quarter
    for i in range(0, n, 4):
        scal[i] = 0
    for i in range(1, n, 4):
        scal[i] = scal[(i + 4) % n]
    S = fops.from_ints(CURVE.scalar, scal)
    want = jax.jit(lambda p, s: cmsm.msm(CURVE, p, s, window_bits=4))(P, S)
    mesh = default_mesh(n_dev)
    got = msm_sharded(mesh, CURVE, P, S, window_bits=4)
    assert _affine_ints(got) == _affine_ints(want)
