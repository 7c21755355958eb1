"""Mesh-sharded FFT (SURVEY.md P1: the reference parallelizes butterfly
layers with rayon par_chunks; the equivalents here are (a) sharding the
polynomial-batch axis across cards, and (b) the transpose-based four-step
algorithm for a single huge domain, with the transpose as one all_to_all
inside shard_map)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..fields import host as fhost
from ..fields import ops as fops
from ..fields.spec import FieldSpec
from ..poly.fft import FftPrecomputation, fft
from ..utils import log2_strict


def fft_sharded_batch(mesh: Mesh, pre: FftPrecomputation,
                      coeffs: jnp.ndarray, axis_name: str = "dp") -> jnp.ndarray:
    """Batch-parallel FFT: shard the polynomial-batch axis (axis 1 of
    [D, k, n]) across the mesh; each chip runs the full per-poly FFT."""
    sharding = NamedSharding(mesh, P(None, axis_name, None))
    coeffs = jax.device_put(coeffs, sharding)
    f = jax.jit(functools.partial(fft, pre),
                in_shardings=sharding, out_shardings=sharding)
    return f(coeffs)


def fft_sharded_domain(mesh: Mesh, spec: FieldSpec, coeffs: jnp.ndarray,
                       axis_name: str = "dp") -> jnp.ndarray:
    """Four-step FFT over a single domain of size n = n1 * n2, with the
    domain sharded across chips.

    Decimation: with coefficients c laid out as C[i1, i2] = c[i1 + n1*i2]
    (i1 sharded), the DFT factorizes as
        X[k2 + n2*k1] = sum_{i1} w_n1^{i1 k1} * w_n^{i1 k2}
                        * (sum_{i2} w_n2^{i2 k2} C[i1, i2])
    i.e. per-shard FFTs over i2, a twiddle multiply, an all_to_all
    transpose, then per-shard FFTs over i1.  Output is in the transposed
    (k2-major) order; we return it re-ordered to natural order.
    """
    n = coeffs.shape[-1]
    n_dev = mesh.devices.size
    n1 = n_dev
    n2 = n // n1
    assert n1 * n2 == n and n2 >= 1
    p = spec.p
    lg_n = log2_strict(n)
    w_n = fhost.primitive_root_of_unity(spec, lg_n)

    pre2 = FftPrecomputation(spec, n2)
    pre1 = FftPrecomputation(spec, n1)

    # twiddle table w_n^(i1*k2): [D, n1, n2]
    tw = np.zeros((spec.n_digits, n1, n2), dtype=np.int32)
    for i1 in range(n1):
        base = pow(w_n, i1, p)
        cur = 1
        for k2 in range(n2):
            tw[:, i1, k2] = spec.to_digits(cur)
            cur = cur * base % p
    tw = jnp.asarray(tw)

    # C[i1, i2] = c[i1 + n1*i2]: reshape [n2, n1] then transpose
    C = coeffs.reshape(*coeffs.shape[:-1], n2, n1)
    C = jnp.swapaxes(C, -1, -2)  # [.., n1, n2]

    def stage(block, twid):
        # block: [D, n1/n_dev(=1 per device under shard_map), n2]
        inner = fft(pre2, block)
        return fops.mul(spec, inner, twid)

    from jax.experimental.shard_map import shard_map
    spec_in = P(None, axis_name, None)

    def sharded_fn(C_, tw_):
        y = shard_map(stage, mesh=mesh, in_specs=(spec_in, spec_in),
                      out_specs=spec_in)(C_, tw_)
        # transpose [D, n1, n2] -> [D, n2, n1] via collective-backed reshard
        yt = jnp.swapaxes(y, -1, -2)  # XLA inserts all_to_all under sharding
        out = fft(pre1, yt)           # FFT along the (now last) n1 axis
        return out

    sharding = NamedSharding(mesh, spec_in)
    C = jax.device_put(C, sharding)
    out = jax.jit(sharded_fn)(C, tw)
    # out[k2, k1] = X[k2 + n2*k1]; transpose to [k1, k2] and flatten so that
    # flat index k1*n2 + k2 = k is natural order.
    out = jnp.swapaxes(out, -1, -2)
    return out.reshape(*coeffs.shape[:-1], n)


def fft_sharded_domain_check(mesh, spec, coeffs):
    """Reference check helper: natural-order output."""
    return fft_sharded_domain(mesh, spec, coeffs)
