"""Per-process worker for the 2-process jax.distributed test.

Launched by tests/test_distributed.py with JAX_PROCESS_ID/JAX_NUM_PROCESSES/
JAX_COORDINATOR_ADDRESS set.  Each process owns 4 virtual CPU devices; the
global mesh spans 8 devices across the 2 processes (the process axis of
parallel/distributed.py's hybrid_mesh).  Exercises a cross-process psum and
the point-sharded MSM (parallel/msm.py) against a host oracle.
"""
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from plonky_tpu.parallel import distributed  # noqa: E402

distributed.initialize()
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())

# --- cross-process psum over the hybrid mesh ------------------------------
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402
from jax.experimental.shard_map import shard_map  # noqa: E402

mesh = distributed.hybrid_mesh()
assert mesh.devices.shape == (2, 4), mesh.devices.shape


def local_sum(x):
    s = jnp.sum(x, keepdims=True)
    return jax.lax.psum(jax.lax.psum(s, "local"), "proc")


xs = np.arange(16, dtype=np.int32)
x = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P(("proc", "local"))), xs[jax.process_index() * 8:
                                               (jax.process_index() + 1) * 8])
fn = jax.jit(shard_map(local_sum, mesh=mesh, in_specs=P(("proc", "local")),
                       out_specs=P(("proc", "local"))))
out = fn(x)
total = int(np.asarray(jax.device_get(out.addressable_shards[0].data))[0])
assert total == int(np.arange(16).sum()), total

# --- point-sharded MSM across both processes ------------------------------
from plonky_tpu.curves import TWEEDLEDEE as curve, host as chost  # noqa: E402
from plonky_tpu.curves import ops as cops  # noqa: E402
from plonky_tpu.fields import ops as fops  # noqa: E402
from plonky_tpu.parallel.msm import msm_sharded  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

N = 16
rng = np.random.default_rng(7)
g = chost.generator(curve)
pts = [chost.mul(g, int(k)) for k in rng.integers(1, 1 << 30, N)]
scal = [int(s) for s in rng.integers(1, 1 << 30, N)]
expected = None
for p_, s_ in zip(pts, scal):
    term = chost.mul(p_, s_)
    expected = term if expected is None else chost.add(expected, term)

flat_mesh = Mesh(np.array(jax.devices()), ("dp",))
xs_d = fops.from_ints(curve.base, [p_.x for p_ in pts])
ys_d = fops.from_ints(curve.base, [p_.y for p_ in pts])
P_loc = cops.from_affine(curve, xs_d, ys_d, jnp.zeros(N, bool))
S_loc = fops.from_ints(curve.scalar, scal)
# Build GLOBAL arrays from each process's slice of the (replicated) host
# data -- device_put cannot target non-addressable devices.
sh = NamedSharding(flat_mesh, P(None, "dp"))
lo, hi = (N // 2) * jax.process_index(), (N // 2) * (jax.process_index() + 1)
P_glob = tuple(jax.make_array_from_process_local_data(
    sh, np.asarray(t)[:, lo:hi]) for t in P_loc)
S_glob = jax.make_array_from_process_local_data(
    sh, np.asarray(S_loc)[:, lo:hi])
out_pt = msm_sharded(flat_mesh, curve, P_glob, S_glob, window_bits=4)
x_aff, y_aff, zero = jax.jit(lambda q: cops.to_affine(curve, q))(out_pt)
got = chost.AffinePoint(curve,
                        fops.to_ints(curve.base, x_aff),
                        fops.to_ints(curve.base, y_aff))
assert not bool(np.asarray(zero)), "MSM returned identity"
assert got == expected, (got, expected)

print(f"proc {jax.process_index()}: distributed psum + sharded MSM OK",
      flush=True)
