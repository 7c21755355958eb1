"""MSM scaling harness (reference: src/bin/msms.rs).

The reference sweeps rayon thread-pool sizes for a fixed 2^14-term MSM; the
analogue here sweeps the DEVICE MESH size for the point-sharded Pippenger
MSM (SURVEY.md P2/P7) and reports points/s plus weak-scaling efficiency.
With --virtual N it runs over N virtual CPU devices
(xla_force_host_platform_device_count), which validates the sharded path
but measures nothing; on a machine with several cards it measures their
scaling.

Usage: python bin/msms_bench.py [--log-n 14] [--window 8] [--devices 1 2 4 8]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--log-n", type=int, default=14)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--devices", type=int, nargs="*", default=None)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--virtual", type=int, default=0, metavar="N",
                    help="run on N virtual CPU devices (mirrors "
                    "tests/conftest.py)")
    args = ap.parse_args()

    if args.virtual:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={args.virtual}"
            ).strip()

    import jax
    import numpy as np

    if args.virtual:
        jax.config.update("jax_platforms", "cpu")

    import plonky_tpu
    plonky_tpu.enable_compilation_cache()

    from plonky_tpu.curves import TWEEDLEDEE as curve
    from plonky_tpu.curves import msm as cmsm, ops as cops
    from plonky_tpu.fields import ops as fops
    from plonky_tpu.parallel import default_mesh, msm_sharded

    n = 1 << args.log_n
    n_dev_avail = len(jax.devices())
    sweep = args.devices or sorted({d for d in (1, 2, 4, 8, n_dev_avail)
                                    if d <= n_dev_avail})

    rng = np.random.default_rng(0)
    print(f"devices available: {n_dev_avail}; MSM size 2^{args.log_n}, "
          f"window {args.window}", flush=True)

    # Valid curve points via a tiled doubling chain (cheap to build at any
    # n) and random canonical scalars.
    from plonky_tpu.curves import host as chost
    chain = min(n, 1 << 10)
    g = chost.generator(curve)
    cur = chost.mul(g, int(rng.integers(1, 1 << 62)))
    pts = []
    for _ in range(chain):
        pts.append(cur)
        cur = chost.add(cur, cur)
    xs_np = np.stack([curve.base.to_digits(p.x) for p in pts], axis=-1)
    ys_np = np.stack([curve.base.to_digits(p.y) for p in pts], axis=-1)
    reps_t = n // chain
    xs = jax.numpy.asarray(np.tile(xs_np, (1, reps_t)))
    ys = jax.numpy.asarray(np.tile(ys_np, (1, reps_t)))
    P = cops.from_affine(curve, xs, ys, jax.numpy.asarray(np.zeros(n, bool)))
    scalars = fops.from_ints(curve.scalar, [
        int.from_bytes(rng.bytes(40), "little") % curve.scalar.p
        for _ in range(n)])

    results = {}
    base_rate = None
    for nd in sweep:
        if nd == 1:
            fn = cmsm.msm_jit(curve, args.window)
            run = lambda: fn(P, scalars)
        else:
            mesh = default_mesh(nd)
            run = lambda m=mesh: msm_sharded(m, curve, P, scalars,
                                             window_bits=args.window)
        out = run()
        jax.tree_util.tree_map(lambda t: t.block_until_ready(), out)
        t0 = time.time()
        for _ in range(args.reps):
            out = run()
        jax.tree_util.tree_map(lambda t: t.block_until_ready(), out)
        dt = (time.time() - t0) / args.reps
        rate = n / dt
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * nd / sweep[0])
        results[nd] = out
        print(f"  mesh={nd:3d}: {dt*1e3:9.2f} ms  {rate:.3e} points/s  "
              f"weak-scaling efficiency {eff*100:5.1f}%", flush=True)

    # cross-check: every mesh size produced the same group element
    affs = {nd: jax.jit(lambda q: cops.to_affine(curve, q))(out)
            for nd, out in results.items()}
    base = None
    for nd, (x, y, z) in sorted(affs.items()):
        got = (fops.to_ints(curve.base, x), fops.to_ints(curve.base, y),
               bool(np.asarray(z)))
        if base is None:
            base = got
        assert got == base, f"mesh={nd} result differs from mesh={sweep[0]}"
    print("all mesh sizes agree on the MSM result", flush=True)


if __name__ == "__main__":
    main()
