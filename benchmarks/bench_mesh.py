#!/usr/bin/env python
"""Multi-device scaling benchmark for the sharded counting step.

Measures the all_to_all radix-exchange counting pipeline
(parallel/mesh.py sharded_count_fn) at 1, 2, 4, ... devices with the
per-device work held constant (weak scaling), printing throughput and
scaling efficiency per mesh size.  On real multi-chip hardware this is
the BASELINE.md scaling-efficiency benchmark; on a single chip or the
virtual CPU mesh it exercises the collective path but shares one core,
so efficiency numbers are only meaningful on real meshes.

Usage: python benchmarks/bench_mesh.py [--per-dev 1048576] [--k 15]
(Set JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8
for a virtual mesh.)
"""

from __future__ import annotations

import argparse
import time


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--per-dev", type=int, default=1 << 20)
    parser.add_argument("--k", type=int, default=15)
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument(
        "--virtual",
        type=int,
        default=0,
        help="force an N-device virtual CPU mesh",
    )
    parser.add_argument(
        "--graph",
        action="store_true",
        help="also benchmark the sharded unitig graph front-end",
    )
    parser.add_argument(
        "--walk",
        action="store_true",
        help="also benchmark distributed pointer doubling + chain grouping",
    )
    args = parser.parse_args()

    import jax

    if args.virtual:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.virtual)
    import numpy as np

    from kmerset_tpu.ops.count import window_validity
    from kmerset_tpu.parallel.mesh import make_mesh, sharded_count_fn

    n_avail = len(jax.devices())
    print(f"devices: {n_avail} x {jax.devices()[0].platform}")
    k, per = args.k, args.per_dev
    rng = np.random.default_rng(0)

    base_rate = None
    n_dev = 1
    while n_dev <= n_avail:
        mesh = make_mesh(n_dev)
        total = per * n_dev
        codes = rng.integers(0, 4, total).astype(np.int32)
        offsets = np.array([0, total], dtype=np.int64)
        valid = window_validity(offsets, total, k)
        for d in range(1, n_dev):
            valid[d * per - k + 1 : d * per] = False
        fn = sharded_count_fn(mesh, k, True, capacity=2 * per)
        out = fn(codes, valid)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(args.reps):
            out = fn(codes, valid)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / args.reps
        rate = total / dt
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * n_dev)
        print(
            f"n_dev={n_dev}  {rate/1e6:8.1f} Mkmers/s  "
            f"({dt*1e3:.1f} ms/step)  weak-scaling eff={eff:.2f}"
        )

        # Graph phase at the same mesh size: sharded side tables +
        # successor assembly over the counted set's shard layout.
        if args.graph:
            from kmerset_tpu.parallel.mesh import (
                _S_SENT,
                _owner_edges,
                sharded_unitig_succ_fn,
            )

            uniq = np.asarray(out[0]).reshape(n_dev, -1)
            cap = uniq.shape[1]
            if k <= 15:
                blocks = np.where(
                    uniq >= (1 << 62), int(_S_SENT), uniq
                ).astype(np.int32)
            else:
                blocks = uniq
            gfn = sharded_unitig_succ_fn(mesh, k, qcap=16 * cap // n_dev)
            g = gfn(blocks.reshape(-1))
            jax.block_until_ready(g)
            t0 = time.perf_counter()
            for _ in range(args.reps):
                g = gfn(blocks.reshape(-1))
            jax.block_until_ready(g)
            dtg = (time.perf_counter() - t0) / args.reps
            print(
                f"          graph front-end: {total/dtg/1e6:8.1f} Mkmers/s  "
                f"({dtg*1e3:.1f} ms/step)"
            )
        # Walk phase at the same mesh size: distributed chain resolution
        # (pointer doubling) + owner-routed chain grouping on a synthetic
        # successor graph of ~64-node chains.
        if args.walk:
            from kmerset_tpu.parallel.mesh import (
                sharded_chain_group_fn,
                sharded_pointer_double_fn,
            )

            nn = per * n_dev
            perm = rng.permutation(nn).astype(np.int32)
            succ = np.full(nn, -1, np.int32)
            succ[perm[:-1]] = perm[1:]
            succ[perm[np.arange(63, nn - 1, 64)]] = -1
            rounds = max(1, int(np.ceil(np.log2(nn))) + 1)
            pfn = sharded_pointer_double_fn(mesh, rounds, False)
            labels = np.zeros(nn, np.int32)
            outp = pfn(succ, labels)
            jax.block_until_ready(outp)
            t0 = time.perf_counter()
            for _ in range(args.reps):
                outp = pfn(succ, labels)
            jax.block_until_ready(outp)
            dtp = (time.perf_counter() - t0) / args.reps
            end, dist, isc, _ = outp
            cfn = sharded_chain_group_fn(mesh)
            sel = np.asarray(isc)
            endh = np.asarray(end).astype(np.int32)
            disth = np.asarray(dist).astype(np.int32)
            outc = cfn(endh, disth, sel)
            jax.block_until_ready(outc)
            t0 = time.perf_counter()
            for _ in range(args.reps):
                outc = cfn(endh, disth, sel)
            jax.block_until_ready(outc)
            dtc = (time.perf_counter() - t0) / args.reps
            print(
                f"          pointer doubling: {nn/dtp/1e6:8.1f} Mnodes/s  "
                f"({dtp*1e3:.1f} ms, {rounds} rounds)   "
                f"chain grouping: {nn/dtc/1e6:8.1f} Mnodes/s  "
                f"({dtc*1e3:.1f} ms)"
            )
        n_dev *= 2


if __name__ == "__main__":
    main()
