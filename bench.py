#!/usr/bin/env python
"""Benchmark: k-mer counting, SPSS, and end-to-end build throughput.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"} —
headline metric is count_kmers_per_sec (the chip-side counting step,
comparable across rounds) — plus secondary keys in the same object:
spss_kmers_per_sec / spss_vs_baseline (unitig construction + greedy
cover + emission, the phase the reference's spss-benchmark times,
src/spss-benchmark.cc:72-120) and build_kmers_per_sec /
build_vs_baseline (the whole FASTA -> compact-file run, the
user-visible unit of src/kmerset-build.cc:33-111).

Baseline honesty: the counting denominator is a faithful C
re-implementation of the reference's hot loop (see below), x8 threads.
The SPSS/build denominators use THIS package's own host backend
(single core, best-of-N) x8 — generous to the reference, because the
host backend measures >=2x the reference-style hash loop per core on
counting and replaces the reference's pointer-chasing walks with
cache-blocked batched C routines.

Measures the flagship single-device step (window pack -> reverse
complement -> canonical min -> sort -> segment count -> cutoff filter; the
hot path of kmerset-build, reference: lib/core/kmer_counter.h:80-133) on
the default JAX device.

Baseline: the reference publishes no numbers (BASELINE.md) and its binaries
cannot be built here (its C++ deps need network).  The stand-in baseline
re-implements the reference's counting hot loop faithfully in C — rolling
canonical window + open-addressing hash count, the same algorithm as
lib/core/kmer_counter.h:80-133 single-threaded (native/kmerio.c
kmerio_count_hash) — scaled x8 to approximate the reference's 8-thread
configuration, which is generous to the reference (its try_lock merges
scale sublinearly).  vs_baseline = device_rate / (8 * ref_style_rate).
The package's own sort-based host path is also printed for comparison
(it is ~2x faster per core than the reference-style loop).

Input data is generated on device; each timed step is one dispatch of
the jitted count program, synchronized with block_until_ready.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

K = 15
N_WINDOWS = 1 << 22  # 4M k-mers per step
N_BASES_BUILD = 1 << 24  # 16.8M-base genome for the spss/build arms


def host_rate(codes: np.ndarray, k: int) -> float:
    """This package's sort-based host path; best of 3 to damp jitter."""
    from kmerset_tpu.core import kmer as kc

    best = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        w = kc.kmers_from_codes(codes.astype(np.int64), k)
        can = kc.canonical(w, k)
        np.unique(can, return_counts=True)
        best = max(best, w.shape[0] / (time.perf_counter() - t0))
    return best


def reference_style_rate(codes: np.ndarray, k: int) -> float:
    """The reference's counting algorithm (canonical window -> hash bucket
    count, lib/core/kmer_counter.h:80-133) in C, single-threaded.

    Steady-state: one untimed warm-up run first, so the loop's hash-table
    allocation does not pay OS first-touch page provisioning inside the
    timing.  Warm-first is also the generous reading for the reference:
    its CLI pays that provisioning once per process.
    """
    from kmerset_tpu.core import native

    n_windows = codes.shape[0] - k + 1
    codes_u8 = codes.astype(np.uint8)
    if native.count_hash(codes_u8, k) is None:  # warm-up (untimed)
        return 0.0
    # The best of many trials converges on the *uncontended* rate — what
    # the reference would sustain on the dedicated machines it targets
    # (README.md:10-14) — which is the generous-to-the-reference and
    # run-to-run-stable choice on a shared host.
    rates = []
    for _ in range(16):
        t0 = time.perf_counter()
        native.count_hash(codes_u8, k)
        rates.append(n_windows / (time.perf_counter() - t0))
    print(
        f"reference-style C loop trials: min {min(rates)/1e6:.1f} / "
        f"median {sorted(rates)[len(rates)//2]/1e6:.1f} / "
        f"max {max(rates)/1e6:.1f} Mkmers/s (16 warm trials)",
        file=sys.stderr,
    )
    return max(rates)


def _make_genome_fasta(path: str, n_bases: int, seed: int = 1) -> None:
    """Random genome as a FASTA of 10 kb reads (ASCII ACGT)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n_bases).astype(np.uint8)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)[codes]
    read_len = 10_000
    with open(path, "wb") as f:
        for i in range(0, n_bases, read_len):
            f.write(b">r%d\n" % (i // read_len))
            f.write(bases[i : i + read_len].tobytes())
            f.write(b"\n")


def _timed_best(fn, reps: int) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def spss_and_build_rates(k: int, n_bases: int):
    """(spss_dev, spss_host, build_dev, build_host) k-mers/s.

    Device arms run the production auto-routing (the resident count ->
    graph fusion, ops/resident.py); host arms force the host backend.
    Host rates are best-of-N single-core (the uncontended-peak reading,
    same policy as reference_style_rate); x8 scaling happens in main.
    """
    import os
    import tempfile

    from kmerset_tpu.core.kmer_counter import KmerCounter
    from kmerset_tpu.core.kmer_set_compact import KmerSetCompact
    from kmerset_tpu.core.spss import get_spss_canonical

    fa = os.path.join(tempfile.gettempdir(), f"bench_genome_{n_bases}.fasta")
    if not os.path.exists(fa):
        _make_genome_fasta(fa, n_bases)

    def build(tag: str) -> tuple:
        out = os.path.join(tempfile.gettempdir(), f"bench_build_{tag}.txt")
        counter = KmerCounter.from_fasta(k, fa, "", canonical=True, spss_ahead=True)
        ks, _ = counter.to_kmer_set(1)
        compact = KmerSetCompact.from_kmer_set(ks, canonical=True, fast=True)
        compact.dump(out, "")
        return ks

    def set_arm(tag: str) -> None:
        if tag == "host":
            os.environ["KMERSET_TPU_FORCE_BACKEND"] = "host"
        else:
            os.environ.pop("KMERSET_TPU_FORCE_BACKEND", None)

    # Untimed warm-ups (page cache, jit compiles); the warm
    # sets are kept so the spss arms measure the phase alone (the device
    # set keeps its resident handle, so the graph front-end skips its
    # upload — the production build configuration).
    warm = {}
    n_kmers = 0
    for tag in ("host", "dev"):
        set_arm(tag)
        warm[tag] = build(tag)
        n_kmers = warm[tag].size()
    n_reads = (n_bases + 9_999) // 10_000
    n_windows = n_bases - n_reads * (k - 1)

    # Interleaving the arms inside each rep keeps every host/dev pair
    # inside one window of host contention, and best-of-N then reads each
    # arm's uncontended rate (the same policy as reference_style_rate).
    inf = float("inf")
    best = {"build_host": inf, "build_dev": inf,
            "spss_host": inf, "spss_dev": inf}
    for _ in range(3):
        for tag in ("host", "dev"):
            set_arm(tag)
            t0 = time.perf_counter()
            build(tag)
            best[f"build_{tag}"] = min(
                best[f"build_{tag}"], time.perf_counter() - t0
            )
            t0 = time.perf_counter()
            get_spss_canonical(warm[tag])
            best[f"spss_{tag}"] = min(
                best[f"spss_{tag}"], time.perf_counter() - t0
            )
    rates = {}
    for tag in ("host", "dev"):
        rates[f"spss_{tag}"] = n_kmers / best[f"spss_{tag}"]
        rates[f"build_{tag}"] = n_windows / best[f"build_{tag}"]
        print(
            f"{tag}: build {best[f'build_{tag}']:.2f}s "
            f"({n_windows/1e6/best[f'build_{tag}']:.1f} Mkmers/s), "
            f"spss {best[f'spss_{tag}']:.2f}s "
            f"({n_kmers/1e6/best[f'spss_{tag}']:.1f} Mkmers/s), "
            f"n_kmers={n_kmers}",
            file=sys.stderr,
        )
    os.environ.pop("KMERSET_TPU_FORCE_BACKEND", None)
    return rates


def multiset_rates(k: int, n_sets: int = 8, n_bases: int = 2 << 20):
    """Flagship multi-set compression arm (the reference's core
    contribution, lib/core/kmer_set_set.h:109-427): N related sets
    (mutated strains of one genome), compress + dump, reader-decompress
    + verify, and the achieved weight ratio.  Host-forced arm for the
    backend comparison (the sketch oracle auto-routes; at this scale on
    this scale both arms may run the host oracle, so vs_host_backend
    ~ 1.0 is an honest reading, not a bug)."""
    import os
    import shutil
    import tempfile

    from kmerset_tpu.core import kmer as kc
    from kmerset_tpu.core.config import get_config
    from kmerset_tpu.core.kmer_set import KmerSet
    from kmerset_tpu.core.kmer_set_compact import KmerSetCompact
    from kmerset_tpu.core.kmer_set_set import KmerSetSet, KmerSetSetReader

    cfg = get_config(k)
    rng = np.random.default_rng(99)
    base = rng.integers(0, 4, n_bases).astype(np.int64)
    arrays = []
    for _ in range(n_sets):
        mut = base.copy()
        pos = rng.integers(0, n_bases, n_bases // 250)
        mut[pos] = rng.integers(0, 4, pos.shape[0])
        arrays.append(
            np.unique(kc.canonical(kc.kmers_from_codes(mut, k), k))
        )

    # Input compact sets are built ONCE, untimed — the reference's
    # kmerset-multiple-compress loads already-built files; timing set
    # construction would charge the compress metric for build work.
    # Reuse across runs is sound: KmerSetSet construction is a pure
    # function of the input k-mer arrays (inputs are only packed
    # in-memory, a transparent representation change).
    base_sets = [
        KmerSetCompact.from_kmer_set(KmerSet(k, A, _sorted=True), True)
        for A in arrays
    ]
    w_in = sum(s.weight() for s in base_sets)

    def compress_once():
        return KmerSetSet(base_sets, True, cfg, seed=1)

    # Warm-up + result (kept for the dump/decompress measurement).
    kss = compress_once()
    w_out = sum(s.weight() for s in kss.kmer_sets_compact_)

    t0 = time.perf_counter()
    compress_once()
    compress_s = time.perf_counter() - t0

    os.environ["KMERSET_TPU_FORCE_BACKEND"] = "host"
    try:
        t0 = time.perf_counter()
        compress_once()
        compress_host_s = time.perf_counter() - t0
    finally:
        os.environ.pop("KMERSET_TPU_FORCE_BACKEND", None)

    d = os.path.join(tempfile.gettempdir(), "bench_multiset_dir")
    shutil.rmtree(d, ignore_errors=True)
    kss.dump(d, "", "txt", workers=1)
    reader = KmerSetSetReader.from_directory(cfg, d, "txt", "", True)
    t0 = time.perf_counter()
    for i, got in reader.get_all():
        if i < n_sets:  # user-visible originals; the rest are children
            assert got.size() == arrays[i].shape[0]
    decompress_s = time.perf_counter() - t0
    print(
        f"multiset: {n_sets} sets x {n_bases/1e6:.0f} Mbase, compress "
        f"{compress_s:.2f}s (host {compress_host_s:.2f}s), decompress "
        f"{decompress_s:.2f}s, weight {w_in} -> {w_out} "
        f"({w_in/max(w_out,1):.2f}x)",
        file=sys.stderr,
    )
    return {
        "multiset_compress_s": compress_s,
        "multiset_decompress_s": decompress_s,
        "multiset_ratio": w_in / max(w_out, 1),
        "multiset_vs_host_backend": compress_host_s / max(compress_s, 1e-9),
    }


def main() -> None:
    import jax
    import jax.numpy as jnp

    from kmerset_tpu.ops import backend
    from kmerset_tpu.ops.count import count_to_set

    backend.enable_compile_cache()

    rng = np.random.default_rng(0)
    codes_h = rng.integers(0, 4, size=N_WINDOWS + K - 1).astype(np.int32)
    h_rate = host_rate(codes_h, K)
    print(f"host (this pkg, 1 core): {h_rate/1e6:.2f} Mkmers/s", file=sys.stderr)
    ref_rate = reference_style_rate(codes_h, K) or h_rate
    print(
        f"reference-style C hash loop (1 core): {ref_rate/1e6:.2f} Mkmers/s",
        file=sys.stderr,
    )

    # A process meant for an accelerator whose backend is missing or came
    # up as the CPU raises here (ops/backend._backend_alive).
    backend._backend_alive()
    dev = jax.devices()[0]
    print(f"device: {dev} ({dev.device_kind})", file=sys.stderr)

    @jax.jit
    def gen(key):
        return jax.random.randint(key, (N_WINDOWS + K - 1,), 0, 4, dtype=jnp.int32)

    codes = gen(jax.random.key(0))
    codes.block_until_ready()
    valid = jnp.ones(N_WINDOWS + K - 1, dtype=bool).at[-(K - 1) :].set(False)

    def one_step():
        out, n_kept, _ = count_to_set(codes, valid, K, True, 1)
        return jax.block_until_ready((out, n_kept))

    t0 = time.perf_counter()
    _, n_kept = one_step()
    print(f"compile+first run: {time.perf_counter()-t0:.1f}s", file=sys.stderr)
    assert int(n_kept) > 0

    import contextlib
    import os

    # KMERSET_TPU_PROFILE=<dir> captures a jax.profiler trace of the
    # measured steps (SURVEY §5.1: the reference's only tracing is
    # stopwatch logs; here the full XLA op timeline is available).
    prof_dir = os.environ.get("KMERSET_TPU_PROFILE", "")
    ctx = (
        jax.profiler.trace(prof_dir) if prof_dir else contextlib.nullcontext()
    )
    reps = 20
    times = []
    with ctx:
        for _ in range(reps):
            t0 = time.perf_counter()
            one_step()
            times.append(time.perf_counter() - t0)
    dt = sorted(times)[reps // 2]
    rate = N_WINDOWS / dt
    print(
        f"device: {rate/1e6:.2f} Mkmers/s (median {dt*1e3:.2f} ms/step, "
        f"min {min(times)*1e3:.2f}, max {max(times)*1e3:.2f}, {reps} steps)",
        file=sys.stderr,
    )

    baseline = 8.0 * ref_rate

    # SPSS + end-to-end build arms (BASELINE.json's metric is count +
    # SPSS; the build number is the reference's user-visible unit).
    # KMERSET_TPU_BENCH_SKIP_BUILD=1 skips them (count-only quick runs).
    import os as _os

    extra = {}
    if not _os.environ.get("KMERSET_TPU_BENCH_SKIP_BUILD"):
        try:
            r = spss_and_build_rates(K, N_BASES_BUILD)
            extra = {
                "spss_kmers_per_sec": r["spss_dev"],
                "spss_vs_baseline": r["spss_dev"] / (8.0 * r["spss_host"]),
                "build_kmers_per_sec": r["build_dev"],
                "build_vs_baseline": r["build_dev"] / (8.0 * r["build_host"]),
            }
        except Exception as e:  # noqa: BLE001 - never lose the headline
            print(f"spss/build bench failed: {e!r}", file=sys.stderr)
        try:
            extra.update(multiset_rates(K))
        except Exception as e:  # noqa: BLE001 - never lose the headline
            print(f"multiset bench failed: {e!r}", file=sys.stderr)

    print(
        json.dumps(
            {
                "metric": "count_kmers_per_sec",
                "value": rate,
                "unit": "kmers/s",
                "vs_baseline": rate / baseline,
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
                **extra,
            }
        )
    )


if __name__ == "__main__":
    main()
