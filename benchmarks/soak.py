#!/usr/bin/env python
"""Long-running randomized soak harness (fresh entropy per iteration).

The deep version of tests/test_fuzz.py — the CI-repeat analogue of the
reference's `ctest --repeat-until-fail 10 -R '.*Random'` loop
(reference: .github/workflows/test.yml:26-28), scaled up: bigger sets,
every key layout, dump/load byte round-trips, multi-set compression
with exact decompression, and (on a multi-device environment) full-SPSS
mesh-vs-host byte parity at random mesh sizes.

Usage:
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python benchmarks/soak.py --minutes 30

Every iteration prints its seed; a failure aborts with the seed and
parameters needed to reproduce.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

# Host-only soak unless the caller explicitly chose a platform for it.
os.environ["JAX_PLATFORMS"] = os.environ.get("KMERSET_TPU_SOAK_PLATFORM", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Runnable as `python benchmarks/soak.py` without an editable install.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np


def _n_mappings() -> int:
    """Current process VMA count (the resource LLVM's in-process JIT
    exhausts first; limit = vm.max_map_count, typically 65530)."""
    try:
        with open("/proc/self/maps", "rb") as f:
            return sum(1 for _ in f)
    except OSError:
        return 0


def _fresh_kmers(strings, k: int, canonical: bool) -> np.ndarray:
    """SPSS freshness invariant (reference: test/spss.cc:33-37)."""
    from kmerset_tpu.core import kmer as kc

    seen = []
    for s in range(len(strings)):
        codes = strings.get_codes(s).astype(np.int64)
        assert codes.shape[0] >= k, "string shorter than k"
        w = kc.kmers_from_codes(codes, k)
        if canonical:
            w = kc.canonical(w, k)
        seen.append(w)
    allk = np.concatenate(seen) if seen else np.empty(0, np.int64)
    assert np.unique(allk).shape[0] == allk.shape[0], "duplicate k-mer in SPSS"
    return np.unique(allk)


def iter_spss(rng: np.random.Generator, log) -> None:
    """Freshness + reconstruction + dump/load byte round-trip on a
    larger-than-test random set, any key layout."""
    from kmerset_tpu.core import spss
    from kmerset_tpu.core.kmer_set import KmerSet
    from kmerset_tpu.core.kmer_set_compact import KmerSetCompact
    from kmerset_tpu.utils.io import TemporaryDirectory
    from kmerset_tpu.utils.random import get_random_kmer_set

    canonical = bool(rng.integers(0, 2))
    if canonical:
        k = int(rng.integers(2, 16)) * 2 + 1  # odd, 5..31
    else:
        k = int(rng.integers(2, 32))
    n = int(rng.integers(1, 1 << 15))
    fast = bool(rng.integers(0, 2))
    log(f"spss k={k} canonical={canonical} n~{n} fast={fast}")
    ks = get_random_kmer_set(k, n, canonical, rng)
    out = (
        spss.get_spss_canonical(ks, fast=fast)
        if canonical
        else spss.get_spss(ks)
    )
    uniq = _fresh_kmers(out, k, canonical)
    assert np.array_equal(uniq, ks.kmers), "SPSS does not cover the set"
    rt = spss.get_kmer_set_from_spss(out, k, canonical)
    assert rt.equals(KmerSet(k, ks.kmers, _sorted=True)), "round trip"
    comp = KmerSetCompact(k, out)
    with TemporaryDirectory() as td:
        p = os.path.join(td.name(), "s.txt")
        comp.dump(p)
        again = KmerSetCompact.load(k, p)
        assert comp.spss.to_strings() == again.spss.to_strings(), "dump/load"


def iter_counter(rng: np.random.Generator, log) -> None:
    """FASTA counting vs a brute-force numpy oracle, with 'N' breaks,
    saturation, and a random cutoff."""
    from kmerset_tpu.core import kmer as kc
    from kmerset_tpu.core.kmer_counter import KmerCounter
    from kmerset_tpu.utils.io import TemporaryDirectory

    k = int(rng.integers(2, 16)) * 2 + 1
    canonical = bool(rng.integers(0, 2))
    cutoff = int(rng.integers(1, 4))
    n_reads = int(rng.integers(1, 60))
    log(f"counter k={k} canonical={canonical} cutoff={cutoff} reads={n_reads}")
    reads = []
    for _ in range(n_reads):
        m = int(rng.integers(1, 120))
        reads.append(
            "".join(rng.choice(list("ACGT" + "N" * (1 if m > k else 0)), m))
        )
    # Oracle: split at N, slide windows, canonicalize, count.
    frags = []
    for r in reads:
        frags.extend(x for x in r.split("N") if len(x) >= k)
    kmers = []
    for f in frags:
        w = kc.kmers_from_codes(kc.string_to_codes(f), k)
        kmers.append(kc.canonical(w, k) if canonical else w)
    allk = (
        np.concatenate(kmers) if kmers else np.empty(0, np.int64)
    )
    uniq, counts = np.unique(allk, return_counts=True)
    want = uniq[counts >= cutoff]
    with TemporaryDirectory() as td:
        p = os.path.join(td.name(), "r.fasta")
        with open(p, "w") as fh:
            for i, r in enumerate(reads):
                fh.write(f">s{i}\n{r}\n")
        c = KmerCounter.from_fasta(k, p, "", canonical=canonical)
        got, _ = c.to_kmer_set(cutoff)
    assert np.array_equal(got.kmers, want), "counter vs oracle"


def iter_multiset(rng: np.random.Generator, log) -> None:
    """KmerSetSet over related sets: exact decompression of every
    original, plus directory dump -> Reader round trip."""
    from kmerset_tpu.core.config import get_config
    from kmerset_tpu.core.kmer_set_compact import KmerSetCompact
    from kmerset_tpu.core.kmer_set_set import KmerSetSet, KmerSetSetReader
    from kmerset_tpu.utils.io import TemporaryDirectory
    from kmerset_tpu.utils.random import get_random_kmer_set

    k = int(rng.integers(4, 8)) * 2 + 1  # 9..15
    n_sets = int(rng.integers(2, 6))
    base = get_random_kmer_set(k, int(rng.integers(256, 4096)), True, rng)
    sets = []
    for _ in range(n_sets):
        extra = get_random_kmer_set(k, int(rng.integers(64, 512)), True, rng)
        merged = np.union1d(base.kmers, extra.kmers)
        keep = rng.random(merged.shape[0]) > 0.1
        from kmerset_tpu.core.kmer_set import KmerSet

        sets.append(KmerSet(k, merged[keep], _sorted=True))
    log(f"multiset k={k} n_sets={n_sets} sizes={[s.size() for s in sets]}")
    compacts = [KmerSetCompact.from_kmer_set(s, True) for s in sets]
    cfg = get_config(k, min(10, 2 * k - 2))
    kss = KmerSetSet(
        [KmerSetCompact(k, c.spss) for c in compacts],
        True,
        cfg,
        seed=int(rng.integers(0, 1 << 30)),
    )
    for i, s in enumerate(sets):
        got = kss.get(i, True)
        assert got.equals(s), f"multiset reconstruction i={i}"
    with TemporaryDirectory() as td:
        kss.dump(td.name(), "", "txt")
        reader = KmerSetSetReader.from_directory(cfg, td.name(), "txt", "", True)
        for i, s in enumerate(sets):
            assert reader.get(i).equals(s), f"reader i={i}"


def iter_mesh(rng: np.random.Generator, log) -> None:
    """Full-SPSS byte parity, mesh vs host, at a random mesh size
    (2..n_devices).  Skipped on single-device environments."""
    import jax

    n_avail = len(jax.devices())
    if n_avail < 2:
        log("mesh skipped (single device)")
        return
    from kmerset_tpu.core import spss
    from kmerset_tpu.utils.random import get_random_kmer_set

    k = int(rng.choice([9, 11]))  # bound compile diversity
    n_dev = int(rng.integers(2, n_avail + 1))
    n = int(rng.integers(256, 8192))
    log(f"mesh k={k} n_dev={n_dev} n~{n}")
    ks = get_random_kmer_set(k, n, True, rng)
    prior = os.environ.get("KMERSET_TPU_FORCE_BACKEND")
    os.environ["KMERSET_TPU_MESH_DEVICES"] = str(n_dev)
    os.environ["KMERSET_TPU_FORCE_BACKEND"] = "mesh"
    try:
        a = spss.get_spss_canonical(ks, fast=True)
        os.environ["KMERSET_TPU_FORCE_BACKEND"] = "host"
        b = spss.get_spss_canonical(ks, fast=True)
    finally:
        # Restore (not overwrite) so the rest of the soak keeps
        # exercising whatever backend the caller configured.
        if prior is None:
            os.environ.pop("KMERSET_TPU_FORCE_BACKEND", None)
        else:
            os.environ["KMERSET_TPU_FORCE_BACKEND"] = prior
        os.environ.pop("KMERSET_TPU_MESH_DEVICES", None)
    assert a.to_strings() == b.to_strings(), "mesh/host SPSS bytes differ"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0, help="0 = fresh entropy")
    ap.add_argument(
        "--no-mesh", action="store_true", help="skip mesh parity iterations"
    )
    args = ap.parse_args()

    deadline = time.time() + args.minutes * 60
    it = 0
    while time.time() < deadline:
        seed = args.seed or int.from_bytes(os.urandom(4), "little")
        rng = np.random.default_rng(seed)
        it += 1
        hdr = f"[soak it={it} seed={seed}]"

        def log(msg: str) -> None:
            print(f"{hdr} {msg}", flush=True)

        try:
            iter_spss(rng, log)
            iter_counter(rng, log)
            if it % 4 == 0:
                iter_multiset(rng, log)
            if it % 5 == 0 and not args.no_mesh:
                iter_mesh(rng, log)
        except AssertionError as e:
            print(f"{hdr} FAILED: {e}", flush=True)
            sys.exit(1)
        # Fresh shapes every iteration grow the jit/executable caches
        # without bound; long soaks exhaust the process's mappings
        # ("LLVM compilation error: Cannot allocate memory" with plenty
        # of free RAM — vm.max_map_count is 65530 here and a 20-minute
        # soak died at ~140 iterations under the old fixed every-200
        # cadence).  Clear on measured mapping pressure instead.
        if it % 10 == 0 and _n_mappings() > 40_000:
            jax.clear_caches()
            log(f"cleared jax caches at {_n_mappings()} mappings")
        if args.seed:
            break
    print(f"soak ok: {it} iterations", flush=True)


if __name__ == "__main__":
    main()
