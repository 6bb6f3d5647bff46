"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from kmerset_tpu.core import kmer as kc  # noqa: E402
from kmerset_tpu.ops.count import SENTINEL, count_to_set, window_validity, pad_to  # noqa: E402
from kmerset_tpu.parallel.mesh import make_mesh, sharded_count_fn, sharded_hash_fn  # noqa: E402

K = 9


def _random_codes(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, size=n).astype(np.int32)


def test_device_count_matches_host():
    codes = _random_codes(4096, 0)
    offsets = np.array([0, codes.size], dtype=np.int64)
    valid = window_validity(offsets, codes.size, K)
    uniq, n_kept, n_cut = count_to_set(codes, valid, K, True, 1)
    uniq = np.asarray(uniq)[: int(n_kept)]
    # Host reference.
    host = np.unique(kc.canonical(kc.kmers_from_codes(codes.astype(np.int64), K), K))
    np.testing.assert_array_equal(uniq, host)


def test_device_count_cutoff():
    codes = np.concatenate([_random_codes(512, 1)] * 3)  # every kmer 3x (mod joins)
    valid = np.zeros(codes.size, dtype=bool)
    # Only windows within each copy are valid (no cross-copy windows).
    for rep in range(3):
        valid[rep * 512 : rep * 512 + 512 - K + 1] = True
    uniq, n_kept, n_cut = count_to_set(codes, valid, K, False, 3)
    host = kc.kmers_from_codes(codes[:512].astype(np.int64), K)
    hu, hc = np.unique(host, return_counts=True)
    expected = hu[hc * 3 >= 3]
    np.testing.assert_array_equal(np.asarray(uniq)[: int(n_kept)], expected)


@pytest.mark.parametrize("n_dev", [1, 3, 4, 5, 8])
def test_sharded_count(n_dev):
    assert len(jax.devices()) >= n_dev
    mesh = make_mesh(n_dev)
    # 8160 = lcm(3,4,5,8)·68: sharded_count_fn's contract is per-device
    # equal shards (the production driver pads; here the test sizes the
    # global array directly so odd mesh sizes divide it).
    codes = _random_codes(8160, 2)
    offsets = np.array([0, codes.size], dtype=np.int64)
    valid = window_validity(offsets, codes.size, K)

    # Shard inputs across devices (simple contiguous split); windows
    # crossing shard boundaries are dropped from validity on the host the
    # same way 'N' breaks do, so semantics here are checked against a host
    # run with the same mask.
    per = codes.size // n_dev
    valid2 = valid.copy()
    for d in range(1, n_dev):
        valid2[d * per - K + 1 : d * per] = False

    fn = sharded_count_fn(mesh, K, True, capacity=8192)
    uniq, counts, n_unique, total, dropped = fn(codes, valid2)
    assert int(dropped[0]) == 0
    windows = kc.kmers_from_codes(codes.astype(np.int64), K)
    host = np.unique(
        kc.canonical(windows[np.flatnonzero(valid2[: windows.shape[0]])], K)
    )
    assert int(total[0]) == host.shape[0]
    # Collect per-device live prefixes.
    got = np.asarray(uniq)
    got = np.sort(got[got != SENTINEL])
    np.testing.assert_array_equal(got, host)

    hfn = sharded_hash_fn(mesh)
    h = int(np.asarray(hfn(uniq))[0])
    assert h == int(np.bitwise_xor.reduce(host))


def test_sharded_capacity_overflow_detected():
    mesh = make_mesh(2)
    codes = _random_codes(2048, 3)
    valid = np.ones(codes.size, dtype=bool)
    valid[-(K - 1) :] = False
    fn = sharded_count_fn(mesh, K, True, capacity=8)
    _, _, _, _, dropped = fn(codes, valid)
    assert int(dropped[0]) > 0


@pytest.mark.parametrize("k", [7, 11, 15, 16, 19, 23, 25])
@pytest.mark.parametrize("canonical", [True, False])
def test_count_kmers_all_key_widths(k, canonical):
    """Exercises every key representation (single int32 for k <= 15,
    int32 pair for k <= 23, int64 above) and the log-doubling window pack
    against the host codec."""
    codes = _random_codes(3000, k * 7 + canonical)
    offsets = np.array([0, 1000, 1500, codes.size], dtype=np.int64)
    valid = window_validity(offsets, codes.size, k)
    from kmerset_tpu.ops.count import count_kmers

    uniq, counts, n_unique = count_kmers(codes, valid, k, canonical)
    n = int(n_unique)
    windows = kc.kmers_from_codes(codes.astype(np.int64), k)
    w = windows[np.flatnonzero(valid[: windows.shape[0]])]
    if canonical:
        w = kc.canonical(w, k)
    hu, hc = np.unique(w, return_counts=True)
    np.testing.assert_array_equal(np.asarray(uniq)[:n], hu)
    np.testing.assert_array_equal(np.asarray(counts)[:n], hc)


@pytest.mark.parametrize("k", [9, 15, 19])
@pytest.mark.parametrize("cutoff", [1, 2, 3, 9])
def test_count_to_set_cutoffs(k, cutoff):
    """Covers both cutoff mechanisms: shifted-compare (cutoff <= 8) and the
    run-length scan (cutoff > 8)."""
    rng = np.random.default_rng(100 + k + cutoff)
    base = rng.integers(0, 4, size=256).astype(np.int32)
    reps = 10
    codes = np.concatenate([base] * reps)
    valid = np.zeros(codes.size, dtype=bool)
    for r in range(reps):
        valid[r * 256 : r * 256 + 256 - k + 1] = True
    uniq, n_kept, n_cut = count_to_set(codes, valid, k, True, cutoff)
    w = kc.canonical(kc.kmers_from_codes(base.astype(np.int64), k), k)
    hu, hc = np.unique(w, return_counts=True)
    expected = hu[hc * reps >= cutoff]
    np.testing.assert_array_equal(np.asarray(uniq)[: int(n_kept)], expected)
    assert int(n_cut) == hu.shape[0] - expected.shape[0]


@pytest.mark.parametrize("n_dev", [1, 4])
def test_sharded_set_algebra(n_dev):
    from kmerset_tpu.parallel.mesh import sharded_set_algebra_fn

    mesh = make_mesh(n_dev)
    rng = np.random.default_rng(7)
    cap_per_dev = 1024
    cap = cap_per_dev * n_dev
    A = np.unique(rng.integers(0, 1 << 20, 900)).astype(np.int64)
    B = np.unique(rng.integers(0, 1 << 20, 900)).astype(np.int64)

    # Shard by key range: device d gets keys in its range, locally padded.
    edges = np.linspace(0, 1 << 20, n_dev + 1).astype(np.int64)
    def shard(x):
        out = np.full(cap, SENTINEL, dtype=np.int64)
        for d in range(n_dev):
            part = x[(x >= edges[d]) & (x < edges[d + 1])]
            out[d * cap_per_dev : d * cap_per_dev + part.size] = part
        return out

    fn = sharded_set_algebra_fn(mesh)
    inter, a_only, b_only, sizes = fn(shard(A), shard(B))

    def collect(x):
        x = np.asarray(x)
        return np.sort(x[x != SENTINEL])

    np.testing.assert_array_equal(collect(inter), np.intersect1d(A, B))
    np.testing.assert_array_equal(collect(a_only), np.setdiff1d(A, B))
    np.testing.assert_array_equal(collect(b_only), np.setdiff1d(B, A))
    s = np.asarray(sizes)[0]
    assert list(s) == [
        np.intersect1d(A, B).size,
        np.setdiff1d(A, B).size,
        np.setdiff1d(B, A).size,
    ]


@pytest.mark.parametrize("n_dev", [1, 4])
def test_sharded_sketch_weights(n_dev):
    from kmerset_tpu.parallel.mesh import sharded_sketch_weights_fn

    mesh = make_mesh(n_dev)
    rng = np.random.default_rng(8)
    n_sets, per_dev = 5, 512
    S = per_dev * n_dev
    edges = np.linspace(0, 1 << 16, n_dev + 1).astype(np.int64)
    raw = [np.unique(rng.integers(0, 1 << 16, 400)).astype(np.int64) for _ in range(n_sets)]
    sk = np.full((n_sets, S), SENTINEL, dtype=np.int64)
    for i, x in enumerate(raw):
        for d in range(n_dev):
            part = x[(x >= edges[d]) & (x < edges[d + 1])]
            sk[i, d * per_dev : d * per_dev + part.size] = part

    pairs = [(i, j) for i in range(n_sets) for j in range(i + 1, n_sets)]
    ia = np.array([p[0] for p in pairs], dtype=np.int32)
    ib = np.array([p[1] for p in pairs], dtype=np.int32)
    fn = sharded_sketch_weights_fn(mesh)
    w = np.asarray(fn(sk, ia, ib))
    exp = [np.intersect1d(raw[i], raw[j]).size for i, j in pairs]
    np.testing.assert_array_equal(w, exp)


def test_mesh_sketch_table():
    from kmerset_tpu.ops.sketch import MeshSketchTable

    mesh = make_mesh(4)
    k = 9
    rng = np.random.default_rng(12)
    sketches = [
        np.unique(rng.integers(0, 1 << (2 * k), 300)).astype(np.int64)
        for _ in range(4)
    ]
    t = MeshSketchTable(sketches, k, mesh)
    pairs = [(i, j) for i in range(4) for j in range(i + 1, 4)]
    w = t.pair_weights(pairs)
    exp = [np.intersect1d(sketches[i], sketches[j]).size for i, j in pairs]
    np.testing.assert_array_equal(w, exp)
    # row update + append
    new = np.unique(rng.integers(0, 1 << (2 * k), 200)).astype(np.int64)
    t.set_row(1, new)
    idx = t.append_row(sketches[0])
    w2 = t.pair_weights([(1, idx)])
    assert w2[0] == np.intersect1d(new, sketches[0]).size


def test_k31_all_T_not_conflated_with_sentinel():
    """The all-T 31-mer packs to 2^62 - 1; the sharded counter must not
    confuse it with padding (regression for the old SENTINEL value)."""
    k = 31
    mesh = make_mesh(1)
    codes = np.full(2 * k, 3, dtype=np.int32)  # TTTT...T
    codes[k] = 0  # one A to create a second distinct kmer
    valid = np.ones(codes.size, dtype=bool)
    valid[-(k - 1) :] = False
    fn = sharded_count_fn(mesh, k, False, capacity=64)
    uniq, counts, n_unique, total, dropped = fn(codes, valid)
    from kmerset_tpu.core import kmer as kc2

    host = np.unique(kc2.kmers_from_codes(codes.astype(np.int64), k))
    assert int(total[0]) == host.shape[0]


def test_device_unique_matches_host_decode():
    """backend.device_unique (the decode-direction device path) equals the
    host extract+unique on fragmented inputs of awkward sizes."""
    from kmerset_tpu.core import kmer as kc
    from kmerset_tpu.ops import backend

    rng = np.random.default_rng(17)
    for total in (100, 16384 + 13, 50001):
        codes = rng.integers(0, 4, total).astype(np.int32)
        cuts = np.sort(rng.choice(np.arange(1, total), 3, replace=False))
        offsets = np.concatenate([[0], cuts, [total]]).astype(np.int64)
        got = backend.device_unique(codes, offsets, K, True)
        assert got is not None
        frags = np.split(codes, cuts)
        parts = []
        for f in frags:
            if f.size >= K:
                w = kc.kmers_from_codes(f.astype(np.int64), K)[: f.size - K + 1]
                parts.append(kc.canonical(w, K))
        expect = (
            np.unique(np.concatenate(parts)) if parts else np.empty(0, np.int64)
        )
        assert np.array_equal(got, expect)


def test_offload_gating_cpu_backend(monkeypatch):
    """With jax's default backend on the host CPU, size-based offload is
    disabled (XLA-CPU loses to the native host paths); explicit force
    still wins (ops/backend.py)."""
    from kmerset_tpu.ops import backend

    monkeypatch.delenv("KMERSET_TPU_FORCE_BACKEND", raising=False)
    # Pin the backend probe so the test is deterministic even on a host
    # where jax's default backend is a real accelerator.
    monkeypatch.setattr(backend, "_cpu_backend", lambda: True)
    assert not backend.should_use_device(1 << 30)
    assert not backend.should_use_device_graph(1 << 34)
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "device")
    assert backend.should_use_device(1)
    assert backend.should_use_device_graph(1)


# --- production mesh driver (parallel/driver.py) -------------------------


def _frag_host_counts(codes, offsets, k, canonical):
    from kmerset_tpu.core.kmer_counter import extract_kmers

    kmers = extract_kmers(codes, offsets.astype(np.int64), k, canonical)
    return np.unique(kmers, return_counts=True)


@pytest.mark.parametrize("k", [9, 15, 19])
def test_mesh_driver_matches_host(k):
    """mesh_count on the virtual 8-device mesh equals host counting —
    including windows that straddle shard boundaries (the k-1 halo) and
    fragment breaks."""
    from kmerset_tpu.parallel import driver

    rng = np.random.default_rng(21)
    total = 10000
    codes = rng.integers(0, 4, total).astype(np.int32)
    cuts = np.sort(rng.choice(np.arange(1, total), 4, replace=False))
    offsets = np.concatenate([[0], cuts, [total]]).astype(np.int64)
    got = driver.mesh_count(codes, offsets, k, True)
    assert got is not None
    uniq, counts = got
    hu, hc = _frag_host_counts(codes, offsets, k, True)
    np.testing.assert_array_equal(uniq, hu)
    np.testing.assert_array_equal(counts, hc)


def test_mesh_driver_capacity_retry(monkeypatch):
    """A deliberately tiny initial exchange capacity must trigger the
    overflow-retry loop (dropped > 0 -> double) and still produce exact
    counts."""
    from kmerset_tpu.parallel import driver

    monkeypatch.setenv("KMERSET_TPU_MESH_CAPACITY", "8")
    rng = np.random.default_rng(22)
    total = 4096
    # Skewed keys: long runs of 'A' concentrate k-mers in device 0's range.
    codes = rng.integers(0, 4, total).astype(np.int32)
    codes[: total // 2] = 0
    offsets = np.array([0, total], dtype=np.int64)
    got = driver.mesh_count(codes, offsets, 9, False)
    assert got is not None
    uniq, counts = got
    hu, hc = _frag_host_counts(codes, offsets, 9, False)
    np.testing.assert_array_equal(uniq, hu)
    np.testing.assert_array_equal(counts, hc)


def test_should_use_mesh_gating(monkeypatch):
    from kmerset_tpu.parallel import driver

    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "mesh")
    assert driver.should_use_mesh(1)
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "host")
    assert not driver.should_use_mesh(1 << 30)
    # CPU backend (virtual mesh) without force: off in production.
    monkeypatch.delenv("KMERSET_TPU_FORCE_BACKEND", raising=False)
    assert not driver.should_use_mesh(1 << 30)


def test_mesh_driver_via_kmer_counter(monkeypatch):
    """KmerCounter.from_reads routes through the mesh when forced — the
    production wiring, end to end through the public API."""
    from kmerset_tpu.core.kmer_counter import KmerCounter

    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "mesh")
    rng = np.random.default_rng(23)
    reads = [
        "".join("ACGT"[c] for c in rng.integers(0, 4, 500))
        for _ in range(6)
    ]
    c_mesh = KmerCounter.from_reads(15, reads, True)
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "host")
    c_host = KmerCounter.from_reads(15, reads, True)
    np.testing.assert_array_equal(c_mesh.kmers, c_host.kmers)
    np.testing.assert_array_equal(c_mesh.counts, c_host.counts)


def test_device_fallback_is_logged(monkeypatch, caplog):
    """On the CPU backend a failing forced device path is counted:
    backend.device_count logs the exception at debug level and bumps
    FALLBACK_COUNT, so tests can tell a dead device path from a slow
    host run (ops/backend.py)."""
    import logging

    import kmerset_tpu.ops.count as count_mod
    from kmerset_tpu.ops import backend

    def boom(*a, **k):
        raise RuntimeError("injected device failure")

    monkeypatch.setattr(count_mod, "count_kmers_frag", boom)
    before = backend.FALLBACK_COUNT
    caplog.set_level(logging.DEBUG, logger="kmerset")
    codes = np.zeros(100, dtype=np.int32)
    offsets = np.array([0, 100], dtype=np.int64)
    assert backend.device_count(codes, offsets, 9, True) is None
    assert backend.FALLBACK_COUNT == before + 1
    assert any(
        "falling back to host" in r.message and "device_count" in r.message
        for r in caplog.records
    )


def test_backend_init_timeout(monkeypatch):
    """A requested accelerator whose backend comes up as the CPU raises
    instead of running the host paths as if no device were wanted."""
    import jax

    from kmerset_tpu.ops import backend

    monkeypatch.setattr(backend, "_backend_ready", None)
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    with pytest.raises(RuntimeError, match="backend is the CPU"):
        backend._cpu_backend()
    # Without a request the CPU backend is simply the host.
    monkeypatch.setattr(backend, "_backend_ready", None)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert backend._cpu_backend() is True


def test_backend_init_error(monkeypatch):
    """A requested accelerator whose backend fails to start raises; with
    no accelerator requested a failed start means no device."""
    import jax

    from kmerset_tpu.ops import backend

    def boom():
        raise RuntimeError("injected backend failure")

    monkeypatch.setattr(jax, "default_backend", boom)
    monkeypatch.setattr(backend, "_backend_ready", None)
    monkeypatch.setenv("JAX_PLATFORMS", "cuda,cpu")
    with pytest.raises(RuntimeError, match="failed to start") as ei:
        backend._backend_alive()
    assert "injected backend failure" in str(ei.value.__cause__)
    monkeypatch.setattr(backend, "_backend_ready", None)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert backend._backend_alive() is False
    assert backend._cpu_backend() is True


def test_note_fallback_reraises_on_accelerator(monkeypatch):
    """On a non-CPU backend a failed device path re-raises (with a note
    naming it) and is not counted as a host fallback."""
    import jax

    import kmerset_tpu.ops.count as count_mod
    from kmerset_tpu.ops import backend

    def boom(*a, **k):
        raise ValueError("injected device failure")

    monkeypatch.setattr(count_mod, "count_kmers_frag", boom)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    before = backend.FALLBACK_COUNT
    codes = np.zeros(100, dtype=np.int32)
    offsets = np.array([0, 100], dtype=np.int64)
    with pytest.raises(ValueError, match="injected") as ei:
        backend.device_count(codes, offsets, 9, True)
    assert "device path device_count failed" in ei.value.__notes__
    assert backend.FALLBACK_COUNT == before


def test_mesh_pointer_double_cycle_high_rounds():
    """A cycle node's dist doubles to 2^30 by round 30; the packed done
    bit (bit 30 of the exchanged hi half) must not be contaminated by it
    (mesh.sharded_pointer_double_fn DIST_MASK) — regression for cycles
    being misclassified as chains at rounds >= 31, i.e. padded N > 2^29,
    which silently dropped cycle k-mers from the SPSS."""
    from kmerset_tpu.parallel import driver as mesh_driver
    from kmerset_tpu.parallel.mesh import make_mesh, sharded_pointer_double_fn

    mesh = make_mesh()
    n_dev = int(mesh.devices.size)
    n = 16
    succ = np.full(n, -1, dtype=np.int32)
    for i in range(8):  # one 8-node cycle
        succ[i] = (i + 1) % 8
    succ[8] = 9  # one 3-node chain: 8 -> 9 -> 10 (terminal)
    succ[9] = 10
    cap = -(-n // n_dev)
    N = cap * n_dev
    sp = np.full(N, -1, dtype=np.int32)
    sp[:n] = succ
    lp = np.zeros(N, dtype=np.int32)
    fn = sharded_pointer_double_fn(mesh, 33, False)
    _, _, is_chain, _ = fn(
        mesh_driver._stride_global(mesh, sp),
        mesh_driver._stride_global(mesh, lp),
    )
    is_chain = np.asarray(is_chain)[:n] != 0
    assert not is_chain[:8].any()
    assert is_chain[8:11].all()


def test_mesh_kept_emit_rejects_foreign_start():
    """The kept-emit mesh path falls back (None) when a requested start
    is not its chain's origin — the led-by-starts topology guard shared
    with mesh_chain_group, instead of silently emitting a string that
    includes upstream nodes (core/spss._mesh_chain_walk_kept_emit)."""
    from kmerset_tpu.core import spss as spss_mod

    k = 11
    # One chain of oriented nodes 0 -> 2 -> 4 over 4 entities.
    A = np.array([5, 9, 17, 33], dtype=np.int64)
    succ = np.full(8, -1, dtype=np.int64)
    succ[0] = 2
    succ[2] = 4
    starts = np.array([2], dtype=np.int64)  # mid-chain, not the origin
    em = spss_mod._mesh_chain_walk_kept_emit(A, k, succ, starts)
    assert em is None
    # Positive companion so the rejection above cannot pass vacuously
    # (every failure inside the mesh emit path also returns None): the
    # true origin must round-trip through the same path.  A[first] >=
    # A[last] is required or the orientation skip rule drops the chain.
    A2 = np.array([33, 9, 17, 5], dtype=np.int64)
    em = spss_mod._mesh_chain_walk_kept_emit(
        A2, k, succ, np.array([0], dtype=np.int64)
    )
    assert em is not None
    strings, nodes_k = em
    np.testing.assert_array_equal(nodes_k, [0, 2, 4])
    assert strings.offsets.shape[0] == 2  # one kept string
    assert strings.offsets[1] - strings.offsets[0] == k + 2


def test_decode_unique_via_mesh(monkeypatch):
    """decode_unique_kmers routes through mesh_count under mesh force and
    equals the host decode (the decode-direction scale-out wiring)."""
    from kmerset_tpu.core import spss
    from kmerset_tpu.core.strings import PackedStrings

    rng = np.random.default_rng(29)
    codes = rng.integers(0, 4, 3000).astype(np.uint8)
    offsets = np.array([0, 1200, 3000], dtype=np.int64)
    ps = PackedStrings(codes, offsets)
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "mesh")
    got = spss.decode_unique_kmers(ps, 11, True)
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "host")
    exp = spss.decode_unique_kmers(ps, 11, True)
    np.testing.assert_array_equal(got, exp)


def test_multiset_compress_mesh_oracle(monkeypatch):
    """The multi-set compressor's similarity oracle runs on the mesh
    under mesh force and produces the same factorization as the host
    oracle (SURVEY §5.8 production wiring for compress)."""
    from kmerset_tpu.core.config import get_config
    from kmerset_tpu.core.kmer_set_set import KmerSetSet
    from kmerset_tpu.utils.random import get_random_kmer_sets_compact

    rng = np.random.default_rng(33)
    sets = get_random_kmer_sets_compact(4, 400, 9, True, rng)
    cfg = get_config(9, 10)
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "mesh")
    a = KmerSetSet(list(sets), True, cfg, seed=1)
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "host")
    b = KmerSetSet(list(sets), True, cfg, seed=1)
    assert a.children_ == b.children_
    assert a.size() == b.size()
    for i in range(4):
        ka = a.get(i, True)
        kb = b.get(i, True)
        assert ka.equals(kb)


@pytest.mark.parametrize("k,canonical", [(9, True), (15, True), (19, False), (9, False)])
def test_sharded_side_tables_matches_host(k, canonical):
    """The mesh side-table step (query->owner->answer double all_to_all)
    equals the host `_side_table_*` on the same set — SPSS hot loop #2
    distributed over the key-range mesh."""
    from kmerset_tpu.core import spss as spss_mod
    from kmerset_tpu.parallel.mesh import (
        SENTINEL,
        _S_SENT,
        _owner_edges,
        make_mesh,
        sharded_side_tables_fn,
    )

    n_dev = 4
    mesh = make_mesh(n_dev)
    rng = np.random.default_rng(1000 + k)
    A = np.unique(rng.integers(0, 1 << (2 * k), 5000).astype(np.int64))
    if canonical:
        from kmerset_tpu.core import kmer as kc

        A = np.unique(kc.canonical(A, k))

    narrow = k <= 15
    sent = int(_S_SENT) if narrow else int(SENTINEL)
    dt = np.int32 if narrow else np.int64
    edges = _owner_edges(k, n_dev)
    parts = [A[(A >= edges[d]) & (A < edges[d + 1])] for d in range(n_dev)]
    cap = 1 << int(max(p.shape[0] for p in parts) * 2 - 1).bit_length()
    blocks = np.full((n_dev, cap), sent, dtype=dt)
    for d, p in enumerate(parts):
        blocks[d, : p.shape[0]] = p

    qcap = 8 * cap  # ample: no drops in the fixture
    fn = sharded_side_tables_fn(mesh, k, canonical, qcap)
    rdeg, rnbr, rsame, ldeg, lnbr, lsame, dropped = fn(blocks.reshape(-1))
    assert int(np.asarray(dropped)[0]) == 0

    # Assemble dense outputs from the live prefix of each shard.
    def collect(x):
        x = np.asarray(x).reshape(n_dev, cap)
        return np.concatenate(
            [x[d, : parts[d].shape[0]] for d in range(n_dev)]
        )

    got = {
        "rdeg": collect(rdeg), "rnbr": collect(rnbr), "rsame": collect(rsame),
        "ldeg": collect(ldeg), "lnbr": collect(lnbr), "lsame": collect(lsame),
    }

    if canonical:
        er = spss_mod._side_table_canonical(A, k, right=True)
        el = spss_mod._side_table_canonical(A, k, right=False)
    else:
        er = spss_mod._side_table_plain(A, k, right=True) + (np.zeros(A.shape[0], bool),)
        el = spss_mod._side_table_plain(A, k, right=False) + (np.zeros(A.shape[0], bool),)
    np.testing.assert_array_equal(got["rdeg"], er[0])
    np.testing.assert_array_equal(got["ldeg"], el[0])
    np.testing.assert_array_equal(got["rsame"], er[2])
    np.testing.assert_array_equal(got["lsame"], el[2])
    # nbr compared only where an edge exists (host leaves 0 otherwise).
    has_r = er[0] > 0
    has_l = el[0] > 0
    np.testing.assert_array_equal(got["rnbr"][has_r], er[1][has_r])
    np.testing.assert_array_equal(got["lnbr"][has_l], el[1][has_l])


def test_sharded_unitig_succ_matches_host():
    """The full mesh unitig front-end (side tables + mate-degree
    exchange + terminal tests + oriented successor) equals the host
    formulas on the same set."""
    from kmerset_tpu.core import kmer as kc
    from kmerset_tpu.core import spss as spss_mod
    from kmerset_tpu.parallel.mesh import (
        _S_SENT,
        _owner_edges,
        make_mesh,
        sharded_unitig_succ_fn,
    )

    k = 11
    n_dev = 4
    mesh = make_mesh(n_dev)
    rng = np.random.default_rng(61)
    # Read-derived kmers so real chains/branches exist.
    codes = rng.integers(0, 4, 4000).astype(np.int64)
    A = np.unique(kc.canonical(kc.kmers_from_codes(codes, k), k))

    edges = _owner_edges(k, n_dev)
    parts = [A[(A >= edges[d]) & (A < edges[d + 1])] for d in range(n_dev)]
    cap = 1 << int(max(p.shape[0] for p in parts) * 2 - 1).bit_length()
    blocks = np.full((n_dev, cap), int(_S_SENT), dtype=np.int32)
    for d, p in enumerate(parts):
        blocks[d, : p.shape[0]] = p

    fn = sharded_unitig_succ_fn(mesh, k, qcap=8 * cap)
    succ_r, succ_l, term_l, term_r, both, total, dropped = fn(blocks.reshape(-1))
    assert int(np.asarray(dropped)[0]) == 0
    assert int(np.asarray(total)[0]) == A.shape[0]

    def collect(x):
        x = np.asarray(x).reshape(n_dev, cap)
        return np.concatenate([x[d, : parts[d].shape[0]] for d in range(n_dev)])

    # Host reference: side tables -> terminal tests -> oriented succ
    # (the fallback formulas in spss.get_unitigs_canonical).
    (rdeg, rnbr, rsame) = spss_mod._side_table_canonical(A, k, right=True)
    (ldeg, lnbr, lsame) = spss_mod._side_table_canonical(A, k, right=False)
    mate_r = np.where(rsame, rdeg[rnbr], ldeg[rnbr])
    h_term_r = (rdeg != 1) | (mate_r != 1)
    mate_l = np.where(lsame, ldeg[lnbr], rdeg[lnbr])
    h_term_l = (ldeg != 1) | (mate_l != 1)
    h_succ_r = np.where(h_term_r, -1, 2 * rnbr + rsame)
    h_succ_l = np.where(h_term_l, -1, 2 * lnbr + (~lsame).astype(np.int64))

    np.testing.assert_array_equal(collect(term_r), h_term_r)
    np.testing.assert_array_equal(collect(term_l), h_term_l)
    np.testing.assert_array_equal(collect(succ_r), h_succ_r)
    np.testing.assert_array_equal(collect(succ_l), h_succ_l)
    np.testing.assert_array_equal(collect(both), h_term_l & h_term_r)


def test_unitigs_canonical_via_mesh_front_end(monkeypatch):
    """get_unitigs_canonical under mesh force routes the successor
    construction through the sharded front-end and produces the same
    string multiset as the host path (production wiring)."""
    from kmerset_tpu.core import spss
    from kmerset_tpu.utils.random import get_random_kmer_set

    rng = np.random.default_rng(71)
    ks = get_random_kmer_set(11, 3000, True, rng)
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "mesh")
    a = spss.get_unitigs_canonical(ks)
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "host")
    b = spss.get_unitigs_canonical(ks)
    assert sorted(a.to_strings()) == sorted(b.to_strings())
    # Decode invariant holds through the mesh front-end.
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "host")
    dec = spss.get_kmer_set_from_spss(a, 11, True)
    assert dec.equals(ks)


def test_mesh_unitig_succ_qcap_retry(monkeypatch):
    """A deliberately tiny initial exchange capacity must trigger the
    driver's overflow-retry loop for the unitig front-end and still
    produce the host-identical successor arrays."""
    from kmerset_tpu.core import kmer as kc
    from kmerset_tpu.core import spss as spss_mod
    from kmerset_tpu.parallel import driver

    monkeypatch.setenv("KMERSET_TPU_MESH_CAPACITY", "16")
    rng = np.random.default_rng(83)
    codes = rng.integers(0, 4, 1500).astype(np.int64)
    A = np.unique(kc.canonical(kc.kmers_from_codes(codes, 11), 11))
    res = driver.mesh_unitig_succ(A, 11)
    assert res is not None
    succ, term_l, term_r, both = res
    (rdeg, rnbr, rsame) = spss_mod._side_table_canonical(A, 11, right=True)
    (ldeg, lnbr, lsame) = spss_mod._side_table_canonical(A, 11, right=False)
    mate_r = np.where(rsame, rdeg[rnbr], ldeg[rnbr])
    h_term_r = (rdeg != 1) | (mate_r != 1)
    mate_l = np.where(lsame, ldeg[lnbr], rdeg[lnbr])
    h_term_l = (ldeg != 1) | (mate_l != 1)
    np.testing.assert_array_equal(term_r, h_term_r)
    np.testing.assert_array_equal(term_l, h_term_l)
    np.testing.assert_array_equal(
        succ[0::2], np.where(h_term_r, -1, 2 * rnbr + rsame)
    )
    np.testing.assert_array_equal(
        succ[1::2], np.where(h_term_l, -1, 2 * lnbr + (~lsame).astype(np.int64))
    )


def test_sharded_pointer_double_matches_host():
    """Distributed pointer doubling equals core.graph.pointer_double
    bit-for-bit (end, dist, is_chain, min-label election) on mixed
    chain/cycle successor graphs."""
    from kmerset_tpu.core.graph import pointer_double
    from kmerset_tpu.parallel.mesh import make_mesh, sharded_pointer_double_fn

    n_dev = 4
    mesh = make_mesh(n_dev)
    rng = np.random.default_rng(91)
    for trial in range(3):
        cap = 64
        n = n_dev * cap
        # Functional graph with at most one predecessor: a random
        # permutation (pure cycles) with some edges cut (chains).
        succ = rng.permutation(n).astype(np.int64)
        cut = rng.random(n) < 0.3
        succ[cut] = -1
        labels = rng.integers(0, 1 << 20, n).astype(np.int64)

        rounds = max(1, int(np.ceil(np.log2(max(n, 2)))) + 1)
        fn = sharded_pointer_double_fn(mesh, rounds, with_labels=True)
        end, dist, is_chain, mlab = fn(
            succ.astype(np.int32), labels.astype(np.int32)
        )
        h_end, h_dist, h_chain, h_lab = pointer_double(succ, labels.copy())
        np.testing.assert_array_equal(np.asarray(end), h_end)
        np.testing.assert_array_equal(np.asarray(dist), h_dist)
        np.testing.assert_array_equal(np.asarray(is_chain), h_chain)
        np.testing.assert_array_equal(np.asarray(mlab), h_lab)


def test_break_cycles_via_mesh(monkeypatch):
    """Cycle-leader election routes through distributed pointer doubling
    under mesh force and yields the same SPSS as the host path on a
    cycle-heavy input."""
    from kmerset_tpu.core import kmer as kc
    from kmerset_tpu.core import spss
    from kmerset_tpu.core.kmer_set import KmerSet

    rng = np.random.default_rng(97)
    base = "".join("ACGT"[c] for c in rng.integers(0, 4, 600))
    read = base + base[:8]  # circular: forces cycles at k=9
    codes = kc.string_to_codes(read)
    kmers = kc.canonical(kc.kmers_from_codes(codes, 9), 9)
    ks = KmerSet(9, kmers)

    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "mesh")
    a = spss.get_spss_canonical(ks, fast=True)
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "host")
    b = spss.get_spss_canonical(ks, fast=True)
    assert sorted(a.to_strings()) == sorted(b.to_strings())
    dec = spss.get_kmer_set_from_spss(a, 9, True)
    assert dec.equals(ks)


def test_mesh_chain_group_matches_native_walk():
    """Distributed chain grouping (pointer doubling + owner-routed end
    exchange, parallel/driver.mesh_chain_group) returns the exact
    (nodes, group_starts) of the native sequential walk — one group per
    start, concatenated in starts order, start->end within each group —
    on a graph mixing chains, cycles, and unwalked chains."""
    from kmerset_tpu.core import native
    from kmerset_tpu.parallel import driver

    rng = np.random.default_rng(101)
    n = 3000
    perm = rng.permutation(n).astype(np.int64)
    succ = np.full(n, -1, dtype=np.int64)
    cuts = np.sort(rng.choice(np.arange(1, n), 120, replace=False))
    bounds = np.concatenate([[0], cuts, [n]])
    starts = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        seg = perm[lo:hi]
        succ[seg[:-1]] = seg[1:]
        starts.append(seg[0])
    # First 20 segments become pure cycles (excluded from walks) and a
    # few chains are left out of `starts` (their groups must be
    # filtered, not returned).
    for i in range(20):
        seg = perm[bounds[i] : bounds[i + 1]]
        succ[seg[-1]] = seg[0]
    starts = np.array(starts[20:-5], dtype=np.int64)
    rng.shuffle(starts)

    got = driver.mesh_chain_group(succ, starts)
    assert got is not None
    nodes_h, groups_h = native.chain_walk(succ, starts)
    np.testing.assert_array_equal(got[0], nodes_h)
    np.testing.assert_array_equal(got[1], groups_h)


def test_mesh_chain_walk_kept_matches_native():
    """The mesh kept-walk (grouping + orientation skip rule + the
    native pair-recording order) is bit-identical to
    native.chain_walk_kept on a real bidirected unitig graph."""
    from kmerset_tpu.core import kmer as kc
    from kmerset_tpu.core import native
    from kmerset_tpu.core import spss as spss_mod

    k = 11
    rng = np.random.default_rng(103)
    codes = rng.integers(0, 4, 6000).astype(np.int64)
    A = np.unique(kc.canonical(kc.kmers_from_codes(codes, k), k))
    (rdeg, rnbr, rsame), (ldeg, lnbr, lsame) = spss_mod._side_tables(
        A, k, canonical=True
    )
    mate_r = np.where(rsame, rdeg[rnbr], ldeg[rnbr])
    term_r = (rdeg != 1) | (mate_r != 1)
    mate_l = np.where(lsame, ldeg[lnbr], rdeg[lnbr])
    term_l = (ldeg != 1) | (mate_l != 1)
    n = A.shape[0]
    succ = np.empty(2 * n, dtype=np.int64)
    succ[0::2] = np.where(term_r, -1, 2 * rnbr + rsame)
    succ[1::2] = np.where(term_l, -1, 2 * lnbr + (~lsame).astype(np.int64))
    both = term_l & term_r
    starts = np.concatenate(
        [
            np.flatnonzero(term_l & ~term_r & ~both) * 2,
            np.flatnonzero(term_r & ~term_l) * 2 + 1,
        ]
    )

    kept_m = spss_mod._mesh_chain_walk_kept(A, succ, starts)
    assert kept_m is not None
    kept_h = native.chain_walk_kept(
        succ, starts, lambda s, e: A[s >> 1] >= A[e >> 1]
    )
    assert kept_h is not None
    np.testing.assert_array_equal(kept_m[0], kept_h[0])
    np.testing.assert_array_equal(kept_m[1], kept_h[1])


def test_unitigs_canonical_mesh_exact_bytes(monkeypatch):
    """With every stage mesh-routed (front-end successor construction
    AND the chain walk), get_unitigs_canonical is byte-identical to the
    host path — not merely the same string multiset."""
    from kmerset_tpu.core import spss
    from kmerset_tpu.utils.random import get_random_kmer_set

    rng = np.random.default_rng(107)
    ks = get_random_kmer_set(11, 4000, True, rng)
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "mesh")
    a = spss.get_unitigs_canonical(ks)
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "host")
    b = spss.get_unitigs_canonical(ks)
    assert a.to_strings() == b.to_strings()


def test_mesh_matching_matches_host():
    """Distributed handshake matching (parallel/driver.mesh_matching)
    equals the host fixpoint bit-for-bit — the greedy priority matching
    is unique — on a dense random multigraph."""
    from kmerset_tpu.core.graph import handshake_matching
    from kmerset_tpu.parallel import driver

    rng = np.random.default_rng(113)
    n_ports = 500
    n_e = 2000
    pa = rng.integers(0, n_ports, n_e).astype(np.int64)
    pb = rng.integers(0, n_ports, n_e).astype(np.int64)
    keep = pa != pb
    pa, pb = pa[keep], pb[keep]
    got = driver.mesh_matching(pa, pb, n_ports)
    assert got is not None
    want = handshake_matching(pa, pb, n_ports)
    np.testing.assert_array_equal(got, want)


def test_spss_canonical_mesh_exact_bytes(monkeypatch):
    """The FULL canonical SPSS pipeline under mesh force — counting
    front-end, side tables, successor, chain grouping, handshake
    matching, cycle breaking, and path emission — is byte-identical to
    the host path."""
    from kmerset_tpu.core import spss
    from kmerset_tpu.utils.random import get_random_kmer_set

    rng = np.random.default_rng(127)
    ks = get_random_kmer_set(11, 4000, True, rng)
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "mesh")
    a = spss.get_spss_canonical(ks, fast=True)
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "host")
    b = spss.get_spss_canonical(ks, fast=True)
    assert a.to_strings() == b.to_strings()


def test_spss_canonical_mesh_exact_bytes_non_pow2(monkeypatch):
    """Same full-pipeline byte parity on a 6-device (non-power-of-2)
    mesh: nothing in the key-range split (_owner_edges handles the
    remainder), exchange capacities, or all_to_all layouts may assume a
    power-of-2 device count."""
    from kmerset_tpu.core import spss
    from kmerset_tpu.utils.random import get_random_kmer_set

    rng = np.random.default_rng(211)
    ks = get_random_kmer_set(11, 4000, True, rng)
    monkeypatch.setenv("KMERSET_TPU_MESH_DEVICES", "6")
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "mesh")
    a = spss.get_spss_canonical(ks, fast=True)
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "host")
    b = spss.get_spss_canonical(ks, fast=True)
    assert a.to_strings() == b.to_strings()


def test_mesh_overlap_edges_matches_host():
    """Distributed overlap-edge discovery returns the exact pre-dedup
    (a, b) port-edge list of the native/numpy join, in discovery
    priority order, on real unitigs."""
    from kmerset_tpu.core import native
    from kmerset_tpu.core import spss as spss_mod
    from kmerset_tpu.parallel import driver
    from kmerset_tpu.utils.random import get_random_kmer_set

    k = 11
    rng = np.random.default_rng(131)
    ks = get_random_kmer_set(k, 4000, True, rng)
    unitigs = spss_mod.get_unitigs_canonical(ks)
    P = unitigs.first_kmers(k)
    S = unitigs.last_kmers(k)
    got = driver.mesh_overlap_edges(P, S, k)
    assert got is not None
    want = native.overlap_edges(P, S, k)
    assert want is not None
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_mesh_cycle_emission_exact_bytes(monkeypatch):
    """Cycle-heavy input (circular genome): mesh-routed leftover-cycle
    emission (leader election + predecessor cut + owner-routed
    grouping) is byte-identical to the host walk."""
    from kmerset_tpu.core import kmer as kc
    from kmerset_tpu.core import spss
    from kmerset_tpu.core.kmer_set import KmerSet

    rng = np.random.default_rng(137)
    base = "".join("ACGT"[c] for c in rng.integers(0, 4, 500))
    read = base + base[:8]  # circular at k=9
    codes = kc.string_to_codes(read)
    kmers = kc.canonical(kc.kmers_from_codes(codes, 9), 9)
    ks = KmerSet(9, kmers)
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "mesh")
    a = spss.get_unitigs_canonical(ks)
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "host")
    b = spss.get_unitigs_canonical(ks)
    assert a.to_strings() == b.to_strings()


def test_plain_spss_mesh_exact_bytes(monkeypatch):
    """The non-canonical (directed) SPSS path under mesh force — plain
    chain grouping, matching, cycle walk with oriented=False — is
    byte-identical to the host path."""
    from kmerset_tpu.core import spss
    from kmerset_tpu.utils.random import get_random_kmer_set

    rng = np.random.default_rng(139)
    ks = get_random_kmer_set(9, 3000, False, rng)
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "mesh")
    a = spss.get_spss(ks)
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "host")
    b = spss.get_spss(ks)
    assert a.to_strings() == b.to_strings()
    dec = spss.get_kmer_set_from_spss(a, 9, False)
    assert dec.equals(ks)


def test_mesh_emit_chains_matches_host():
    """Distributed string emission (grouping exchange carrying oriented
    k-mer values + on-device base-code rendering,
    parallel/driver.mesh_emit_chains via spss._mesh_emit_ordered) is
    byte-identical to host chain grouping + _emit_kmer_chains on a
    synthetic chain graph over random k-mer values (oriented=False)."""
    from kmerset_tpu.core import native
    from kmerset_tpu.core import spss as spss_mod

    k = 9
    rng = np.random.default_rng(211)
    n = 2500
    A = np.sort(rng.choice(1 << (2 * k), size=n, replace=False)).astype(
        np.int64
    )
    perm = rng.permutation(n).astype(np.int64)
    succ = np.full(n, -1, dtype=np.int64)
    cuts = np.sort(rng.choice(np.arange(1, n), 90, replace=False))
    bounds = np.concatenate([[0], cuts, [n]])
    starts = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        seg = perm[lo:hi]
        succ[seg[:-1]] = seg[1:]
        starts.append(seg[0])
    starts = np.array(starts[:-4], dtype=np.int64)  # a few unwalked chains
    rng.shuffle(starts)

    em = spss_mod._mesh_emit_ordered(A, k, succ, starts, oriented=False)
    assert em is not None
    ps_mesh, nodes_mesh = em
    nodes_h, groups_h = native.chain_walk(succ, starts)
    ps_host = spss_mod._emit_kmer_chains(
        A, k, nodes_h, groups_h, oriented=False
    )
    assert ps_mesh.to_strings() == ps_host.to_strings()
    np.testing.assert_array_equal(np.sort(nodes_mesh), np.sort(nodes_h))


def test_mesh_kept_emit_matches_native():
    """The fully distributed canonical walk WITH on-device emission
    (spss._mesh_chain_walk_kept_emit) renders exactly the bytes of the
    native kept walk + host emission, in the native emission order."""
    from kmerset_tpu.core import kmer as kc
    from kmerset_tpu.core import native
    from kmerset_tpu.core import spss as spss_mod

    k = 11
    rng = np.random.default_rng(223)
    codes = rng.integers(0, 4, 6000).astype(np.int64)
    A = np.unique(kc.canonical(kc.kmers_from_codes(codes, k), k))
    (rdeg, rnbr, rsame), (ldeg, lnbr, lsame) = spss_mod._side_tables(
        A, k, canonical=True
    )
    mate_r = np.where(rsame, rdeg[rnbr], ldeg[rnbr])
    term_r = (rdeg != 1) | (mate_r != 1)
    mate_l = np.where(lsame, ldeg[lnbr], rdeg[lnbr])
    term_l = (ldeg != 1) | (mate_l != 1)
    n = A.shape[0]
    succ = np.empty(2 * n, dtype=np.int64)
    succ[0::2] = np.where(term_r, -1, 2 * rnbr + rsame)
    succ[1::2] = np.where(term_l, -1, 2 * lnbr + (~lsame).astype(np.int64))
    both = term_l & term_r
    starts = np.concatenate(
        [
            np.flatnonzero(term_l & ~term_r & ~both) * 2,
            np.flatnonzero(term_r & ~term_l) * 2 + 1,
        ]
    )

    em = spss_mod._mesh_chain_walk_kept_emit(A, k, succ, starts)
    assert em is not None
    ps_mesh, nodes_mesh = em
    kept_h = native.chain_walk_kept(
        succ, starts, lambda s, e: A[s >> 1] >= A[e >> 1]
    )
    assert kept_h is not None
    ps_host = spss_mod._emit_kmer_chains(
        A, k, kept_h[0], kept_h[1], oriented=True
    )
    assert ps_mesh.to_strings() == ps_host.to_strings()
    np.testing.assert_array_equal(np.sort(nodes_mesh), np.sort(kept_h[0]))


def test_mesh_emit_wide_key_exact_bytes(monkeypatch):
    """k=19 (pair-lane values, 64-bit on-device reverse complement):
    mesh-rendered unitigs are byte-identical to the host path."""
    from kmerset_tpu.core import spss
    from kmerset_tpu.utils.random import get_random_kmer_set

    rng = np.random.default_rng(227)
    ks = get_random_kmer_set(19, 2500, True, rng)
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "mesh")
    a = spss.get_unitigs_canonical(ks)
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "host")
    b = spss.get_unitigs_canonical(ks)
    assert a.to_strings() == b.to_strings()


def test_mesh_emit_ocap_retry(monkeypatch):
    """An undersized output-code capacity overflows, is counted, and the
    driver retries with doubled ocap until the render fits."""
    from kmerset_tpu.core import native
    from kmerset_tpu.core import spss as spss_mod
    from kmerset_tpu.parallel import driver

    k = 9
    rng = np.random.default_rng(229)
    n = 600
    A = np.sort(rng.choice(1 << (2 * k), size=n, replace=False)).astype(
        np.int64
    )
    perm = rng.permutation(n).astype(np.int64)
    succ = np.full(n, -1, dtype=np.int64)
    succ[perm[:-1]] = perm[1:]
    starts = np.array([perm[0]], dtype=np.int64)

    monkeypatch.setenv("KMERSET_TPU_MESH_CAPACITY", "64")
    res = driver.mesh_emit_chains(A, k, succ, starts, oriented=False)
    monkeypatch.delenv("KMERSET_TPU_MESH_CAPACITY")
    assert res is not None
    nodes, groups, codes, str_offsets = res
    nodes_h, groups_h = native.chain_walk(succ, starts)
    ps_host = spss_mod._emit_kmer_chains(
        A, k, nodes_h, groups_h, oriented=False
    )
    assert codes.shape[0] == int(str_offsets[-1])
    np.testing.assert_array_equal(codes, ps_host.codes)


def test_device_count_chunked_matches_host(monkeypatch):
    """Out-of-core single-chip counting (CHUNK_WINDOWS slices with k-1
    halos + native run merge, ops/backend.device_count_chunked) returns
    the exact global (uniq, counts) of the one-shot host count, across
    chunk boundaries and fragment splits."""
    from kmerset_tpu.core.kmer_counter import KmerCounter, extract_kmers
    from kmerset_tpu.ops import backend

    rng = np.random.default_rng(233)
    codes = rng.integers(0, 4, 10000).astype(np.int32)
    # Fragment boundaries straddling chunk edges (chunk = 1500 windows).
    offsets = np.array([0, 1499, 1501, 4096, 9000, 10000], dtype=np.int64)
    monkeypatch.setattr(backend, "CHUNK_WINDOWS", 1500)
    got = backend.device_count_chunked(codes, offsets, 9, True)
    assert got is not None
    hu, hc = np.unique(
        extract_kmers(codes, offsets, 9, True), return_counts=True
    )
    np.testing.assert_array_equal(got[0], hu)
    np.testing.assert_array_equal(got[1], hc)

    # The counter routes past-ceiling inputs through the chunked path
    # (force=device bypasses the CPU-backend guard like the other tests).
    monkeypatch.setattr(backend, "MAX_DEVICE_WINDOWS", 2048)
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "device")
    c = KmerCounter._from_codes(9, codes, offsets, True)
    monkeypatch.delenv("KMERSET_TPU_FORCE_BACKEND")
    np.testing.assert_array_equal(c.kmers, hu)
    np.testing.assert_array_equal(c.counts, np.minimum(hc, c.value_max))


def test_merge_count_runs_numpy_fallback(monkeypatch):
    """The pure-numpy run merge agrees with the native one on shared and
    disjoint keys (3-way balanced cascade)."""
    from kmerset_tpu.core import native
    from kmerset_tpu.ops.backend import _merge_count_runs

    rng = np.random.default_rng(239)
    parts = []
    for _ in range(3):
        k = np.unique(rng.integers(0, 500, 200)).astype(np.int64)
        c = rng.integers(1, 9, k.size).astype(np.int64)
        parts.append((k, c))
    want = _merge_count_runs([(a.copy(), b.copy()) for a, b in parts])
    monkeypatch.setattr(native, "merge_counts", lambda *a: None)
    got = _merge_count_runs(parts)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_merge_count_runs_numpy_fallback_empty(monkeypatch):
    """Empty runs (a chunk with zero valid windows) merge cleanly in the
    numpy fallback — regression for an IndexError on boundary[0]."""
    from kmerset_tpu.core import native
    from kmerset_tpu.ops.backend import _merge_count_runs

    monkeypatch.setattr(native, "merge_counts", lambda *a: None)
    e = np.empty(0, dtype=np.int64)
    k, c = _merge_count_runs([(e, e), (e, e)])
    assert k.size == 0 and c.size == 0
    k, c = _merge_count_runs(
        [(e, e), (np.array([7], dtype=np.int64), np.array([2], dtype=np.int64))]
    )
    np.testing.assert_array_equal(k, [7])
    np.testing.assert_array_equal(c, [2])


def test_device_unique_chunked_matches_host(monkeypatch):
    """Out-of-core decode (chunked cutoff-1 unique + keys-only union
    merge) equals the one-shot host unique, and decode_unique_kmers
    routes past-ceiling SPSS decodes through it."""
    from kmerset_tpu.core import spss
    from kmerset_tpu.core.kmer_counter import extract_kmers
    from kmerset_tpu.core.strings import PackedStrings
    from kmerset_tpu.ops import backend

    rng = np.random.default_rng(241)
    codes = rng.integers(0, 4, 8000).astype(np.uint8)
    offsets = np.array([0, 900, 901, 3000, 8000], dtype=np.int64)
    monkeypatch.setattr(backend, "CHUNK_WINDOWS", 900)
    got = backend.device_unique_chunked(codes, offsets, 9, True)
    assert got is not None
    hu = np.unique(extract_kmers(codes, offsets, 9, True))
    np.testing.assert_array_equal(got, hu)

    monkeypatch.setattr(backend, "MAX_DEVICE_WINDOWS", 1024)
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "device")
    ps = PackedStrings(codes, offsets)
    routed = spss.decode_unique_kmers(ps, 9, True)
    monkeypatch.delenv("KMERSET_TPU_FORCE_BACKEND")
    np.testing.assert_array_equal(routed, hu)


def test_native_merge_keys():
    from kmerset_tpu.core import native

    if native.get_lib() is None:
        import pytest as _pytest

        _pytest.skip("native library unavailable")
    rng = np.random.default_rng(251)
    a = np.unique(rng.integers(0, 300, 120)).astype(np.int64)
    b = np.unique(rng.integers(0, 300, 120)).astype(np.int64)
    got = native.merge_keys(a, b)
    assert got is not None
    np.testing.assert_array_equal(got, np.union1d(a, b))


def test_sentinel_queries_do_not_consume_lane_capacity():
    """Padding (sentinel) queries stay local in _route_queries: with a
    block that is >90% sentinel padding, a lane capacity sized for the
    REAL queries alone must not overflow (before the sentinel-free
    exchange every padding query was routed to the last owner and
    overflowed any realistically-sized lane), and the answers must still
    match the host side tables."""
    from kmerset_tpu.core import spss as spss_mod
    from kmerset_tpu.parallel.mesh import (
        _S_SENT,
        _owner_edges,
        make_mesh,
        sharded_side_tables_fn,
    )

    k, n_dev = 9, 4
    mesh = make_mesh(n_dev)
    rng = np.random.default_rng(77)
    from kmerset_tpu.core import kmer as kc

    A = np.unique(
        kc.canonical(
            np.unique(rng.integers(0, 1 << (2 * k), 600).astype(np.int64)), k
        )
    )
    sent = int(_S_SENT)
    edges = _owner_edges(k, n_dev)
    parts = [A[(A >= edges[d]) & (A < edges[d + 1])] for d in range(n_dev)]
    # Pad blocks to 16x the biggest shard: >90% of the 8*cap query
    # slots are sentinels.
    cap = 16 * max(p.shape[0] for p in parts)
    blocks = np.full((n_dev, cap), sent, dtype=np.int32)
    for d, p in enumerate(parts):
        blocks[d, : p.shape[0]] = p

    # Lanes sized for real traffic only: every live row emits 8 queries,
    # spread over n_dev owners; 4x slack covers key skew but is far
    # below the sentinel flood (which would need ~8*cap on one lane).
    qcap = 8 * max(p.shape[0] for p in parts)
    assert qcap * n_dev < 8 * cap  # the flood would not fit
    fn = sharded_side_tables_fn(mesh, k, True, qcap)
    rdeg, rnbr, rsame, ldeg, lnbr, lsame, dropped = fn(blocks.reshape(-1))
    assert int(np.asarray(dropped)[0]) == 0

    def collect(x):
        x = np.asarray(x).reshape(n_dev, cap)
        return np.concatenate(
            [x[d, : parts[d].shape[0]] for d in range(n_dev)]
        )

    er = spss_mod._side_table_canonical(A, k, right=True)
    el = spss_mod._side_table_canonical(A, k, right=False)
    np.testing.assert_array_equal(collect(rdeg), er[0])
    np.testing.assert_array_equal(collect(ldeg), el[0])


def test_count_to_set_tiny_input_large_cutoff():
    """Fewer window keys than cutoff-1 must yield an empty set, not a
    shape-broadcast trace error in _run_reaches' shifted compare."""
    k = 9
    codes = _random_codes(k + 2, 4)  # 3 windows
    valid = np.ones(codes.size, dtype=bool)
    valid[-(k - 1):] = False
    for cutoff in (4, 8):
        uniq, n_kept, n_cut = count_to_set(codes, valid, k, True, cutoff)
        assert int(n_kept) == 0
        assert int(n_cut) == np.unique(
            kc.canonical(kc.kmers_from_codes(codes.astype(np.int64), k), k)
        ).shape[0]


@pytest.mark.parametrize("k", [11, 19])
def test_count_paths_parity_past_block_scale(k):
    """count_kmers (run lengths from the reverse-cummin scan, compaction
    by the flag-fused sort) and count_to_set (cutoff by shifted compares)
    equal host counting at a padded size class past 2^13 windows, in the
    single (k = 11) and pair (k = 19) key layouts."""
    from kmerset_tpu.ops import count as C

    rng = np.random.default_rng(500 + k)
    nw = C.good_sort_size(8192 + 100)
    codes = rng.integers(0, 4, size=nw + k - 1, dtype=np.int32)
    valid = np.ones(codes.size, dtype=bool)
    valid[-(k - 1):] = False

    uniq, counts, n_unique = C.count_kmers(codes, valid, k, True)
    n = int(n_unique)
    w = kc.canonical(kc.kmers_from_codes(codes.astype(np.int64), k), k)
    hu, hc = np.unique(w, return_counts=True)
    np.testing.assert_array_equal(np.asarray(uniq)[:n], hu)
    np.testing.assert_array_equal(np.asarray(counts)[:n], hc)

    uniq2, n_kept, n_cut = C.count_to_set(codes, valid, k, True, 2)
    expected = hu[hc >= 2]
    np.testing.assert_array_equal(np.asarray(uniq2)[: int(n_kept)], expected)
    assert int(n_cut) == hu.shape[0] - expected.shape[0]


def test_mesh_count_keys_only_skips_counts(monkeypatch):
    """need_counts=False returns (uniq, None) with identical keys — the
    decode direction's gather saver (review finding, round 3)."""
    from kmerset_tpu.parallel import driver

    rng = np.random.default_rng(33)
    codes = rng.integers(0, 4, 6000).astype(np.int32)
    offsets = np.array([0, 6000], dtype=np.int64)
    full = driver.mesh_count(codes, offsets, 11, True)
    keys = driver.mesh_count(codes, offsets, 11, True, need_counts=False)
    assert full is not None and keys is not None
    assert keys[1] is None
    np.testing.assert_array_equal(keys[0], full[0])


def test_mesh_env_capacity_malformed_warns(monkeypatch, caplog):
    """A malformed KMERSET_TPU_MESH_CAPACITY must degrade to defaults
    with a warning, not silently disable the mesh backend."""
    from kmerset_tpu.parallel import driver

    monkeypatch.setenv("KMERSET_TPU_MESH_CAPACITY", "8,192")
    with caplog.at_level("WARNING", logger="kmerset"):
        assert driver._mesh_env_capacity() is None
    assert any("KMERSET_TPU_MESH_CAPACITY" in r.message for r in caplog.records)
    rng = np.random.default_rng(34)
    codes = rng.integers(0, 4, 3000).astype(np.int32)
    offsets = np.array([0, 3000], dtype=np.int64)
    got = driver.mesh_count(codes, offsets, 9, True)  # still works
    assert got is not None


def test_mesh_fallback_counts(monkeypatch):
    """Mesh router failures must increment backend.FALLBACK_COUNT —
    a dead multi-device path cannot masquerade as a host-speed
    regression (review finding, round 3)."""
    from kmerset_tpu.ops import backend
    from kmerset_tpu.parallel import driver

    def boom(*a, **kw):
        raise RuntimeError("dead device link")

    monkeypatch.setattr(driver, "_stride_global", boom)
    before = backend.FALLBACK_COUNT
    codes = np.zeros(3000, dtype=np.int32)
    offsets = np.array([0, 3000], dtype=np.int64)
    assert driver.mesh_count(codes, offsets, 9, True) is None
    assert backend.FALLBACK_COUNT == before + 1


def test_should_use_mesh_refuses_slow_link(monkeypatch):
    """On a slow link the counting output gather dominates at any size;
    only the forced mode routes to the mesh."""
    from kmerset_tpu.ops import backend
    from kmerset_tpu.parallel import driver

    monkeypatch.setattr(driver, "_mesh_available", lambda: None)
    monkeypatch.setattr(backend, "_slow_link", lambda: True)
    assert not driver.should_use_mesh(backend.MAX_DEVICE_WINDOWS * 2)
    monkeypatch.setattr(backend, "_slow_link", lambda: False)
    assert driver.should_use_mesh(backend.MAX_DEVICE_WINDOWS * 2)


def test_maybe_init_distributed_malformed_spec(monkeypatch):
    from kmerset_tpu.parallel import driver

    monkeypatch.setenv("KMERSET_TPU_DISTRIBUTED", "host:1234,4")
    with pytest.raises(ValueError, match="KMERSET_TPU_DISTRIBUTED"):
        driver.maybe_init_distributed()


def test_slow_link_probe_failure_not_persisted(monkeypatch):
    """A probe failure is a 'slow' verdict held in this process only: a
    process that probes again sees the link."""
    from kmerset_tpu.ops import backend

    monkeypatch.setattr(backend, "_link_slow", None)
    monkeypatch.delenv("KMERSET_TPU_LINK", raising=False)
    monkeypatch.setattr(backend, "_backend_alive", lambda: True)

    import jax as _jax

    real_jit = _jax.jit

    def bad_jit(*a, **kw):
        raise RuntimeError("device busy")

    monkeypatch.setattr(_jax, "jit", bad_jit)
    assert backend._slow_link() is True
    monkeypatch.setattr(_jax, "jit", real_jit)
    monkeypatch.setattr(backend, "_link_slow", None)
    assert backend._slow_link() is False  # the in-process CPU "link"


def test_size_device_windows_static_below_ceiling(monkeypatch):
    """Counts up to the static ceiling, and every count on the CPU
    backend, use the module values and compile nothing."""
    from kmerset_tpu.ops import backend

    def no_probe(k):
        raise AssertionError("probed")

    monkeypatch.setattr(backend, "count_bytes_per_window", no_probe)
    monkeypatch.setattr(backend, "_sized_windows", {})
    static = (backend.MAX_DEVICE_WINDOWS, backend.CHUNK_WINDOWS)
    assert backend.size_device_windows(backend.MAX_DEVICE_WINDOWS + 1, 15) == static
    monkeypatch.setattr(backend, "_cpu_backend", lambda: False)
    assert backend.size_device_windows(0) == static
    assert backend.size_device_windows(backend.MAX_DEVICE_WINDOWS, 23) == static
    assert not backend.should_use_device_chunked(backend.MAX_DEVICE_WINDOWS, 31)


def test_size_device_windows_probes_layout_once(monkeypatch):
    """Past the static ceiling on a device, the ceiling comes from the
    card's byte limit over the bytes per window of k's layout only,
    probed once per layout; the chunk is a power of two at most half."""
    import jax

    from kmerset_tpu.ops import backend

    class Card:
        def memory_stats(self):
            return {"bytes_limit": 40 << 30}

    probed = []

    def per_window(k):
        probed.append(k)
        return {15: 20.0, 23: 30.0, 31: 40.0}[k]

    monkeypatch.setattr(backend, "_cpu_backend", lambda: False)
    monkeypatch.setattr(jax, "devices", lambda *a: [Card()])
    monkeypatch.setattr(backend, "count_bytes_per_window", per_window)
    monkeypatch.setattr(backend, "_sized_windows", {})
    n = backend.MAX_DEVICE_WINDOWS + 1
    one, chunk = backend.size_device_windows(n, 19)
    assert probed == [23]
    assert one == int(0.9 * (40 << 30) / (1.5 * 30.0))
    assert chunk & (chunk - 1) == 0 and chunk <= one // 2 < 2 * chunk
    assert backend.size_device_windows(n, 21) == (one, chunk) and probed == [23]
    assert backend.size_device_windows(n, 11)[0] == min(
        int(0.9 * (40 << 30) / (1.5 * 20.0)), backend._WINDOWS_CAP
    )
    assert probed == [23, 15]
    backend.size_device_windows(n)  # any k: the pair and int64 layouts
    assert probed == [23, 15, 23, 31]


def test_count_bytes_per_window_from_memory_analysis():
    """XLA's memory analysis of the count program gives a positive,
    finite footprint per window (the sizing's input)."""
    from kmerset_tpu.ops import backend

    b = backend.count_bytes_per_window(15)
    assert 1.0 < b < 1e4
