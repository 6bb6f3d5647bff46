"""KmerSetSet: joint compression of many related k-mer sets.

Mirrors the reference KmerSetSet (reference: lib/core/kmer_set_set.h:89-625)
and KmerSetSetReader (kmer_set_set.h:627-775): repeatedly factor out the
intersection of the most similar pair of sets into a new shared child set,
recording the parent->child DAG, so each original set is reconstructed as
the union of its residual and all reachable descendants.

Differences by design:
- pair similarity uses sampled-bucket sketches exactly like the reference
  (2% of buckets), but the bucket sample is drawn from a seeded generator —
  the reference's unseeded sampling (reference: lib/core/random.h:17)
  makes its output nondeterministic run-to-run;
- set algebra and sketch intersections are sorted-array merges instead of
  hash buckets.

The directory format is byte-compatible: meta.<ext> holds the serialized
adjacency list and the set count; <i>.<ext> holds each compact set
(reference: kmer_set_set.h:459-530).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Tuple

import numpy as np

from . import io as core_io
from . import native
from .config import KConfig
from .kmer_set import KmerSet, intersection_size
from .kmer_set_compact import KmerSetCompact

logger = logging.getLogger("kmerset")


def reachable_ids(children: Dict[int, List[int]], i: int) -> List[int]:
    """BFS over the children DAG from i, in first-seen order — the
    reconstruction set walk shared by KmerSetSet.get and the Reader
    (reference: lib/core/kmer_set_set.h:433-454, 672-694)."""
    from collections import deque

    ids: List[int] = []
    seen = set()
    queue = deque([i])
    while queue:
        cur = queue.popleft()
        if cur in seen:
            continue
        seen.add(cur)
        ids.append(cur)
        queue.extend(children.get(cur, []))
    return ids

AdjacencyList = Dict[int, List[int]]


def _pop_best_pair(heap, weights):
    """Max-weight pair via the lazy-deletion heap: pops entries until one
    matches the live `weights` value (stale entries — superseded updates —
    are discarded), returning None when the max weight is 0 (the greedy
    loop's termination, reference: lib/core/kmer_set_set.h:318-322).  The
    (-w, pair) order makes ties break on the smallest pair, exactly the
    full-scan argmax the reference computes each round
    (lib/core/kmer_set_set.h:308-316) at O(log P) amortized instead of
    O(P)."""
    import heapq

    while heap:
        negw, pair = heapq.heappop(heap)
        if weights.get(pair) == -negw:
            if negw < 0:  # all-zero weights end the loop
                return pair
            break
    return None


class _HostWeightOracle:
    """Pairwise sketch-intersection sizes, host sorted-merge."""

    def __init__(self, sketches: List[np.ndarray]):
        self.sketches = list(sketches)

    def append(self, sketch: np.ndarray) -> None:
        self.sketches.append(sketch)

    def replace(self, i: int, sketch: np.ndarray) -> None:
        self.sketches[i] = sketch

    def batch(self, pairs: List[Tuple[int, int]]) -> np.ndarray:
        return np.fromiter(
            (
                intersection_size(self.sketches[i], self.sketches[j])
                for i, j in pairs
            ),
            dtype=np.int64,
            count=len(pairs),
        )


class _DeviceWeightOracle:
    """Pairwise sketch-intersection sizes on the accelerator
    (ops/sketch.DeviceSketchTable): one row-wise sort answers a whole
    batch of pairs, replacing the reference's thread-pool of sorted-vector
    merges (reference: lib/core/kmer_set_set.h:189-219)."""

    def __init__(self, sketches: List[np.ndarray]):
        from ..ops.sketch import DeviceSketchTable

        self.table = DeviceSketchTable(sketches)

    def append(self, sketch: np.ndarray) -> None:
        self.table.append_row(sketch)

    def replace(self, i: int, sketch: np.ndarray) -> None:
        self.table.set_row(i, sketch)

    def batch(self, pairs: List[Tuple[int, int]]) -> np.ndarray:
        return self.table.pair_weights(pairs)


class _MeshWeightOracle:
    """Pairwise sketch weights over a multi-device mesh
    (ops/sketch.MeshSketchTable): sketches are key-range sharded, each
    device intersects its range locally and sizes are psum'd — the
    similarity phase of a compress run whose sketches exceed one chip."""

    def __init__(self, sketches: List[np.ndarray], k: int):
        from ..ops.sketch import MeshSketchTable

        self.table = MeshSketchTable(sketches, k)

    def append(self, sketch: np.ndarray) -> None:
        self.table.append_row(sketch)

    def replace(self, i: int, sketch: np.ndarray) -> None:
        self.table.set_row(i, sketch)

    def batch(self, pairs: List[Tuple[int, int]]) -> np.ndarray:
        return self.table.pair_weights(pairs)


def _make_weight_oracle(sketches: List[np.ndarray], n_inputs: int, k: int):
    from ..ops import backend
    from ..parallel import driver

    total = sum(s.shape[0] for s in sketches)
    work = n_inputs * max(1, total) // 2
    # The all-pairs phase does ~n_inputs * total merge work; offload when
    # that is large enough to amortize transfers and compiles.  With more
    # than one device attached, the key-range-sharded mesh table scales
    # the same phase across chips (production wiring of SURVEY §5.8).
    force = os.environ.get("KMERSET_TPU_FORCE_BACKEND", "")
    if force == "mesh" or (force != "host" and driver.should_use_mesh(work)):
        try:
            return _MeshWeightOracle(sketches, k)
        except Exception as e:  # noqa: BLE001 - fall back on the CPU backend
            # Visible, especially under an explicit force: a silently
            # degraded oracle looks like a mesh perf regression.
            backend._note_fallback("mesh_weight_oracle", e)
            logger.warning("mesh weight oracle unavailable (%r); host path", e)
    # `work` is a merge-work proxy, not a device-resident window count:
    # should_use_device's MAX_DEVICE_WINDOWS ceiling models the counting
    # program's device footprint and must not veto the sketch oracle for
    # the largest multi-set runs (the oracle's memory is the sketch table,
    # bounded separately), so clamp the proxy below the ceiling.
    if force != "host" and backend.should_use_device(
        min(work, backend.MAX_DEVICE_WINDOWS)
    ):
        try:
            return _DeviceWeightOracle(sketches)
        except Exception as e:  # noqa: BLE001 - fall back on the CPU backend
            backend._note_fallback("device_weight_oracle", e)
            logger.warning(
                "device weight oracle unavailable (%r); host path", e
            )
    return _HostWeightOracle(sketches)


def _parallel_map(fn, items, workers: int) -> list:
    """ex.map-or-sequential over independent items — the one-task-per-
    item pool shape the reference uses for its file/build fan-outs
    (kmer_set_set.h:494-528,583-607,704-745).  Results in item order;
    the first exception propagates either way."""
    items = list(items)
    if workers > 1 and len(items) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=workers) as ex:
            return list(ex.map(fn, items))
    return [fn(it) for it in items]


def serialize_adjacency_list(adj: AdjacencyList) -> str:
    """Exact reference format: "size key count children ..."
    (reference: kmer_set_set.h:45-56).  Keys emitted in sorted order (the
    reference emits hash order; its reader accepts any order)."""
    parts = [str(len(adj))]
    for key in sorted(adj):
        parts.append(str(key))
        parts.append(str(len(adj[key])))
        parts.extend(str(v) for v in adj[key])
    return " ".join(parts)


def deserialize_adjacency_list(s: str) -> AdjacencyList:
    """Inverse (reference: kmer_set_set.h:58-85)."""
    tokens = s.split()
    it = iter(tokens)
    size = int(next(it))
    adj: AdjacencyList = {}
    for _ in range(size):
        key = int(next(it))
        count = int(next(it))
        adj[key] = [int(next(it)) for _ in range(count)]
    return adj


class KmerSetSet:
    def __init__(
        self,
        kmer_sets_compact: List[KmerSetCompact],
        canonical: bool,
        config: KConfig,
        seed: int = 0,
        workers: int = 1,
        _children: AdjacencyList | None = None,
    ):
        """workers > 1 parallelizes the stopping-rule weight sweeps'
        deferred SPSS builds (each build is an independent pure
        function of its k-mer array, so the pool changes only when the
        work happens; output is byte-identical).  The reference runs
        its whole greedy loop on one thread (kmer_set_set.h:109-427)."""
        self.config = config
        self.canonical = canonical
        if _children is not None:
            self.children_: AdjacencyList = _children
            self.kmer_sets_compact_ = kmer_sets_compact
            return
        self.children_ = {}
        self.kmer_sets_compact_ = list(kmer_sets_compact)
        self._compress(canonical, seed, workers)

    # -- the greedy factor loop (reference: kmer_set_set.h:109-427) --------

    def _compress(self, canonical: bool, seed: int, workers: int = 1) -> None:
        cfg = self.config
        sets = self.kmer_sets_compact_
        n_inputs = len(sets)
        if n_inputs == 0:
            return

        # ~2% of buckets sampled (reference: kmer_set_set.h:120-128,
        # via GetRandomInts(unique, sorted) — core/random.h:13; seeded
        # here, fixing the reference's run-to-run nondeterminism).
        from ..utils.random import get_random_ints

        n_sample = max(1, cfg.n_buckets // 50)
        rng = np.random.default_rng(seed)
        bucket_ids = get_random_ints(
            n_sample, True, True, 0, cfg.n_buckets - 1, rng
        )

        sampled: List[np.ndarray] = [
            s.sampled_kmers(cfg, bucket_ids, canonical) for s in sets
        ]
        # Input sets stay resident through the whole loop: hold their
        # strings 2-bit packed (the reference's in-memory density,
        # kmer_set_compact.h:339-347) — consumers unpack per phase.
        for s in sets:
            s.pack_in_memory()
        oracle = _make_weight_oracle(sampled, n_inputs, cfg.k)

        all_pairs = [
            (i, j) for i in range(n_inputs) for j in range(i + 1, n_inputs)
        ]
        weights: Dict[Tuple[int, int], int] = dict(
            zip(all_pairs, oracle.batch(all_pairs).tolist())
        )
        # Lazy-deletion max-heap over (weight, pair): selection is
        # O(log P) amortized instead of a full O(P) dict scan per
        # iteration (reference scans its whole map each round,
        # lib/core/kmer_set_set.h:308-316 — quadratic-times-iterations at
        # the 1000-set scale the sharded config targets).  Entries are
        # validated against `weights` on pop; stale ones are discarded.
        import heapq

        heap = [(-w, p) for p, w in weights.items()]
        heapq.heapify(heap)

        # Stopping rule (reference: kmer_set_set.h:240-302).  The sweep
        # forces deferred SPSS builds — under workers > 1 in a thread
        # pool (independent builds; native inner loops release the
        # GIL) — and freshly built strings are packed to 2 bits/base
        # right after (weight then reads offsets only).
        def total_spss_weight() -> int:
            _parallel_map(
                lambda s: s.spss,
                [s for s in sets if s._pending is not None],
                workers,
            )
            w = sum(s.weight() for s in sets)
            for s in sets:
                s.pack_in_memory()
            return w

        total_weight = total_spss_weight()
        interval = n_inputs // 8 + 1
        improvement_threshold = 0.1 * interval / n_inputs

        it = 0
        while True:
            if it > 0 and it % interval == 0:
                updated = total_spss_weight()
                improvement = (total_weight - updated) / total_weight
                if improvement <= improvement_threshold:
                    break
                total_weight = updated
            it += 1

            # Max-weight pair; deterministic smallest-pair tie-break
            # ((-w, pair) heap order pops exactly the scan's choice).
            best_pair = _pop_best_pair(heap, weights)
            if best_pair is None:
                break
            j, k = best_pair

            n = len(sets)
            kj = sets[j].kmers(canonical)
            kk = sets[k].kmers(canonical)
            res = native.sorted_algebra(kj, kk)
            if res is not None:
                # One C merge pass (inputs are sorted-unique) instead of
                # numpy re-sorting concatenations three times.
                inter, kj2, kk2 = res
            else:
                inter = np.intersect1d(kj, kk, assume_unique=True)
                kj2 = np.setdiff1d(kj, inter, assume_unique=True)
                kk2 = np.setdiff1d(kk, inter, assume_unique=True)

            # Lazy: the SPSS build is deferred until the set's strings are
            # consumed (the stopping rule's weight sweep, or the final
            # dump).  Sets re-factored before then never pay the build —
            # in the mutated-strain configs the shared child of round t is
            # re-factored at round t+1, so eager construction (what the
            # reference does each round, lib/core/kmer_set_set.h:332-367)
            # spends most of its time on strings nobody reads.  Output is
            # byte-identical: construction is deterministic in the k-mer
            # array, and weight values are unchanged whenever queried.
            sets.append(
                KmerSetCompact.from_kmer_set(
                    KmerSet(cfg.k, inter, _sorted=True), canonical, lazy=True
                )
            )
            sets[j] = KmerSetCompact.from_kmer_set(
                KmerSet(cfg.k, kj2, _sorted=True), canonical, lazy=True
            )
            sets[k] = KmerSetCompact.from_kmer_set(
                KmerSet(cfg.k, kk2, _sorted=True), canonical, lazy=True
            )
            oracle.append(sets[n].sampled_kmers(cfg, bucket_ids, canonical))
            oracle.replace(j, sets[j].sampled_kmers(cfg, bucket_ids, canonical))
            oracle.replace(k, sets[k].sampled_kmers(cfg, bucket_ids, canonical))
            self.children_.setdefault(j, []).append(n)
            self.children_.setdefault(k, []).append(n)

            # Update weights of pairs touching j, k, n
            # (reference: kmer_set_set.h:382-425).
            touched: List[Tuple[int, int]] = []
            for l in range(n):
                if l != j:
                    touched.append((min(j, l), max(j, l)))
                if l != k:
                    touched.append((min(k, l), max(k, l)))
                touched.append((l, n))
            upd = dict(zip(touched, oracle.batch(touched).tolist()))
            weights.update(upd)
            for p, w in upd.items():
                heapq.heappush(heap, (-w, p))

    # -- queries (reference: kmer_set_set.h:429-454) -----------------------

    def size(self) -> int:
        return len(self.kmer_sets_compact_)

    def _reachable(self, i: int) -> List[int]:
        return reachable_ids(self.children_, i)

    def get(self, i: int, canonical: bool) -> KmerSet:
        """Original set = residual union all reachable shared children."""
        parts = [
            self.kmer_sets_compact_[j].kmers(canonical) for j in self._reachable(i)
        ]
        from .arrays import sorted_unique

        return KmerSet(self.config.k, sorted_unique(np.concatenate(parts)), _sorted=True)

    # -- persistence (reference: kmer_set_set.h:456-615) -------------------

    def dump(
        self, directory: str, compressor: str, extension: str,
        workers: int = 1,
    ) -> None:
        """Writes meta + one file per compact set; with workers > 1 the
        per-set dumps run as parallel tasks like the reference's
        one-task-per-file pool (reference: kmer_set_set.h:494-528; the
        first dump failure is re-raised after the pool drains, matching
        its collect-then-fail error handling)."""
        os.makedirs(directory, exist_ok=True)
        meta = [
            serialize_adjacency_list(self.children_),
            str(len(self.kmer_sets_compact_)),
        ]
        core_io.write_lines(
            os.path.join(directory, f"meta.{extension}"), compressor, meta
        )

        def _dump_one(i: int) -> None:
            self.kmer_sets_compact_[i].dump(
                os.path.join(directory, f"{i}.{extension}"), compressor
            )

        _parallel_map(_dump_one, range(len(self.kmer_sets_compact_)), workers)

    def dump_graph(self, file_name: str) -> None:
        """DOT format (reference: kmer_set_set.h:532-547)."""
        lines = ["digraph G {"]
        for key in sorted(self.children_):
            for child in self.children_[key]:
                lines.append(f"v{key} -> v{child}")
        lines.append("}")
        core_io.write_lines(file_name, "", lines)

    @classmethod
    def load(
        cls,
        config: KConfig,
        directory: str,
        decompressor: str,
        extension: str,
        canonical: bool,
        workers: int = 1,
    ) -> "KmerSetSet":
        """workers > 1 loads the per-set files as parallel tasks like
        the reference's one-task-per-file Load pool
        (kmer_set_set.h:583-607)."""
        meta = core_io.read_lines(
            os.path.join(directory, f"meta.{extension}"), decompressor
        )
        children = deserialize_adjacency_list(meta[0])
        n = int(meta[1])

        def _load_one(i: int) -> KmerSetCompact:
            return KmerSetCompact.load(
                config.k, os.path.join(directory, f"{i}.{extension}"), decompressor
            )

        sets = _parallel_map(_load_one, range(n), workers)
        return cls(sets, canonical, config, _children=children)


class KmerSetSetReader:
    """Reads meta only; loads just the files reachable from the requested
    set (reference: kmer_set_set.h:627-775)."""

    def __init__(
        self,
        config: KConfig,
        directory: str,
        extension: str,
        decompressor: str,
        canonical: bool,
        children: AdjacencyList,
        size: int,
    ):
        self.config = config
        self.directory = directory
        self.extension = extension
        self.decompressor = decompressor
        self.canonical = canonical
        self.children_ = children
        self._size = size

    @classmethod
    def from_directory(
        cls,
        config: KConfig,
        directory: str,
        extension: str,
        decompressor: str,
        canonical: bool,
    ) -> "KmerSetSetReader":
        meta = core_io.read_lines(
            os.path.join(directory, f"meta.{extension}"), decompressor
        )
        children = deserialize_adjacency_list(meta[0])
        size = int(meta[1])
        return cls(config, directory, extension, decompressor, canonical, children, size)

    def size(self) -> int:
        return self._size

    def get(self, i: int, workers: int = 1) -> KmerSet:
        ids = reachable_ids(self.children_, i)

        def _load(idx: int) -> np.ndarray:
            s = KmerSetCompact.load(
                self.config.k,
                os.path.join(self.directory, f"{idx}.{self.extension}"),
                self.decompressor,
            )
            return s.kmers(self.canonical)

        # Parallel load of the reachable files (reference grows a worker
        # pool per reachable id, kmer_set_set.h:704-745).
        parts = _parallel_map(_load, ids, workers)
        from .arrays import sorted_unique

        return KmerSet(
            self.config.k, sorted_unique(np.concatenate(parts)), _sorted=True
        )

    def get_all(self, workers: int = 1):
        """Yields (i, KmerSet) for every managed original set, loading
        and decoding each reachable child file exactly ONCE across the
        whole sweep.  The reference's Reader re-loads shared children on
        every Get (kmer_set_set.h:704-745) — quadratic re-decode when
        one shared core feeds every original; here cached child arrays
        are released as soon as no later original needs them, so peak
        memory is bounded by the live shared cores.  Each yielded set is
        identical to get(i)."""
        from .arrays import sorted_unique

        n = self._size
        reach = [reachable_ids(self.children_, i) for i in range(n)]
        uses: Dict[int, int] = {}
        for ids in reach:
            for j in ids:
                uses[j] = uses.get(j, 0) + 1

        def _load(idx: int) -> np.ndarray:
            s = KmerSetCompact.load(
                self.config.k,
                os.path.join(self.directory, f"{idx}.{self.extension}"),
                self.decompressor,
            )
            return s.kmers(self.canonical)

        cache: Dict[int, np.ndarray] = {}
        for i in range(n):
            ids = reach[i]
            missing = [j for j in ids if j not in cache]
            for j, arr in zip(missing, _parallel_map(_load, missing, workers)):
                cache[j] = arr
            parts = [cache[j] for j in ids]
            for j in ids:
                uses[j] -= 1
                if uses[j] == 0:
                    del cache[j]
            yield i, KmerSet(
                self.config.k,
                sorted_unique(np.concatenate(parts)),
                _sorted=True,
            )
