"""SPSS construction: unitigs + greedy path cover, fully vectorized.

Re-designs the reference's spss.h (reference: lib/core/spss.h, 1942 lines of
hash lookups, lock-based greedy matching, and sequential pointer walks) as
array programs:

- neighbor/degree discovery: 8 vectorized binary searches per k-mer into the
  sorted set (replacing 8 hash Contains() per k-mer,
  reference: lib/core/spss.h:238-273);
- unitig path extraction: pointer doubling over an oriented successor array
  (replacing FindPath walks, reference: lib/core/spss.h:394-423);
- greedy path cover: deterministic handshake matching over node ports
  (replacing try_lock greedy, reference: lib/core/spss.h:1445-1498);
- cycle breaking: min-label election fused into pointer doubling
  (replacing union-find, reference: lib/core/spss.h:1541-1647).

Orientation convention for the bidirected (canonical) graphs: an oriented
node id u encodes (entity << 1) | o where o=0 means "read forward, exit the
right side" and o=1 means "read reverse-complemented, exit the left side".
The mirror of u is u ^ 1.  Directed (non-canonical) graphs use plain entity
ids with no orientation bit (`oriented=False` below).

The output is only required to be a valid SPSS of the input set (every
k-mer appears exactly once across all strings and reconstruction equals the
input — the invariants pinned by the reference's tests,
reference: test/spss.cc:33-124); exact strings may differ from the
reference, whose results are thread-interleaving-dependent anyway.
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager
from typing import List, Tuple

import numpy as np

from . import kmer as kmer_ops
from . import native
from .graph import (
    expand_ranges,
    filter_groups as _filter_groups,
    handshake_matching,
    led_group_selection,
    permute_groups as _permute_groups,
    pointer_double,
)
from .kmer_set import KmerSet
from .strings import PackedStrings

logger = logging.getLogger("kmerset")


@contextmanager
def _phase(name: str):
    """Debug-level phase timing, mirroring the reference's debug-log
    narration of algorithm phases (reference: lib/core/spss.h:315-353)."""
    t0 = time.perf_counter()
    yield
    logger.debug("%s: %.2fs", name, time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# Neighbor tables
# ---------------------------------------------------------------------------


def _lookup(A: np.ndarray, q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(found, index) of queries in sorted-unique A."""
    if A.shape[0] == 0:
        return np.zeros(q.shape, bool), np.zeros(q.shape, np.int64)
    idx = np.searchsorted(A, q)
    idx_c = np.minimum(idx, A.shape[0] - 1)
    found = A[idx_c] == q
    return found, idx_c


def _side_table_canonical(A: np.ndarray, k: int, right: bool):
    """Degree / unique-neighbor tables for one side of every canonical k-mer.

    For the right side, candidates are next(x, c); for the left, prev(x, c).
    The stored neighbor is canonical(candidate); the edge exists iff that
    canonical form is in the set and differs from x; is_same_side is true
    iff the candidate itself was not canonical
    (reference: lib/core/spss.h:238-273, unified over the next /
    next.Complement() branches — for odd k exactly one of the pair is
    canonical, so each base extension yields at most one edge).
    """
    n = A.shape[0]
    deg = np.zeros(n, dtype=np.int64)
    nbr = np.zeros(n, dtype=np.int64)
    same = np.zeros(n, dtype=bool)
    for c in range(4):
        cand = kmer_ops.next_kmer(A, k, c) if right else kmer_ops.prev_kmer(A, k, c)
        ncan = kmer_ops.canonical(cand, k)
        found, idx = _lookup(A, ncan)
        found &= ncan != A
        first = found & (deg == 0)
        nbr = np.where(first, idx, nbr)
        same = np.where(first, cand != ncan, same)
        deg += found
    return deg, nbr, same


def _side_table_plain(A: np.ndarray, k: int, right: bool):
    """Directed-graph degree / unique-neighbor tables
    (reference: lib/core/spss.h:76-94)."""
    n = A.shape[0]
    deg = np.zeros(n, dtype=np.int64)
    nbr = np.zeros(n, dtype=np.int64)
    for c in range(4):
        cand = kmer_ops.next_kmer(A, k, c) if right else kmer_ops.prev_kmer(A, k, c)
        found, idx = _lookup(A, cand)
        found &= cand != A
        first = found & (deg == 0)
        nbr = np.where(first, idx, nbr)
        deg += found
    return deg, nbr


def _side_tables(A: np.ndarray, k: int, canonical: bool, resident=None):
    """Both side tables, on the accelerator for large sets (hot loop #2)
    with host fallback.  Returns ((rdeg, rnbr, rsame), (ldeg, lnbr, lsame));
    same-side flags are all-False in the directed (non-canonical) case.
    `resident` = validated device-resident mirror of A (count -> graph
    fusion; see get_unitigs_canonical)."""
    from ..ops import backend

    if resident is not None:
        # The handle only skips the upload when its lane layout matches
        # this call's consumer (int32 handles are canonical-k<=15 only).
        # A mismatched handle must not open the resident gate: the
        # device path would silently re-stage A — paying on a slow link
        # exactly the upload the gate's resident arm assumes away.
        want = np.int32 if (canonical and k <= 15) else np.int64
        try:
            if resident.graph_input().dtype != want:
                resident = None
        except Exception:  # noqa: BLE001 - dead handle: ignore it
            resident = None
    if backend.should_use_device_graph(
        A.shape[0], resident=resident is not None
    ):
        from ..ops import neighbors

        res = neighbors.device_side_tables(A, k, canonical, resident=resident)
        if res is not None:
            return res
    res = native.side_tables(A, k, canonical)
    if res is not None:
        if not canonical:
            # Directed graphs carry no same-side flags.
            (rd, rn, _), (ld, ln, _) = res
            zr = np.zeros(A.shape[0], dtype=bool)
            return (rd, rn, zr), (ld, ln, zr)
        return res
    if canonical:
        return (
            _side_table_canonical(A, k, right=True),
            _side_table_canonical(A, k, right=False),
        )
    zr = np.zeros(A.shape[0], dtype=bool)
    rdeg, rnbr = _side_table_plain(A, k, right=True)
    ldeg, lnbr = _side_table_plain(A, k, right=False)
    return (rdeg, rnbr, zr), (ldeg, lnbr, zr)


# ---------------------------------------------------------------------------
# Chain machinery (shared by the k-mer level and the unitig level)
# ---------------------------------------------------------------------------


def _entity_flip(nodes: np.ndarray, oriented: bool) -> Tuple[np.ndarray, np.ndarray]:
    if oriented:
        return nodes >> 1, (nodes & 1).astype(bool)
    return nodes, np.zeros(nodes.shape, dtype=bool)


def _keep_rule(A: np.ndarray, firsts, lasts):
    """The reference's canonical orientation tie-break: keep the chain
    whose start k-mer is >= its end k-mer (lib/core/spss.h:511,555).
    ONE definition for the native-callback, numpy-fallback, and mesh
    paths — the byte-parity of every backend hangs on the three sites
    applying the identical predicate.  Works elementwise on arrays and
    on scalar node ids."""
    return A[firsts >> 1] >= A[lasts >> 1]


def _chains_grouped(
    succ: np.ndarray, starts: np.ndarray, oriented: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """Groups the nodes of the chains led by `starts` contiguously in
    (chain, position) order; returns (nodes, group_starts).

    Native path: a sequential C pointer chase, O(total chain length)
    (native/kmerio.c kmerio_chain_walk — the data-parallel equivalent of
    the reference's threaded walks, lib/core/spss.h:394-423).  Fallback:
    pointer doubling + lexsort (log-depth, used when the native library is
    unbuilt).  Group order may differ between the two paths; both are
    valid chain groupings of the same chains.  `oriented` marks a
    2-nodes-per-entity succ so the mesh gate compares ENTITY counts
    (the convention every other phase uses).
    """
    if starts.size == 0:
        return np.empty(0, np.int64), np.zeros(1, np.int64)
    from ..parallel import driver as mesh_driver

    n_ents = succ.shape[0] >> 1 if oriented else succ.shape[0]
    if mesh_driver.should_use_mesh_graph(n_ents):
        res = mesh_driver.mesh_chain_group(succ, starts)
        if res is not None:
            return res
    res = native.chain_walk(succ, starts)
    if res is not None:
        return res
    end, dist, is_chain, _ = pointer_double(succ)
    keep_end = np.zeros(succ.shape[0], dtype=bool)
    keep_end[end[starts]] = True
    sel = np.flatnonzero(is_chain & keep_end[end])
    if sel.size == 0:
        return sel, np.zeros(1, np.int64)
    order = np.lexsort((-dist[sel], end[sel]))
    nodes_sorted = sel[order]
    ends_sorted = end[nodes_sorted]
    boundaries = np.flatnonzero(np.diff(ends_sorted)) + 1
    group_starts = np.concatenate(
        ([0], boundaries, [nodes_sorted.shape[0]])
    ).astype(np.int64)
    return nodes_sorted, group_starts


def _group_endpoints(
    nodes: np.ndarray, groups: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(first, last, nonempty) node of every chain group; first/last are 0
    where a group is empty."""
    counts = np.diff(groups)
    nonempty = counts > 0
    lo = np.where(nonempty, groups[:-1], 0)
    hi = np.where(nonempty, groups[1:] - 1, 0)
    return nodes[lo], nodes[hi], nonempty


def _kept_native_order(
    A: np.ndarray,
    succ: np.ndarray,
    starts: np.ndarray,
    nodes: np.ndarray,
    groups: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray | None]:
    """Shared parity-critical block of the mesh chain emitters: applies
    the canonical orientation keep rule (A[first] >= A[last], the
    reference tie-break, lib/core/spss.h:511,555) and reconstructs
    native/kmerio.c::kmerio_chain_pairs' 64-lane batched emission order
    — the winner of each mirror pair is the lower-positioned start, and
    within a 64-wide batch records land in (chain length, lane) order
    because shorter walks finish earlier.  Returns
    (keep, nodes_kept, groups_kept, order); order is None when fewer
    than two groups survive (nothing to reorder)."""
    firsts, lasts, nonempty = _group_endpoints(nodes, groups)
    keep = nonempty & _keep_rule(A, firsts, lasts)
    nodes_k, groups_k = _filter_groups(nodes, groups, keep)
    if groups_k.shape[0] <= 1:
        return keep, nodes_k, groups_k, None
    fk, lk, _ = _group_endpoints(nodes_k, groups_k)
    pos = np.full(succ.shape[0], np.int64(1) << 60, dtype=np.int64)
    pos[starts] = np.arange(starts.size, dtype=np.int64)
    minpos = np.minimum(pos[fk], pos[lk ^ 1])
    lens = np.diff(groups_k)
    order = np.lexsort((minpos & 63, lens, minpos >> 6))
    return keep, nodes_k, groups_k, order


def _oriented_kmers(A: np.ndarray, k: int, entity: np.ndarray, flip: np.ndarray) -> np.ndarray:
    vals = A[entity]
    rc = kmer_ops.reverse_complement(vals, k)
    return np.where(flip, rc, vals)


def _emit_kmer_chains(
    A: np.ndarray,
    k: int,
    nodes_sorted: np.ndarray,
    group_starts: np.ndarray,
    oriented: bool,
) -> PackedStrings:
    """Builds unitig strings from chain-grouped nodes: the first node of a
    chain contributes k bases, every following node one base
    (reference ConcatenateKmers, lib/core/spss.h:25-41)."""
    n_chains = group_starts.shape[0] - 1
    if nodes_sorted.size == 0:
        return PackedStrings.empty()
    res = native.emit_kmer_chains(A, k, nodes_sorted, group_starts, oriented)
    if res is not None:
        return PackedStrings(res[0], res[1])
    counts = np.diff(group_starts)
    nonempty = counts > 0
    # Empty groups emit length-0 strings, matching the native binding's
    # documented contract (core/native.py emit_kmer_chains); the old
    # unconditional counts + k - 1 gave an empty group k-1 garbage bytes.
    str_lens = np.where(nonempty, counts + k - 1, 0)
    offsets = np.zeros(n_chains + 1, dtype=np.int64)
    np.cumsum(str_lens, out=offsets[1:])
    codes = np.zeros(int(offsets[-1]), dtype=np.uint8)

    entity, flip = _entity_flip(nodes_sorted, oriented)
    ov = _oriented_kmers(A, k, entity, flip)
    group_of = np.repeat(np.arange(n_chains, dtype=np.int64), counts)
    t = np.arange(nodes_sorted.shape[0], dtype=np.int64) - group_starts[group_of]

    first_vals = ov[group_starts[:-1][nonempty]]
    codes_first = kmer_ops.codes_from_kmer(first_vals, k)  # (n_nonempty, k)
    first_pos = offsets[:-1][nonempty, None] + np.arange(k)
    codes[first_pos.ravel()] = codes_first.ravel().astype(np.uint8)

    rest = t > 0
    pos = offsets[group_of[rest]] + k - 1 + t[rest]
    codes[pos] = (ov[rest] & 3).astype(np.uint8)
    return PackedStrings(codes, offsets)


def _mesh_emit_ordered(
    A: np.ndarray,
    k: int,
    succ: np.ndarray,
    starts: np.ndarray,
    oriented: bool,
    pd=None,
) -> Tuple[PackedStrings, np.ndarray] | None:
    """Distributed chain grouping + on-device string emission
    (parallel/driver.mesh_emit_chains), selected and ordered by `starts`
    exactly like mesh_chain_group + _emit_kmer_chains — but the base
    codes are rendered on the mesh, so the host never gathers through A.
    Returns (strings, kept chain nodes) or None (callers fall back)."""
    from ..parallel import driver as mesh_driver

    res = mesh_driver.mesh_emit_chains(A, k, succ, starts, oriented, pd=pd)
    if res is None:
        return None
    nodes, groups, codes, str_offsets = res
    sel = led_group_selection(nodes, groups, starts, succ.shape[0])
    if sel is None:
        return None  # unexpected topology; use the host walk
    led, nodes_k, _groups_k, order = sel
    ps = _take_strings(
        PackedStrings(codes, str_offsets), np.flatnonzero(led)[order]
    )
    return ps, nodes_k


def _mesh_chain_walk_kept_emit(
    A: np.ndarray, k: int, succ: np.ndarray, starts: np.ndarray, pd=None
) -> Tuple[PackedStrings, np.ndarray] | None:
    """Distributed form of the canonical unitig walk WITH on-device
    emission: groups and renders every chain on the mesh
    (driver.mesh_emit_chains), applies the orientation skip rule
    (reference: lib/core/spss.h:511,555) per string group, and reorders
    to the native mirror-dedup emission order (_mesh_chain_walk_kept's
    rule) so the bytes match the host backends exactly.  Returns
    (strings, kept chain nodes) or None."""
    from ..parallel import driver as mesh_driver

    res = mesh_driver.mesh_emit_chains(A, k, succ, starts, oriented=True, pd=pd)
    if res is None:
        return None
    nodes, groups, codes, str_offsets = res
    # Same led-by-starts topology guard as mesh_chain_group /
    # _mesh_emit_ordered: every group must begin at one of the requested
    # starts (chains are node-disjoint, so firsts are chain origins) or
    # the keep rule below would judge the wrong endpoint — fall back to
    # the host walk instead of silently emitting from a foreign origin.
    in_starts = np.zeros(succ.shape[0], dtype=bool)
    in_starts[starts] = True
    # Empty groups are checked FIRST (short-circuit): a trailing empty
    # group would make nodes[groups[:-1]] index past the end — fall back
    # instead of crashing (same clamp contract as led_group_selection).
    if (
        groups.shape[0] - 1 != starts.size
        or (np.diff(groups) <= 0).any()
        or not in_starts[nodes[groups[:-1]]].all()
    ):
        return None  # unexpected topology; use the host walk
    ps = PackedStrings(codes, str_offsets)
    keep, nodes_k, _groups_k, order = _kept_native_order(
        A, succ, starts, nodes, groups
    )
    keep_idx = np.flatnonzero(keep)
    if order is None:
        return _take_strings(ps, keep_idx), nodes_k
    return _take_strings(ps, keep_idx[order]), nodes_k


def _mesh_walk_cycles(
    A: np.ndarray, k: int, succ: np.ndarray, visited: np.ndarray, oriented: bool
) -> PackedStrings | None:
    """Distributed leftover-cycle emission: min-node leader election via
    mesh pointer doubling picks each orbit's start (the reference scans
    entities ascending, so a cycle is entered at its minimum entity in
    orientation 0, lib/core/spss.h:583-612); cutting the start's
    predecessor edge turns every orbit into a chain, which the
    owner-routed grouping lays out in walk order.  Byte-identical to
    native.walk_cycles; returns None (host fallback) on inputs whose
    reference walk stops early — a visited entity inside an orbit, or a
    self-mirror orbit carrying both orientations of one entity."""
    from ..parallel import driver as mesh_driver

    n_nodes = succ.shape[0]
    res = mesh_driver.mesh_pointer_double(
        succ, np.arange(n_nodes, dtype=np.int64)
    )
    if res is None:
        return None
    _, _, is_chain, mins = res
    cyc = ~is_chain
    if not cyc.any():
        return PackedStrings.empty()
    cnodes = np.flatnonzero(cyc)
    ents = (cnodes >> 1) if oriented else cnodes
    if visited[ents].any():
        return None
    if oriented:
        key = mins[cnodes] * np.int64(n_nodes) + ents
        ks = np.sort(key)
        if ks.size > 1 and (ks[1:] == ks[:-1]).any():
            return None  # self-mirror orbit: partial-walk semantics
        starts = np.unique(mins[cnodes])
        starts = starts[starts % 2 == 0]
    else:
        starts = np.unique(mins[cnodes])
    if starts.size == 0:  # pragma: no cover - defensive
        return None
    succ2 = succ.copy()
    has_succ = np.flatnonzero(succ >= 0)
    pred = np.full(n_nodes, -1, dtype=np.int64)
    pred[succ[has_succ]] = has_succ
    pv = pred[starts]
    succ2[pv[pv >= 0]] = -1
    # One distributed doubling over the cut graph, shared by the emit
    # attempt and its grouping-only fallback (succ2 != succ, so the
    # orbit-discovery doubling above cannot be reused here).
    pd2 = mesh_driver.mesh_pointer_double(succ2)
    if pd2 is None:
        return None
    em = _mesh_emit_ordered(A, k, succ2, starts, oriented, pd=pd2)
    if em is not None:
        ps, nodes = em
        visited[(nodes >> 1) if oriented else nodes] = True
        return ps
    grouped = mesh_driver.mesh_chain_group(succ2, starts, pd=pd2)
    if grouped is None:
        return None
    nodes, groups = grouped
    visited[(nodes >> 1) if oriented else nodes] = True
    return _emit_kmer_chains(A, k, nodes, groups, oriented)


def _walk_cycles(
    A: np.ndarray, k: int, succ: np.ndarray, visited: np.ndarray, oriented: bool
) -> PackedStrings:
    """Sequential walk of leftover pure cycles, in ascending k-mer order,
    stopping at the first already-visited k-mer (reference:
    lib/core/spss.h:203-224,583-612).  Native one-pass C walk when the
    library is built (all-cycle worst-case inputs — circular plasmids,
    repeat-heavy genomes — run at chain-emission speed); the Python
    per-k-mer loop below is the byte-identical fallback."""
    from ..parallel import driver as mesh_driver

    if visited.all():
        # Chains + isolated k-mers covered every entity, so no orbit
        # exists and every backend would emit nothing — skip the scan
        # (on the mesh path this avoids a full distributed pointer
        # doubling whose only job was to discover there are no cycles).
        return PackedStrings.empty()
    # Gate on entity count like every other phase of the pipeline (the
    # oriented successor has 2 nodes per entity).
    n_ents = succ.shape[0] >> 1 if oriented else succ.shape[0]
    if mesh_driver.should_use_mesh_graph(n_ents):
        res = _mesh_walk_cycles(A, k, succ, visited, oriented)
        if res is not None:
            return res
    res = native.walk_cycles(succ, A, k, oriented, visited)
    if res is not None:
        codes, offsets = res
        return PackedStrings(codes, offsets)
    out: List[np.ndarray] = []
    for i0 in np.flatnonzero(~visited):
        if visited[i0]:
            continue
        u = 2 * int(i0) if oriented else int(i0)
        codes: List[int] = []
        first = True
        while True:
            ent = (u >> 1) if oriented else u
            if visited[ent]:
                break
            visited[ent] = True
            val = int(A[ent])
            if oriented and (u & 1):
                val = int(kmer_ops.reverse_complement(np.int64(val), k))
            if first:
                codes.extend(int(x) for x in kmer_ops.codes_from_kmer(np.int64(val), k))
                first = False
            else:
                codes.append(val & 3)
            u = int(succ[u])
        out.append(np.array(codes, dtype=np.uint8))
    return PackedStrings.from_code_lists(out)


def _concat_packed(parts: List[PackedStrings]) -> PackedStrings:
    parts = [p for p in parts if len(p) > 0]
    if not parts:
        return PackedStrings.empty()
    if len(parts) == 1:
        return parts[0]
    codes = np.concatenate([p.codes for p in parts])
    lens = np.concatenate([p.lengths() for p in parts])
    offsets = np.zeros(lens.shape[0] + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    return PackedStrings(codes, offsets)


# ---------------------------------------------------------------------------
# Unitigs
# ---------------------------------------------------------------------------


def _mesh_chain_walk_kept(
    A: np.ndarray, succ: np.ndarray, starts: np.ndarray, pd=None
) -> Tuple[np.ndarray, np.ndarray] | None:
    """Distributed form of native.chain_walk_kept: group every chain on
    the mesh (pointer doubling + owner-routed exchange), apply the
    orientation skip rule per group, and reorder to the exact emission
    order of the native mirror-dedup walk so the two backends stay
    byte-identical.

    Native order (native/kmerio.c kmerio_chain_pairs): starts are walked
    in 64-wide batches; a mirror pair is recorded at the first of its two
    starts to finish — both walks have equal length, so that is the
    lower-positioned start — and within a batch records land in (chain
    length, lane) order because shorter walks finish earlier.
    """
    from ..parallel import driver as mesh_driver

    grouped = mesh_driver.mesh_chain_group(succ, starts, pd=pd)
    if grouped is None:
        return None
    nodes, groups = grouped
    _keep, nodes_k, groups_k, order = _kept_native_order(
        A, succ, starts, nodes, groups
    )
    if order is None:
        return nodes_k, groups_k
    return _permute_groups(nodes_k, groups_k, order)


def get_unitigs_canonical(kmer_set: KmerSet) -> PackedStrings:
    """Maximal non-branching paths of the bidirected de Bruijn graph
    (reference: lib/core/spss.h:231-615).

    Requires odd k: even k admits palindromic k-mers (equal to their own
    reverse complement), which break the two-side bookkeeping — for odd k
    exactly one of each candidate/complement pair is canonical.  The
    reference has the same implicit contract (its CLIs dispatch only
    k in {15, 19, 23}, kmerset-build.cc:130-143).
    """
    A = kmer_set.kmers
    k = kmer_set.k
    if k % 2 == 0:
        raise ValueError(
            "canonical SPSS construction requires odd k (palindromic "
            f"k-mers exist for even k); got k={k}"
        )
    n = A.shape[0]
    if n == 0:
        return PackedStrings.empty()

    from ..ops import backend

    with _phase("unitigs: side tables + successor"):
        dev = None
        from ..parallel import driver as mesh_driver

        # Device-resident mirror from the counting phase (count -> graph
        # fusion): validated against the host array, it feeds the device
        # front-end with no upload, which opens the offload gate even on
        # slow links (ops/backend.should_use_device_graph resident arm).
        res_handle = kmer_set.device
        if res_handle is not None and not res_handle.valid_for(A, k):
            res_handle = None
        if mesh_driver.should_use_mesh_graph(n):
            # Multi-device front-end: sharded side tables + mate exchange +
            # successor assembly (parallel/mesh.sharded_unitig_succ_fn).
            dev = mesh_driver.mesh_unitig_succ(A, k)
        if dev is None and backend.should_use_device_graph(
            n, resident=res_handle is not None
        ):
            from ..ops import unitigs as dev_unitigs

            if backend._slow_link() and native.get_lib() is not None:
                # Slow-link wire format: 1 byte/k-mer side codes instead
                # of the 8-byte succ + 3 mask bytes; the host
                # rebuilds the identical succ with one fp probe per
                # non-terminal side (native kmerio_succ_from_sides).
                with _phase("unitigs: side-code fetch"):
                    sides = dev_unitigs.device_unitig_sides(
                        A, k, resident=res_handle
                    )
                if sides is not None:
                    with _phase("unitigs: succ rebuild"):
                        succ_b = native.succ_from_sides(A, sides, k)
                    if succ_b is not None:
                        term_r = (sides & 1).astype(bool)
                        term_l = (sides & 16).astype(bool)
                        dev = (succ_b, term_l, term_r, term_l & term_r)
            if dev is None:
                dev = dev_unitigs.device_unitig_succ(A, k, resident=res_handle)
        if dev is not None:
            # Fused device front-end: side tables + terminal tests + oriented
            # successor in one jit (ops/unitigs.py).
            succ, term_l, term_r, both = dev
        else:
            tables = _side_tables(A, k, canonical=True, resident=res_handle)
            fused = native.unitig_succ_from_tables(tables)
            if fused is not None:
                succ, term_l, term_r, both = fused
            else:
                (rdeg, rnbr, rsame), (ldeg, lnbr, lsame) = tables

                # Terminal tests (reference: lib/core/spss.h:276-313): a side
                # is terminal unless it has exactly one mate whose
                # corresponding side also has exactly one mate.
                mate_r = np.where(rsame, rdeg[rnbr], ldeg[rnbr])
                term_r = (rdeg != 1) | (mate_r != 1)
                mate_l = np.where(lsame, ldeg[lnbr], rdeg[lnbr])
                term_l = (ldeg != 1) | (mate_l != 1)

                # Oriented successor: u = 2i+0 exits right, u = 2i+1 exits
                # left.  After a same-side step the orientation flips
                # (reference FindPath, lib/core/spss.h:394-423).
                succ = np.empty(2 * n, dtype=np.int64)
                succ[0::2] = np.where(term_r, -1, 2 * rnbr + rsame)
                succ[1::2] = np.where(
                    term_l, -1, 2 * lnbr + (~lsame).astype(np.int64)
                )

                both = term_l & term_r
    with _phase("unitigs: chain walk"):
        starts_r_exit = np.flatnonzero(term_l & ~term_r) * 2
        starts_l_exit = np.flatnonzero(term_r & ~term_l) * 2 + 1
        starts = np.concatenate([starts_r_exit, starts_l_exit])

        # Each chain exists once per orientation; keep the one whose start
        # k-mer is >= its end k-mer (reference skip rule,
        # lib/core/spss.h:511,555).  Mesh path first (distributed pointer
        # doubling + owner-routed grouping — no sequential walk anywhere);
        # then the native fast path: measure all chains, apply the rule,
        # emit only winners (3n visits); fallback: walk everything and
        # filter.
        kept = None
        chains = None
        if mesh_driver.should_use_mesh_graph(n):
            # Fully distributed walk: grouping + base-code rendering both
            # happen on the mesh (one owner-routed exchange carrying values).
            # Pointer doubling runs once; the grouping-only fallback reuses
            # its (end, dist, is_chain) result instead of re-walking.  The
            # guards mirror the drivers' own early-outs, which used to skip
            # the doubling entirely.
            pd = (
                mesh_driver.mesh_pointer_double(succ)
                if 0 < starts.size and 0 < succ.shape[0] < (1 << 30)
                else None
            )
            if pd is not None:
                em = _mesh_chain_walk_kept_emit(A, k, succ, starts, pd=pd)
                if em is not None:
                    chains, nodes = em
                else:
                    kept = _mesh_chain_walk_kept(A, succ, starts, pd=pd)
        if chains is None:
            if kept is None:
                kept = native.chain_walk_kept(
                    succ, starts, lambda s, e: _keep_rule(A, s, e)
                )
            if kept is not None:
                nodes_kept, groups_kept = kept
                nodes = nodes_kept  # kept chains cover the same entities
            else:
                nodes, groups = _chains_grouped(succ, starts, oriented=True)
                firsts, lasts, nonempty = _group_endpoints(nodes, groups)
                keep = nonempty & _keep_rule(A, firsts, lasts)
                nodes_kept, groups_kept = _filter_groups(nodes, groups, keep)
    with _phase("unitigs: emission + cycles"):
        if chains is None:
            chains = _emit_kmer_chains(A, k, nodes_kept, groups_kept, oriented=True)

        parts: List[PackedStrings] = [chains]

        # Isolated k-mers (terminals on both sides), one string each
        # (reference: lib/core/spss.h:459-493).
        both_idx = np.flatnonzero(both)
        if both_idx.size:
            res = native.emit_kmer_chains(
                A,
                k,
                2 * both_idx,
                np.arange(both_idx.size + 1, dtype=np.int64),
                oriented=True,
            )
            if res is not None:
                parts.append(PackedStrings(res[0], res[1]))
            else:
                codes = kmer_ops.codes_from_kmer(A[both_idx], k).astype(np.uint8)
                offsets = np.arange(both_idx.size + 1, dtype=np.int64) * k
                parts.append(PackedStrings(codes.ravel(), offsets))

        # Non-branching loops (reference: lib/core/spss.h:583-612).  Every
        # entity on any walked chain is covered by a kept chain (kept chains
        # and their dropped mirrors visit the same k-mers).
        visited = np.zeros(n, dtype=bool)
        visited[nodes >> 1] = True
        visited[both_idx] = True
        parts.append(_walk_cycles(A, k, succ, visited, oriented=True))

    return _concat_packed(parts)


def get_unitigs(kmer_set: KmerSet) -> PackedStrings:
    """Maximal non-branching paths of the directed de Bruijn graph
    (reference: lib/core/spss.h:74-227)."""
    A = kmer_set.kmers
    k = kmer_set.k
    n = A.shape[0]
    if n == 0:
        return PackedStrings.empty()

    res_handle = kmer_set.device
    if res_handle is not None and not res_handle.valid_for(A, k):
        res_handle = None
    (outdeg, nxt, _), (indeg, prv, _) = _side_tables(
        A, k, canonical=False, resident=res_handle
    )

    # Start/end tests (reference: lib/core/spss.h:96-146).
    is_start = (indeg != 1) | (outdeg[prv] != 1)
    is_end = (outdeg != 1) | (indeg[nxt] != 1)

    succ = np.where(is_end, -1, nxt)
    starts = np.flatnonzero(is_start)

    from ..parallel import driver as mesh_driver

    chains = None
    if mesh_driver.should_use_mesh_graph(n):
        em = _mesh_emit_ordered(A, k, succ, starts, oriented=False)
        if em is not None:
            chains, nodes = em
    if chains is None:
        nodes, groups = _chains_grouped(succ, starts)
        chains = _emit_kmer_chains(A, k, nodes, groups, oriented=False)

    visited = np.zeros(n, dtype=bool)
    visited[nodes] = True
    cycles = _walk_cycles(A, k, succ, visited, oriented=False)
    return _concat_packed([chains, cycles])


# ---------------------------------------------------------------------------
# Greedy path cover over the unitig graph (SPSS proper)
# ---------------------------------------------------------------------------


def _candidate_port_edges_canonical(
    unitigs: PackedStrings, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """All (k-1)-overlap port edges of the bidirected unitig graph.

    Ports: 2i = right side of unitig i, 2i+1 = left side.  An edge between
    ports p, q means the two sides can be glued with k-1 overlap
    (reference GetEdgesRight/GetEdgesLeft, lib/core/spss.h:1057-1145).
    The reference looks candidates up in hash multimaps of unitig
    prefixes/suffixes (lib/core/spss.h:619-695); here it is a sorted join.
    Returned deduplicated, ordered by first-discovery priority.
    """
    n = len(unitigs)
    with _phase("spss: first/last kmers"):
        P = unitigs.first_kmers(k)
        S = unitigs.last_kmers(k)

    from ..parallel import driver as mesh_driver

    if mesh_driver.should_use_mesh_graph(n):
        res = mesh_driver.mesh_overlap_edges(P, S, k)
        if res is not None:
            a, b = res
            return _dedup_port_edges(a, b, n)
    with _phase("spss: overlap join"):
        res = native.overlap_edges(P, S, k)
    if res is not None:
        a, b = res
        with _phase("spss: edge dedup"):
            return _dedup_port_edges(a, b, n)

    p_order = np.argsort(P, kind="stable")
    s_order = np.argsort(S, kind="stable")
    P_sorted, S_sorted = P[p_order], S[s_order]

    all_a: List[np.ndarray] = []
    all_b: List[np.ndarray] = []

    def _join(queries, sorted_vals, order, src_ports, dst_side_bit):
        lo = np.searchsorted(sorted_vals, queries, side="left")
        hi = np.searchsorted(sorted_vals, queries, side="right")
        rows, idx = expand_ranges(lo, hi)
        j = order[idx]
        a = src_ports[rows]
        b = 2 * j + dst_side_bit
        ok = (a >> 1) != j
        all_a.append(a[ok])
        all_b.append(b[ok])

    ar = np.arange(n, dtype=np.int64)
    for c in range(4):
        q = kmer_ops.next_kmer(S, k, c)
        # right(i) -- left(j): suffix_next == prefix(j)
        _join(q, P_sorted, p_order, 2 * ar, 1)
        # right(i) -- right(j): revcomp(suffix_next) == suffix(j)
        _join(kmer_ops.reverse_complement(q, k), S_sorted, s_order, 2 * ar, 0)
    for c in range(4):
        r = kmer_ops.prev_kmer(P, k, c)
        # left(i) -- right(j): prefix_prev == suffix(j)
        _join(r, S_sorted, s_order, 2 * ar + 1, 0)
        # left(i) -- left(j): revcomp(prefix_prev) == prefix(j)
        _join(kmer_ops.reverse_complement(r, k), P_sorted, p_order, 2 * ar + 1, 1)

    a = np.concatenate(all_a) if all_a else np.empty(0, np.int64)
    b = np.concatenate(all_b) if all_b else np.empty(0, np.int64)
    return _dedup_port_edges(a, b, n)


def _dedup_port_edges(
    a: np.ndarray, b: np.ndarray, n: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Each undirected edge is discovered from both endpoints; keep the
    first-priority occurrence.  Native one-pass hash dedup when built
    (numpy unique-with-index costs a full sort + stable argsort:
    measured 1.8-3.9 s at 6M edges vs ~0.4 s for the hash pass)."""
    idx = native.dedup_edges(a, b)
    if idx is not None:
        return a[idx], b[idx]
    key = np.minimum(a, b) * (2 * n) + np.maximum(a, b)
    _, first_idx = np.unique(key, return_index=True)
    first_idx.sort()
    return a[first_idx], b[first_idx]


def _candidate_edges_directed(
    unitigs: PackedStrings, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Directed overlap edges i -> j (suffix(i).next == prefix(j), i != j),
    in discovery order (reference GetEdgesOut, lib/core/spss.h:707-727)."""
    P = unitigs.first_kmers(k)
    S = unitigs.last_kmers(k)
    p_order = np.argsort(P, kind="stable")
    P_sorted = P[p_order]
    outs: List[np.ndarray] = []
    ins: List[np.ndarray] = []
    for c in range(4):
        q = kmer_ops.next_kmer(S, k, c)
        lo = np.searchsorted(P_sorted, q, side="left")
        hi = np.searchsorted(P_sorted, q, side="right")
        rows, idx = expand_ranges(lo, hi)
        j = p_order[idx]
        ok = rows != j
        outs.append(rows[ok])
        ins.append(j[ok])
    a = np.concatenate(outs) if outs else np.empty(0, np.int64)
    b = np.concatenate(ins) if ins else np.empty(0, np.int64)
    return a, b


def _break_cycles(succ: np.ndarray, match: np.ndarray | None, oriented: bool) -> np.ndarray:
    """Detects succ-cycles, elects the min-entity leader of each, and cuts
    one edge so every component becomes a chain (replacing union-find
    loop-removal, reference: lib/core/spss.h:877-933,1541-1647)."""
    leaders = None
    from ..parallel import driver as mesh_driver

    # Gate on ENTITY count (2 nodes per entity when oriented) — the
    # convention every other phase uses; gating on the oriented node
    # count would open the mesh at half the measured crossover.
    if mesh_driver.should_use_mesh_graph(
        succ.shape[0] >> 1 if oriented else succ.shape[0]
    ):
        # Distributed leader election: min-label pointer doubling over
        # the mesh (parallel/mesh.sharded_pointer_double_fn).
        ids = np.arange(succ.shape[0], dtype=np.int64)
        labels = (ids >> 1) if oriented else ids
        res = mesh_driver.mesh_pointer_double(succ, labels)
        if res is not None:
            _, _, is_chain, mins = res
            cyc = ~is_chain
            leaders = (
                np.unique(mins[cyc]) if cyc.any() else np.empty(0, np.int64)
            )
    if leaders is None:
        leaders = native.cycle_leaders(succ, oriented)
        if leaders is not None:
            # oriented cycles are discovered once per orientation with the
            # same entity min — collapse mirrors like unique(mins[cyc]) does
            leaders = np.unique(leaders)
    if leaders is None:
        ids = np.arange(succ.shape[0], dtype=np.int64)
        labels = (ids >> 1) if oriented else ids
        _, _, is_chain, mins = pointer_double(succ, labels)
        cyc = ~is_chain
        leaders = np.unique(mins[cyc]) if cyc.any() else np.empty(0, np.int64)
    if leaders.size == 0:
        return succ
    succ = succ.copy()
    if oriented:
        # Cut the match at every leader's left port (reference removes
        # edge_left of the group leader, lib/core/spss.h:1626-1643).  All
        # writes are the constant -1, so the vectorized form is
        # order-independent even if cut ports coincide.
        a = 2 * leaders + 1
        succ[a] = -1
        succ[match[a]] = -1
    else:
        # Cut each leader's outgoing edge (reference:
        # lib/core/spss.h:924-930).
        succ[leaders] = -1
    return succ


def _emit_string_chains(
    unitigs: PackedStrings,
    k: int,
    nodes_sorted: np.ndarray,
    group_starts: np.ndarray,
    oriented: bool,
) -> PackedStrings:
    """Concatenates oriented unitigs along each chain with (k-1)-overlap
    elision (reference GetStringFromPath, lib/core/spss.h:1186-1206)."""
    if nodes_sorted.size == 0:
        return PackedStrings.empty()
    res = native.emit_string_chains(
        unitigs.codes, unitigs.offsets, k, nodes_sorted, group_starts, oriented
    )
    if res is not None:
        return PackedStrings(res[0], res[1])
    n_chains = group_starts.shape[0] - 1
    counts = np.diff(group_starts)
    entity, flip = _entity_flip(nodes_sorted, oriented)
    ulens = unitigs.lengths()[entity]
    group_of = np.repeat(np.arange(n_chains, dtype=np.int64), counts)
    t = np.arange(nodes_sorted.shape[0], dtype=np.int64) - group_starts[group_of]
    contrib = np.where(t == 0, ulens, ulens - (k - 1))

    out_lens = np.zeros(n_chains, dtype=np.int64)
    np.add.at(out_lens, group_of, contrib)
    offsets = np.zeros(n_chains + 1, dtype=np.int64)
    np.cumsum(out_lens, out=offsets[1:])

    contrib_cum = np.cumsum(contrib) - contrib
    chain_base = contrib_cum[group_starts[:-1]]
    node_out_start = offsets[group_of] + (contrib_cum - chain_base[group_of])

    total = int(offsets[-1])
    node_of_char = np.repeat(np.arange(nodes_sorted.shape[0]), contrib)
    within = np.arange(total, dtype=np.int64) - node_out_start[node_of_char]
    skip = np.where(t[node_of_char] == 0, 0, k - 1)
    src = within + skip
    ent_c = entity[node_of_char]
    fwd_idx = unitigs.offsets[ent_c] + src
    rev_idx = unitigs.offsets[ent_c + 1] - 1 - src
    use_rev = flip[node_of_char]
    gather_idx = np.where(use_rev, rev_idx, fwd_idx)
    vals = unitigs.codes[gather_idx].astype(np.int64)
    vals = np.where(use_rev, 3 - vals, vals)
    return PackedStrings(vals.astype(np.uint8), offsets)


def _take_strings(ps: PackedStrings, idx: np.ndarray) -> PackedStrings:
    if idx.size == 0:
        return PackedStrings.empty()
    lens = ps.lengths()[idx]
    offsets = np.zeros(idx.size + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    lo, hi = ps.offsets[idx], ps.offsets[idx + 1]
    codes = native.gather_ranges(ps.codes, lo, hi)
    if codes is None:
        _, within = expand_ranges(lo, hi)
        codes = ps.codes[within]
    return PackedStrings(codes, offsets)


def _emit_matched_paths(
    unitigs: PackedStrings, k: int, succ: np.ndarray
) -> PackedStrings:
    """Emits all maximal paths of a bidirected matched graph, with the
    start-index <= end-index dedup rule (reference:
    lib/core/spss.h:1649-1831)."""
    matched = succ >= 0
    has_right = matched[0::2]
    has_left = matched[1::2]
    both_free = ~has_left & ~has_right
    starts_r = np.flatnonzero(~has_left & has_right) * 2
    starts_l = np.flatnonzero(~has_right & has_left) * 2 + 1
    starts = np.concatenate([starts_r, starts_l])
    nodes, groups = _chains_grouped(succ, starts, oriented=True)
    firsts, lasts, nonempty = _group_endpoints(nodes, groups)
    keep = nonempty & ((firsts >> 1) <= (lasts >> 1))
    nodes_kept, groups_kept = _filter_groups(nodes, groups, keep)
    chains = _emit_string_chains(unitigs, k, nodes_kept, groups_kept, oriented=True)
    solo = _take_strings(unitigs, np.flatnonzero(both_free))
    return _concat_packed([chains, solo])


def get_spss_canonical_from_unitigs(
    unitigs: PackedStrings, k: int, fast: bool = True
) -> PackedStrings:
    """Greedy path cover of the bidirected unitig graph
    (reference: lib/core/spss.h:1039-1858)."""
    n = len(unitigs)
    if n == 0:
        return PackedStrings.empty()
    with _phase("spss: candidate overlap edges"):
        pa, pb = _candidate_port_edges_canonical(unitigs, k)
    with _phase("spss: greedy matching"):
        if not fast:
            match = _sequential_matching(n, pa, pb)
        else:
            match = handshake_matching(pa, pb, 2 * n)

    # Exiting port u continues through the matched partner port and leaves
    # by that node's other side: succ[u] = match[u] ^ 1.
    succ = np.where(match >= 0, match ^ 1, -1)
    if fast:
        with _phase("spss: cycle breaking"):
            succ = _break_cycles(succ, match, oriented=True)
    with _phase("spss: path emission"):
        return _emit_matched_paths(unitigs, k, succ)


def get_spss_from_unitigs(unitigs: PackedStrings, k: int) -> PackedStrings:
    """Greedy path cover of the directed unitig graph
    (reference: lib/core/spss.h:697-1016)."""
    n = len(unitigs)
    if n == 0:
        return PackedStrings.empty()
    ea, eb = _candidate_edges_directed(unitigs, k)
    # Ports: out-port of i = 2i, in-port of j = 2j+1; the matching enforces
    # <=1 selected out- and in-edge per node (reference:
    # lib/core/spss.h:796-817).
    match = handshake_matching(2 * ea, 2 * eb + 1, 2 * n)
    succ = np.where(match[0::2] >= 0, match[0::2] >> 1, -1)
    succ = _break_cycles(succ, None, oriented=False)

    has_in = np.zeros(n, dtype=bool)
    has_in[succ[succ >= 0]] = True
    starts = np.flatnonzero(~has_in)
    nodes, groups = _chains_grouped(succ, starts)
    return _emit_string_chains(unitigs, k, nodes, groups, oriented=False)


# ---------------------------------------------------------------------------
# Top-level entry points (reference: lib/core/spss.h:1018-1036,1834-1858)
# ---------------------------------------------------------------------------


def get_spss(kmer_set: KmerSet) -> PackedStrings:
    unitigs = get_unitigs(kmer_set)
    return get_spss_from_unitigs(unitigs, kmer_set.k)


def get_spss_canonical(kmer_set: KmerSet, fast: bool = True) -> PackedStrings:
    unitigs = get_unitigs_canonical(kmer_set)
    return get_spss_canonical_from_unitigs(unitigs, kmer_set.k, fast)


def decode_unique_kmers(spss: PackedStrings, k: int, canonical: bool) -> np.ndarray:
    """Sorted distinct (canonical) k-mers of an SPSS — the decode
    direction (reference: lib/core/spss.h:1862-1941).  Large decodes run
    the device counting pipeline at cutoff 1 under the link-aware offload
    policy (ops/backend.py); otherwise host extract + unique."""
    from ..ops import backend
    from ..parallel import driver

    n_windows = int(spss.codes.shape[0]) - k + 1
    if n_windows > 0 and driver.should_use_mesh(n_windows):
        res = driver.mesh_count(
            spss.codes, spss.offsets, k, canonical, need_counts=False
        )
        if res is not None:
            return res[0]
    if n_windows > 0 and backend.should_use_device_chunked(n_windows, k):
        # Out-of-core single chip: chunked unique + keys-only run merge.
        uniq = backend.device_unique_chunked(
            spss.codes, spss.offsets, k, canonical
        )
        if uniq is not None:
            return uniq
    if n_windows > 0 and backend.should_use_device(n_windows, k=k):
        uniq = backend.device_unique(spss.codes, spss.offsets, k, canonical)
        if uniq is not None:
            return uniq
    from .arrays import sorted_unique

    return sorted_unique(spss.all_kmers(k, canonical))


def get_kmer_set_from_spss(spss: PackedStrings, k: int, canonical: bool) -> KmerSet:
    """Decode: sliding k-windows over every string
    (reference: lib/core/spss.h:1862-1941)."""
    return KmerSet(k, decode_unique_kmers(spss, k, canonical), _sorted=True)


# ---------------------------------------------------------------------------
# Sequential reference-quality matching (fast=false) for spss-benchmark
# ---------------------------------------------------------------------------


def _sequential_matching(n: int, pa: np.ndarray, pb: np.ndarray) -> np.ndarray:
    """Single-threaded greedy path extension, the reference's
    higher-quality mode (reference: lib/core/spss.h:1208-1356).  Exists for
    the spss-benchmark A/B comparison; native one-pass C when available
    (the Python loop below is its byte-identical specification)."""
    nm = native.seq_match(pa, pb, n)
    if nm is not None:
        return nm
    adj: List[List[int]] = [[] for _ in range(2 * n)]
    for a, b in zip(pa.tolist(), pb.tolist()):
        adj[a].append(b)
        adj[b].append(a)
    match = np.full(2 * n, -1, dtype=np.int64)

    for i in range(n):
        if match[2 * i] >= 0 or match[2 * i + 1] >= 0:
            continue
        if adj[2 * i]:
            port = 2 * i
        elif adj[2 * i + 1]:
            port = 2 * i + 1
        else:
            continue
        while True:
            if match[port] >= 0:
                break
            nxt = -1
            for q in adj[port]:
                if (q >> 1) == i:  # would close a loop with the path start
                    continue
                if match[q] >= 0:
                    continue
                nxt = q
                break
            if nxt < 0:
                break
            match[port] = nxt
            match[nxt] = port
            port = nxt ^ 1
    return match
