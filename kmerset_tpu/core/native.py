"""ctypes bindings for the native kmerio data loader (native/kmerio.c).

Falls back silently to the NumPy paths when the shared library has not
been built (`make -C native`); every caller treats this module as an
optional accelerator, never a requirement.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _find_lib() -> Optional[str]:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for cand in (
        os.path.join(here, "native", "libkmerio.so"),
        os.path.join(os.path.dirname(__file__), "libkmerio.so"),
    ):
        if os.path.exists(cand):
            return cand
    return None


_GET_LIB_LOCK = threading.Lock()


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _GET_LIB_LOCK:
        return _get_lib_locked()


def _get_lib_locked() -> Optional[ctypes.CDLL]:
    """First-use load/build under _GET_LIB_LOCK: without it, a thread
    arriving during another's in-flight `make` (up to 300 s on a fresh
    checkout) would see _TRIED=True with _LIB still None and silently
    run a whole phase on the 10-50x slower numpy fallback."""
    global _LIB, _TRIED
    if _TRIED:  # the thread that held the lock finished the load
        return _LIB
    _TRIED = True
    # Fresh/stale checkouts: build the library on first use rather than
    # silently running the (complete but slower) fallback paths.
    from kmerset_tpu._nativebuild import ensure_built

    ensure_built("libkmerio.so", ["kmerio.c"])
    path = _find_lib()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        # Stale-build guard: per-symbol presence checks below cannot see
        # signature changes (e.g. the side-table editions' void -> long
        # status return), so any ABI mismatch disables the lib entirely —
        # rebuild with `make -C native`.
        lib.kmerio_abi_version.restype = ctypes.c_long
        if lib.kmerio_abi_version() != 3:
            return None
        lib.kmerio_parse_fasta.restype = ctypes.c_long
        lib.kmerio_parse_fasta.argtypes = [
            ctypes.c_char_p,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
        ]
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.kmerio_pack2.restype = None
        lib.kmerio_pack2.argtypes = [u8p, ctypes.c_long, u8p]
        lib.kmerio_unpack2.restype = None
        lib.kmerio_unpack2.argtypes = [u8p, ctypes.c_long, u8p]
        _LIB = lib
    except (OSError, AttributeError):  # missing lib or stale build
        _LIB = None
    return _LIB


def set_threads(n: int) -> bool:
    """Sizes the native OpenMP pool from the CLI --workers flag
    (reference thread-pool sizing, lib/flags.h:25-53; default 1 keeps the
    reference's single-threaded default).  Returns False when the native
    library is unavailable (the NumPy fallbacks are single-threaded
    anyway)."""
    lib = get_lib()
    if lib is None:
        return False
    try:
        lib.kmerio_set_threads(ctypes.c_int(int(n)))
        return True
    except AttributeError:  # stale library without the symbol
        return False


def parse_fasta_bytes(data: bytes) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """One native pass: FASTA text -> (codes, fragment offsets).

    Returns None if the native library is unavailable; raises ValueError on
    malformed FASTA (same conditions as the reference,
    lib/core/kmer_counter.h:161-209)."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(data)
    codes = np.empty(max(n, 1), dtype=np.uint8)
    offsets = np.zeros(n + 2, dtype=np.int64)
    rc = lib.kmerio_parse_fasta(
        data,
        n,
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc == -1:
        raise ValueError("FASTA files should have an even number of lines")
    if rc in (-2, -3):
        raise ValueError("invalid FASTA file")
    n_frag = int(rc)
    n_codes = int(offsets[n_frag]) if n_frag else 0
    return codes[:n_codes].copy(), offsets[: n_frag + 1].copy()


def pack2(codes: np.ndarray) -> np.ndarray:
    """2-bit pack (4 bases/byte); numpy fallback when no native lib."""
    lib = get_lib()
    # Coerce like every other wrapper: the C kernel reads raw uint8
    # bytes, so a strided or wider-dtype caller array would silently
    # pack garbage.
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = codes.shape[0]
    out = np.zeros((n + 3) // 4, dtype=np.uint8)
    if lib is not None and n:
        lib.kmerio_pack2(
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return out
    for sh in range(4):
        part = codes[sh::4]
        out[: part.shape[0]] |= part << (sh * 2)
    return out


def unpack2(packed: np.ndarray, n: int) -> np.ndarray:
    lib = get_lib()
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    out = np.empty(n, dtype=np.uint8)
    if lib is not None and n:
        lib.kmerio_unpack2(
            packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return out
    for sh in range(4):
        vals = (packed >> (sh * 2)) & 3
        out[sh::4] = vals[: out[sh::4].shape[0]]
    return out


def chain_walk(succ: np.ndarray, starts: np.ndarray):
    """Sequential C walk of successor chains (reference walk loops,
    lib/core/spss.h:394-423).  Returns (nodes, group_starts) with the
    chains concatenated in `starts` order, or None without the native lib."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_chain_walk_ready"):
        try:
            lib.kmerio_chain_walk.restype = ctypes.c_long
            lib.kmerio_chain_walk.argtypes = [
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_long,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_long,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_uint8),
            ]
            lib._cw = True
        except AttributeError:  # stale build: fall back, don't raise
            lib._cw = False
        lib._chain_walk_ready = True
    if not lib._cw:
        return None
    succ = np.ascontiguousarray(succ, dtype=np.int64)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    n = succ.shape[0]
    nodes = np.empty(n, dtype=np.int64)
    groups = np.empty(starts.shape[0] + 1, dtype=np.int64)
    visited = np.zeros(n, dtype=np.uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    total = lib.kmerio_chain_walk(
        succ.ctypes.data_as(i64p),
        n,
        starts.ctypes.data_as(i64p),
        starts.shape[0],
        nodes.ctypes.data_as(i64p),
        groups.ctypes.data_as(i64p),
        visited.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if total < 0:
        # succ violated the chain contract (cycle / revisits): the C walk
        # refuses rather than overrun; let the caller's fallback handle it.
        return None
    return nodes[:total], groups


def chain_walk_kept(
    succ: np.ndarray, starts: np.ndarray, keep_fn
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Canonical-dedup chain walk: pass 1 measures every start's chain
    (length + end node), `keep_fn(starts, ends)` picks the orientation
    winners (reference skip rule, lib/core/spss.h:511,555), pass 2 emits
    only kept chains — 3n visits vs the 4n of walk-everything-and-filter.
    Returns (nodes, group_starts) over kept chains in `starts` order, or
    None without the native lib."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_chain_kept_ready"):
        i64p = ctypes.POINTER(ctypes.c_int64)
        try:
            lib.kmerio_chain_lens_ends.restype = None
            lib.kmerio_chain_lens_ends.argtypes = [
                i64p, ctypes.c_long, i64p, ctypes.c_long, i64p, i64p,
            ]
            lib.kmerio_chain_emit.restype = ctypes.c_long
            lib.kmerio_chain_emit.argtypes = [
                i64p, ctypes.c_long, i64p, ctypes.c_long, i64p, i64p, i64p,
            ]
        except AttributeError:  # stale lib without the new symbols
            return None
        try:
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.kmerio_chain_pairs.restype = ctypes.c_long
            lib.kmerio_chain_pairs.argtypes = [
                i64p, ctypes.c_long, i64p, ctypes.c_long, u8p,
                i64p, i64p, i64p,
            ]
            lib._chain_pairs = True
        except AttributeError:
            lib._chain_pairs = False
        lib._chain_kept_ready = True
    succ = np.ascontiguousarray(succ, dtype=np.int64)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    n = succ.shape[0]
    ns = starts.shape[0]
    i64p = ctypes.POINTER(ctypes.c_int64)
    if lib._chain_pairs:
        # Mirror-dedup pass 1 (each chain pair measured once: n visits,
        # not 2n), then the orientation winner per pair is emitted.
        seen = np.zeros(n, dtype=np.uint8)
        s_arr = np.empty(ns, dtype=np.int64)
        e_arr = np.empty(ns, dtype=np.int64)
        l_arr = np.empty(ns, dtype=np.int64)
        nc = lib.kmerio_chain_pairs(
            succ.ctypes.data_as(i64p), n,
            starts.ctypes.data_as(i64p), ns,
            seen.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            s_arr.ctypes.data_as(i64p), e_arr.ctypes.data_as(i64p),
            l_arr.ctypes.data_as(i64p),
        )
        if nc < 0:
            # A start led into a cycle (chain-contract violation):
            # dropping it would silently lose k-mers — fall back.
            return None
        s_arr, e_arr, l_arr = s_arr[:nc], e_arr[:nc], l_arr[:nc]
        keep = keep_fn(s_arr, e_arr)
        kept = np.ascontiguousarray(np.where(keep, s_arr, e_arr ^ 1))
        kept_lens = l_arr
    else:
        lens = np.empty(ns, dtype=np.int64)
        ends = np.empty(ns, dtype=np.int64)
        lib.kmerio_chain_lens_ends(
            succ.ctypes.data_as(i64p), n,
            starts.ctypes.data_as(i64p), ns,
            lens.ctypes.data_as(i64p), ends.ctypes.data_as(i64p),
        )
        keep = keep_fn(starts, ends)
        kept = np.ascontiguousarray(starts[keep])
        kept_lens = lens[keep]
    groups = np.zeros(kept.shape[0] + 1, dtype=np.int64)
    np.cumsum(kept_lens, out=groups[1:])
    nodes = np.empty(int(groups[-1]), dtype=np.int64)
    # group_starts = groups[:-1], group_ends = groups[1:] (views into the
    # same contiguous prefix array; the C side bounds every write).
    rc = lib.kmerio_chain_emit(
        succ.ctypes.data_as(i64p), n,
        kept.ctypes.data_as(i64p), kept.shape[0],
        groups.ctypes.data_as(i64p),
        groups[1:].ctypes.data_as(i64p),
        nodes.ctypes.data_as(i64p),
    )
    if rc < 0:
        # A kept walk violated its measured length (e.g. a succ array
        # that is not mirror-symmetric): refuse rather than emit a
        # corrupt buffer; the caller's fallback walk handles it.
        return None
    return nodes, groups


def greedy_match(
    pa: np.ndarray, pb: np.ndarray, n_ports: int
) -> Optional[np.ndarray]:
    """Priority-ordered greedy maximal matching in one O(E) C pass
    (native/kmerio.c kmerio_greedy_match) — provably identical to the
    handshake-rounds result with edge-index priorities.  Returns
    match[port] (or -1), or None without the lib."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_gm_ready"):
        i64p = ctypes.POINTER(ctypes.c_int64)
        try:
            lib.kmerio_greedy_match.restype = None
            lib.kmerio_greedy_match.argtypes = [
                i64p, i64p, ctypes.c_long, i64p,
            ]
        except AttributeError:  # stale lib
            return None
        lib._gm_ready = True
    pa = np.ascontiguousarray(pa, dtype=np.int64)
    pb = np.ascontiguousarray(pb, dtype=np.int64)
    if pb.shape[0] != pa.shape[0]:
        return None  # C reads pb[0..len(pa)): mismatched lengths would OOB
    match = np.full(n_ports, -1, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.kmerio_greedy_match(
        pa.ctypes.data_as(i64p), pb.ctypes.data_as(i64p),
        pa.shape[0], match.ctypes.data_as(i64p),
    )
    return match


def revcomp(kmers: np.ndarray, k: int) -> Optional[np.ndarray]:
    """Native reverse complement; None without the lib."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_rc_ready"):
        lib.kmerio_revcomp.restype = None
        lib.kmerio_revcomp.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_long,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib._rc_ready = True
    kmers = np.ascontiguousarray(kmers, dtype=np.int64)
    out = np.empty_like(kmers)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.kmerio_revcomp(
        kmers.ctypes.data_as(i64p), kmers.size, k, out.ctypes.data_as(i64p)
    )
    return out


def window_pack(codes: np.ndarray, k: int) -> Optional[np.ndarray]:
    """Native rolling window pack; None without the lib."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_wp_ready"):
        lib.kmerio_window_pack.restype = None
        lib.kmerio_window_pack.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_long,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib._wp_ready = True
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = codes.shape[0]
    out = np.empty(max(n - k + 1, 0), dtype=np.int64)
    if out.size:
        lib.kmerio_window_pack(
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n,
            k,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
    return out


def emit_kmer_chains(
    A: np.ndarray, k: int, nodes: np.ndarray, groups: np.ndarray, oriented: bool
):
    """Native one-pass unitig emission (reference ConcatenateKmers,
    lib/core/spss.h:25-41); returns (codes, offsets) or None."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_emit_ready"):
        lib.kmerio_emit_kmer_chains.restype = None
        lib.kmerio_emit_kmer_chains.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_long,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib._emit_ready = True
    A = np.ascontiguousarray(A, dtype=np.int64)
    nodes = np.ascontiguousarray(nodes, dtype=np.int64)
    groups = np.ascontiguousarray(groups, dtype=np.int64)
    n_groups = groups.shape[0] - 1
    total = int(nodes.shape[0]) + n_groups * (k - 1)
    codes = np.empty(max(total, 1), dtype=np.uint8)
    offsets = np.empty(n_groups + 1, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.kmerio_emit_kmer_chains(
        A.ctypes.data_as(i64p),
        k,
        nodes.ctypes.data_as(i64p),
        groups.ctypes.data_as(i64p),
        n_groups,
        1 if oriented else 0,
        offsets.ctypes.data_as(i64p),
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    # Slice to the C function's own final offset: `total` above is an
    # allocation upper bound that over-counts (k-1) per EMPTY group
    # (offsets[g+1] == offsets[g]); returning the inflated slice would
    # carry uninitialized tail bytes into PackedStrings concatenation.
    return codes[: int(offsets[-1])], offsets


# Grow-only scratch for the partitioned side tables (see side_tables);
# the lock also serializes the C call that uses it (ctypes releases the
# GIL, so two threads could otherwise share the buffer mid-flight).
_part_lock = threading.Lock()
_part_scratch: Optional[np.ndarray] = None
_part_seen = False


def side_tables(A: np.ndarray, k: int, canonical: bool, impl: str = "auto"):
    """Native hash-probe side tables (reference: lib/core/spss.h:238-313);
    returns ((rdeg, rnbr, rsame), (ldeg, lnbr, lsame)) or None.

    impl: "auto" picks the cache-blocked partitioned edition for large
    canonical inputs (probes stream through L2-resident table regions
    instead of random DRAM reads) and the fp edition otherwise; "part" /
    "fp" force a specific edition (parity tests)."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_st_ready"):
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.kmerio_side_tables.restype = ctypes.c_long
        lib.kmerio_side_tables.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_long,
            ctypes.c_int,
            ctypes.c_int,
            i32p,
            ctypes.c_int,
            i32p, i32p, u8p,
            i32p, i32p, u8p,
        ]
        # Merge-join edition (half the probes become sequential merges);
        # absent in stale builds -> fall back to the hash version.
        try:
            lib.kmerio_side_tables_merge.restype = ctypes.c_long
            lib.kmerio_side_tables_merge.argtypes = (
                lib.kmerio_side_tables.argtypes
            )
            lib._st_merge = True
        except AttributeError:
            lib._st_merge = False
        # fp edition (packed single-read probe table, fused candidates).
        try:
            lib.kmerio_side_tables_fp.restype = ctypes.c_long
            lib.kmerio_side_tables_fp.argtypes = (
                lib.kmerio_side_tables.argtypes[:4]
                + [ctypes.POINTER(ctypes.c_uint64)]
                + lib.kmerio_side_tables.argtypes[5:]
            )
            lib._st_fp = True
        except AttributeError:
            lib._st_fp = False
        # Partitioned edition (cache-blocked probes; bit-identical to fp).
        try:
            lib.kmerio_side_part_scratch.restype = ctypes.c_long
            lib.kmerio_side_part_scratch.argtypes = [
                ctypes.c_long, ctypes.c_int
            ]
            lib.kmerio_side_tables_part.restype = ctypes.c_long
            lib.kmerio_side_tables_part.argtypes = (
                lib.kmerio_side_tables.argtypes[:4]
                + [
                    ctypes.POINTER(ctypes.c_uint64),
                    ctypes.c_int,
                    ctypes.POINTER(ctypes.c_uint8),
                    ctypes.c_int64,
                ]
                + lib.kmerio_side_tables.argtypes[6:]
            )
            lib._st_part = True
        except AttributeError:
            lib._st_part = False
        lib._st_ready = True
    A = np.ascontiguousarray(A, dtype=np.int64)
    n = A.shape[0]
    if n > np.iinfo(np.int32).max:
        # The probe tables and nbr arrays carry int32 indices; past 2^31
        # they would wrap silently (same CSR limitation kmerio_seq_match
        # refuses explicitly) — fall back to the numpy paths.
        return None
    logcap = max(4, int(n * 2 - 1).bit_length())
    # The fp/merge editions only probe for canonical candidates; the
    # directed case never touches the table, so skip the >= 16n-byte
    # allocation + memset entirely (a dummy slot keeps the ABI happy).
    fast = lib._st_fp or lib._st_merge
    table_slots = (1 << logcap) if (canonical or not fast) else 1
    if lib._st_fp:
        # Persistent zeroed scratch (slot 0): a fresh np.zeros at the
        # 2^25-slot / ~268 MB scale pays the first-touch fault storm per
        # call — the repeated-build cost _zeroed_u64 exists to amortize.
        table = (
            _zeroed_u64(logcap)
            if table_slots > 1
            else np.zeros(1, dtype=np.uint64)
        )
        tptr = table.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
        fn = lib.kmerio_side_tables_fp
    else:
        table = np.full(table_slots, -1, dtype=np.int32)
        tptr = table.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        fn = (
            lib.kmerio_side_tables_merge
            if lib._st_merge
            else lib.kmerio_side_tables
        )
    rdeg = np.empty(n, np.int32); rnbr = np.empty(n, np.int32)
    ldeg = np.empty(n, np.int32); lnbr = np.empty(n, np.int32)
    rsame = np.empty(n, np.uint8); lsame = np.empty(n, np.uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    out_ptrs = (
        rdeg.ctypes.data_as(i32p), rnbr.ctypes.data_as(i32p),
        rsame.ctypes.data_as(u8p),
        ldeg.ctypes.data_as(i32p), lnbr.ctypes.data_as(i32p),
        lsame.ctypes.data_as(u8p),
    )
    a_ptr = A.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    # Cache-blocked partitioned probes: pays once the probe table exceeds
    # cache (~1M k-mers); below that the fp edition's table is resident
    # anyway and the partition passes are pure overhead.  The scratch is
    # a process-level grow-only buffer: on this class of virtualized
    # hosts OS first-touch page provisioning costs seconds per GB, so
    # the buffer is provisioned once and reused by every later call
    # (sets shrinking through the multi-set greedy loop would otherwise
    # re-provision per size class).  Auto mode engages from the second
    # qualifying call of the process — a one-shot build's probe savings
    # do not repay the provisioning, repeated builds do.
    use_part = (
        canonical
        and lib._st_part
        and lib._st_fp
        and impl != "fp"
        and (
            impl == "part"
            or (n >= (1 << 20) and not os.environ.get("KMERSET_TPU_NO_PART"))
        )
    )
    if use_part:
        sbytes = int(lib.kmerio_side_part_scratch(n, logcap))
        with _part_lock:
            global _part_scratch, _part_seen
            warm = _part_scratch is not None and _part_scratch.nbytes >= sbytes
            first = not _part_seen
            _part_seen = True
            if impl != "part" and first and not warm:
                use_part = False
            else:
                if not warm:
                    _part_scratch = np.empty(sbytes, dtype=np.uint8)
                scratch = _part_scratch
                rc = lib.kmerio_side_tables_part(
                    a_ptr, n, k, 1, tptr, logcap,
                    scratch.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    scratch.nbytes, *out_ptrs,
                )
                if rc == 0:
                    return (
                        (rdeg, rnbr, rsame.view(bool)),
                        (ldeg, lnbr, lsame.view(bool)),
                    )
                # The failed attempt may have part-filled the probe
                # table; the fp edition below builds into the same
                # buffer, so reset it.
                table[:] = 0
    rc = fn(
        a_ptr, n, k,
        1 if canonical else 0,
        tptr, logcap,
        *out_ptrs,
    )
    if rc != 0:
        # Allocation failure inside the C pass: the zeroed tables would
        # silently classify every k-mer as terminal — fall back instead.
        return None
    # int32/uint8 returned as-is (callers index with them directly);
    # bool views are zero-copy over the uint8 buffers.
    return (
        (rdeg, rnbr, rsame.view(bool)),
        (ldeg, lnbr, lsame.view(bool)),
    )


def seq_match(
    pa: np.ndarray, pb: np.ndarray, n_nodes: int
) -> Optional[np.ndarray]:
    """Native sequential greedy path-extension matching (reference's
    higher-quality mode, lib/core/spss.h:1208-1356), byte-identical to
    core/spss.py::_sequential_matching.  Returns match[2*n_nodes] or
    None."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_sm_ready"):
        try:
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.kmerio_seq_match.restype = ctypes.c_long
            lib.kmerio_seq_match.argtypes = [
                i64p, i64p, ctypes.c_long, ctypes.c_long, i64p,
            ]
            lib._sm = True
        except AttributeError:
            lib._sm = False
        lib._sm_ready = True
    if not lib._sm:
        return None
    pa = np.ascontiguousarray(pa, dtype=np.int64)
    pb = np.ascontiguousarray(pb, dtype=np.int64)
    if pb.shape[0] != pa.shape[0]:
        return None  # C reads pb[0..len(pa)): mismatched lengths would OOB
    match = np.empty(2 * n_nodes, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    rc = lib.kmerio_seq_match(
        pa.ctypes.data_as(i64p), pb.ctypes.data_as(i64p), pa.shape[0],
        n_nodes, match.ctypes.data_as(i64p),
    )
    return match if rc == 0 else None


def walk_cycles(
    succ: np.ndarray, A: np.ndarray, k: int, oriented: bool, visited: np.ndarray
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """One-pass native walk of leftover pure cycles (reference:
    lib/core/spss.h:203-224,583-612), byte-identical to the Python
    fallback's output (same ascending-entity order, same stop rule).
    Mutates `visited`; returns (codes, offsets) or None."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_wc_ready"):
        try:
            i64p = ctypes.POINTER(ctypes.c_int64)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.kmerio_walk_cycles.restype = ctypes.c_long
            lib.kmerio_walk_cycles.argtypes = [
                i64p, i64p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
                u8p, u8p, i64p,
            ]
            lib._wc = True
        except AttributeError:
            lib._wc = False
        lib._wc_ready = True
    if not lib._wc:
        return None
    succ = np.ascontiguousarray(succ, dtype=np.int64)
    A = np.ascontiguousarray(A, dtype=np.int64)
    n_ent = A.shape[0]
    vis = np.ascontiguousarray(visited, dtype=np.uint8)
    m = int(n_ent - np.count_nonzero(vis))
    codes = np.empty(max(m * k, 1), dtype=np.uint8)
    offsets = np.zeros(m + 1, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n_cyc = lib.kmerio_walk_cycles(
        succ.ctypes.data_as(i64p), A.ctypes.data_as(i64p), n_ent, k,
        1 if oriented else 0,
        vis.ctypes.data_as(u8p), codes.ctypes.data_as(u8p),
        offsets.ctypes.data_as(i64p),
    )
    visited[:] = vis.view(bool) if visited.dtype == bool else vis
    return codes[: int(offsets[n_cyc])], offsets[: n_cyc + 1]


def canonical_windows32(
    codes: np.ndarray, offsets: np.ndarray, k: int, canonical: bool
) -> Optional[np.ndarray]:
    """Dense int32 canonical window keys of every in-fragment window
    (k <= 15; the host analogue of the device window pack).  Returns the
    key array or None when the native library is unavailable."""
    if k > 15:
        return None
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_cw_ready"):
        try:
            lib.kmerio_canonical_windows32.restype = ctypes.c_long
            lib.kmerio_canonical_windows32.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_long,
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib._cw = True
        except AttributeError:
            lib._cw = False
        lib._cw_ready = True
    if not lib._cw:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n = codes.shape[0]
    out = np.empty(max(n, 1), dtype=np.int32)
    m = lib.kmerio_canonical_windows32(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        k,
        1 if canonical else 0,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        offsets.shape[0] - 1,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out[:m]


_scratch_tls = threading.local()

# Partitioned succ rebuild engages above this size (below it the fp
# table is cache-resident and the partition passes are pure overhead);
# parity tests lower it to force the partitioned path on small inputs.
_SUCC_PART_MIN = 1 << 20


def _zeroed_u64(logcap: int, slot: int = 0) -> np.ndarray:
    """Zeroed uint64 fp-table scratch.  Large tables (>= 8 MB) reuse a
    persistent per-slot buffer: a fresh np.zeros at multi-hundred-MB
    sizes pays an mmap + first-touch fault storm on the virtualized eval
    host (and the VMA churn the round-3 soak surfaced); an explicit fill
    of a resident buffer streams at memory bandwidth instead.  Slots
    separate tables that are live at the same time (overlap_edges uses
    two); the cache is thread-local so concurrent builds never share a
    buffer."""
    size = 1 << logcap
    if logcap < 20:
        return np.zeros(size, dtype=np.uint64)
    cache = getattr(_scratch_tls, "bufs", None)
    if cache is None:
        cache = _scratch_tls.bufs = {}
    buf = cache.get(slot)
    if buf is None or buf.shape[0] < size:
        # Grow-only: shrinking sets in the multi-set loop alternate
        # logcaps, and replacing a larger cached buffer with a smaller
        # fresh np.zeros would re-pay the first-touch fault storm per
        # size class — the exact cost this cache exists to avoid.  A
        # zeroed prefix view serves any smaller request.
        buf = np.zeros(size, dtype=np.uint64)
        cache[slot] = buf
        return buf
    if buf.shape[0] == size:
        buf.fill(0)
        return buf
    view = buf[:size]
    view.fill(0)
    return view


def succ_from_sides(
    A: np.ndarray, sides: np.ndarray, k: int
) -> Optional[np.ndarray]:
    """Oriented successor array rebuilt from device-shipped per-entity
    side codes (the 1-byte/k-mer wire format of the count->graph fusion;
    see ops/unitigs.device_unitig_sides and kmerio_succ_from_sides).
    One fp probe per non-terminal side.  Large inputs route to the
    cache-blocked partitioned edition (kmerio_succ_from_sides_part,
    bit-identical output; the fp edition's random probes measure
    ~1.3-1.7 s at 16.5M k-mers on the eval host, almost all latency),
    sharing the grow-only partition scratch with side_tables.  Returns
    succ (2n,) int64 with -1 at terminal exits, or None (unbuilt lib /
    stale build / probe miss on corrupt sides / oversized input)."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_sfs_ready"):
        try:
            lib.kmerio_succ_from_sides.restype = ctypes.c_long
            lib.kmerio_succ_from_sides.argtypes = [
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_long,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib._sfs = True
        except AttributeError:  # stale build without the export
            lib._sfs = False
        try:
            lib.kmerio_succ_part_scratch.restype = ctypes.c_long
            lib.kmerio_succ_part_scratch.argtypes = [
                ctypes.c_long, ctypes.c_int
            ]
            lib.kmerio_succ_from_sides_part.restype = ctypes.c_long
            lib.kmerio_succ_from_sides_part.argtypes = [
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_long,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib._sfs_part = True
        except AttributeError:
            lib._sfs_part = False
        lib._sfs_ready = True
    if not lib._sfs:
        return None
    A = np.ascontiguousarray(A, dtype=np.int64)
    sides = np.ascontiguousarray(sides, dtype=np.uint8)
    n = A.shape[0]
    if n == 0:
        return np.empty(0, dtype=np.int64)
    if sides.shape[0] != n or n > (np.iinfo(np.int32).max >> 1):
        return None  # fp slots carry int32 indices; 2n must fit int32s
    use_part = (
        lib._sfs_part
        and n >= _SUCC_PART_MIN
        and not os.environ.get("KMERSET_TPU_NO_PART")
    )
    # The fp edition wants a low load factor (every extra probe is a
    # DRAM miss); the partitioned edition probes cache-resident regions,
    # so a ~50% load halves the table fill + build traffic for ~free.
    logcap = max(
        4,
        int(n + (n >> 1)).bit_length() if use_part
        else int(n * 2 - 1).bit_length(),
    )
    table = _zeroed_u64(logcap)
    succ = np.empty(2 * n, dtype=np.int64)
    a_ptr = A.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    s_ptr = sides.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    t_ptr = table.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
    o_ptr = succ.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    if use_part:
        sbytes = int(lib.kmerio_succ_part_scratch(n, logcap))
        with _part_lock:
            global _part_scratch
            if _part_scratch is None or _part_scratch.nbytes < sbytes:
                _part_scratch = np.empty(sbytes, dtype=np.uint8)
            scratch = _part_scratch
            rc = lib.kmerio_succ_from_sides_part(
                a_ptr, n, k, s_ptr, t_ptr, logcap,
                scratch.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                scratch.nbytes, o_ptr,
            )
        if rc == 0:
            return succ
        if rc == -1:
            return None  # genuine probe miss: corrupt sides
        table[:] = 0  # scratch-shape failure: retry with the fp edition
    rc = lib.kmerio_succ_from_sides(
        a_ptr, n, k, s_ptr, t_ptr, logcap, o_ptr,
    )
    if rc != 0:
        return None
    return succ


def dedup_edges(a: np.ndarray, b: np.ndarray) -> Optional[np.ndarray]:
    """Indices of first occurrences of undirected port edges, ascending
    (kmerio_dedup_edges: one hash pass in discovery order, replacing the
    numpy unique-with-index sort of core/spss._dedup_port_edges).
    Returns int64 indices into a/b, or None (unbuilt/stale lib, ports
    too wide for the 32|32 key packing)."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_de_ready"):
        try:
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.kmerio_dedup_edges.restype = ctypes.c_long
            lib.kmerio_dedup_edges.argtypes = [
                i64p, i64p, ctypes.c_long,
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, i64p,
            ]
            lib._de = True
        except AttributeError:
            lib._de = False
        lib._de_ready = True
    if not lib._de:
        return None
    a = np.ascontiguousarray(a, dtype=np.int64)
    b = np.ascontiguousarray(b, dtype=np.int64)
    m = a.shape[0]
    if m == 0:
        return np.empty(0, dtype=np.int64)
    if b.shape[0] != m:
        return None
    # Key packs both port ids into 32-bit halves.
    if a.min() < 0 or b.min() < 0 or a.max() >= 1 << 32 or b.max() >= 1 << 32:
        return None
    logcap = max(4, int(m * 2 - 1).bit_length())
    table = _zeroed_u64(logcap)
    idx = np.empty(m, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    cnt = lib.kmerio_dedup_edges(
        a.ctypes.data_as(i64p),
        b.ctypes.data_as(i64p),
        m,
        table.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        logcap,
        idx.ctypes.data_as(i64p),
    )
    if cnt < 0:
        return None  # (0,0) edge would alias the empty marker: numpy path
    return idx[:cnt]


def count_hash(codes: np.ndarray, k: int) -> Optional[int]:
    """Reference-style single-thread hash counting (baseline only);
    returns the number of distinct canonical k-mers, or None."""
    if k > 23:
        return None  # keys are stored in a 48-bit field (2k+1 bits needed)
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_ch_ready"):
        lib.kmerio_count_hash.restype = ctypes.c_long
        lib.kmerio_count_hash.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_long,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int,
        ]
        lib._ch_ready = True
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = codes.shape[0]
    logcap = max(4, int(max(n, 1) * 2 - 1).bit_length())
    table = np.zeros(1 << logcap, dtype=np.uint64)
    return int(
        lib.kmerio_count_hash(
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n,
            k,
            table.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            logcap,
        )
    )


# Partitioned overlap join engages above this unitig count (same
# rationale as _SUCC_PART_MIN); parity tests lower it.
_OVERLAP_PART_MIN = 1 << 19


def _overlap_edges_part(lib, P, S, n, k, ptab, stab, logcap):
    """Partitioned overlap probe + discovery-order restore; returns
    (a_ports, b_ports) or None (cap overflow / scratch shape — caller
    falls back to the fp edition)."""
    i64p = ctypes.POINTER(ctypes.c_int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    sbytes = int(lib.kmerio_overlap_part_scratch(n, logcap))
    cap = 8 * n + 1024
    hits = np.empty(cap, dtype=np.int64)
    with _part_lock:
        global _part_scratch
        if _part_scratch is None or _part_scratch.nbytes < sbytes:
            _part_scratch = np.empty(sbytes, dtype=np.uint8)
        scratch = _part_scratch
        m = int(lib.kmerio_overlap_edges_part(
            P.ctypes.data_as(i64p), S.ctypes.data_as(i64p), n, k,
            ptab.ctypes.data_as(u64p), stab.ctypes.data_as(u64p), logcap,
            scratch.ctypes.data_as(u8p), scratch.nbytes, cap,
            hits.ctypes.data_as(i64p),
        ))
    if m < 0:
        return None
    # Packed (pass << 60 | i << 32 | j): an UNSIGNED ascending sort is
    # exactly the fp edition's discovery order.  One C call radix-sorts
    # and unpacks (the numpy sort + shift passes cost ~0.5 s at 6M).
    if hasattr(lib, "kmerio_overlap_sort_unpack") and m > 0:
        if not hasattr(lib, "_osu_ready"):
            u64p2 = ctypes.POINTER(ctypes.c_uint64)
            lib.kmerio_overlap_sort_unpack.restype = None
            lib.kmerio_overlap_sort_unpack.argtypes = [
                u64p2, ctypes.c_long, u64p2, i64p, i64p,
            ]
            lib._osu_ready = True
        sortbuf = np.empty(m, dtype=np.uint64)
        a = np.empty(m, dtype=np.int64)
        b = np.empty(m, dtype=np.int64)
        lib.kmerio_overlap_sort_unpack(
            hits[:m].ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            m,
            sortbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            a.ctypes.data_as(i64p),
            b.ctypes.data_as(i64p),
        )
        return a, b
    h = hits[:m].view(np.uint64)
    h.sort(kind="stable")
    p = (h >> np.uint64(60)).astype(np.int64)
    i = ((h >> np.uint64(32)) & np.uint64(0x0FFFFFFF)).astype(np.int64)
    j = (h & np.uint64(0xFFFFFFFF)).astype(np.int64)
    right = p < 8
    a = 2 * i + ~right
    # bit: right passes alternate ptab(1)/stab(0); left passes
    # alternate stab(0)/ptab(1) — even/odd of the pass index.
    q = np.where(right, p, p - 8)
    bit = np.where(right, 1 - (q & 1), q & 1)
    b = 2 * j + bit
    return a, b


def overlap_edges(P: np.ndarray, S: np.ndarray, k: int):
    """Native unitig overlap-edge discovery (reference hash multimaps,
    lib/core/spss.h:619-695); returns (a_ports, b_ports) in discovery
    order (pre-dedup) or None.

    Large inputs route to the cache-blocked partitioned probe edition
    (kmerio_overlap_edges_part): hits come back as packed
    (pass << 60 | i << 32 | j) in arbitrary order — pass is 4 bits, i
    28 (hence the 16*n < 2^31 guard), j 32 — and an UNSIGNED ascending
    sort (native radix via kmerio_overlap_sort_unpack, np.sort
    fallback) restores the fp edition's exact discovery order:
    pass-major, i-minor, and within one probe the fp multimap walks
    ascending j."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_oe_ready"):
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.kmerio_overlap_edges.restype = ctypes.c_long
        lib.kmerio_overlap_edges.argtypes = [
            i64p, i64p, ctypes.c_long, ctypes.c_int,
            i64p, i64p, ctypes.c_int, ctypes.c_int, i64p,
        ]
        try:
            u64p_ = ctypes.POINTER(ctypes.c_uint64)
            lib.kmerio_overlap_part_scratch.restype = ctypes.c_long
            lib.kmerio_overlap_part_scratch.argtypes = [
                ctypes.c_long, ctypes.c_int
            ]
            lib.kmerio_overlap_edges_part.restype = ctypes.c_long
            lib.kmerio_overlap_edges_part.argtypes = [
                i64p, i64p, ctypes.c_long, ctypes.c_int,
                u64p_, u64p_, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.c_long, i64p,
            ]
            lib._oe_part = True
        except AttributeError:
            lib._oe_part = False
        lib._oe_ready = True
    P = np.ascontiguousarray(P, dtype=np.int64)
    S = np.ascontiguousarray(S, dtype=np.int64)
    n = P.shape[0]
    logcap = max(4, int(max(n, 1) * 2 - 1).bit_length())
    # fp tables are uint64 zero-initialized; the legacy two-pass API
    # reuses the same buffers as int64 filled with -1 (same byte layout).
    ptab = _zeroed_u64(logcap, slot=0)
    stab = _zeroed_u64(logcap, slot=1)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    args = (
        P.ctypes.data_as(i64p), S.ctypes.data_as(i64p), n, k,
        ptab.ctypes.data_as(i64p), stab.ctypes.data_as(i64p), logcap,
    )
    if (
        getattr(lib, "_oe_part", False)
        and n >= _OVERLAP_PART_MIN
        and 16 * n < (1 << 31)
        and not os.environ.get("KMERSET_TPU_NO_PART")
    ):
        res = _overlap_edges_part(lib, P, S, n, k, ptab, stab, logcap)
        if res is not None:
            return res
        # overflow/shape failure: the tables may be part-filled — reset
        # for the fp edition below.
        ptab.fill(0)
        stab.fill(0)
    # Single pass with a generous capacity (8 candidate edges per
    # unitig covers non-degenerate graphs); highly repetitive inputs can
    # exceed any linear bound (edge counts are quadratic per signature
    # class), in which case the two-pass count+fill API runs instead.
    cap_fn = None
    if hasattr(lib, "kmerio_overlap_edges_fp"):
        lib.kmerio_overlap_edges_fp.restype = ctypes.c_long
        lib.kmerio_overlap_edges_fp.argtypes = [
            i64p, i64p, ctypes.c_long, ctypes.c_int,
            u64p, u64p, ctypes.c_int, ctypes.c_long, i64p,
        ]

        def cap_fn(cap, outp):
            return lib.kmerio_overlap_edges_fp(
                P.ctypes.data_as(i64p), S.ctypes.data_as(i64p), n, k,
                ptab.ctypes.data_as(u64p), stab.ctypes.data_as(u64p),
                logcap, cap, outp,
            )

    elif hasattr(lib, "kmerio_overlap_edges_cap"):
        lib.kmerio_overlap_edges_cap.restype = ctypes.c_long
        lib.kmerio_overlap_edges_cap.argtypes = [
            i64p, i64p, ctypes.c_long, ctypes.c_int,
            i64p, i64p, ctypes.c_int, ctypes.c_long, i64p,
        ]
        ptab.fill(np.uint64(2**64 - 1))
        stab.fill(np.uint64(2**64 - 1))

        def cap_fn(cap, outp):
            return lib.kmerio_overlap_edges_cap(*args, cap, outp)

    if cap_fn is not None:
        cap = 8 * n + 1024
        out = np.empty(2 * cap, dtype=np.int64)
        count = cap_fn(cap, out.ctypes.data_as(i64p))
        if count >= 0:
            pairs = out[: 2 * count].reshape(-1, 2)
            return pairs[:, 0], pairs[:, 1]
        ptab.fill(np.uint64(2**64 - 1))
        stab.fill(np.uint64(2**64 - 1))
    else:
        # No fp/cap edition bound at all (nothing pre-filled the tables):
        # the legacy two-pass kernel requires -1-filled tables — its
        # insert loop spins forever on zeros.
        ptab.fill(np.uint64(2**64 - 1))
        stab.fill(np.uint64(2**64 - 1))
    count = lib.kmerio_overlap_edges(*args, 1, None)
    out = np.empty(2 * max(count, 1), dtype=np.int64)
    lib.kmerio_overlap_edges(*args, 0, out.ctypes.data_as(i64p))
    pairs = out[: 2 * count].reshape(-1, 2)
    return pairs[:, 0], pairs[:, 1]


def _bind_sorted_algebra(lib) -> None:
    if not hasattr(lib, "_sa_ready"):
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.kmerio_sorted_algebra.restype = None
        lib.kmerio_sorted_algebra.argtypes = [
            i64p, ctypes.c_long, i64p, ctypes.c_long,
            i64p, i64p, i64p, ctypes.POINTER(ctypes.c_long),
        ]
        lib._sa_ready = True


def sorted_algebra(a: np.ndarray, b: np.ndarray):
    """One-pass (intersection, a_only, b_only) of sorted-unique int64
    arrays (reference set algebra, lib/core/kmer_set.h:164-219), or None."""
    lib = get_lib()
    if lib is None:
        return None
    _bind_sorted_algebra(lib)
    a = np.ascontiguousarray(a, dtype=np.int64)
    b = np.ascontiguousarray(b, dtype=np.int64)
    inter = np.empty(min(a.size, b.size) or 1, dtype=np.int64)
    a_only = np.empty(a.size or 1, dtype=np.int64)
    b_only = np.empty(b.size or 1, dtype=np.int64)
    counts = np.zeros(3, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.kmerio_sorted_algebra(
        a.ctypes.data_as(i64p), a.size,
        b.ctypes.data_as(i64p), b.size,
        inter.ctypes.data_as(i64p),
        a_only.ctypes.data_as(i64p),
        b_only.ctypes.data_as(i64p),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
    )

    def _trim(buf: np.ndarray, n: int) -> np.ndarray:
        # A slice is a view pinning the whole scratch buffer; long-lived
        # callers (the greedy factor loop caches these arrays per set)
        # would otherwise hold pre-split-sized allocations for tiny
        # results.  Copy when most of the buffer is dead.
        out = buf[:n]
        return out.copy() if 2 * n < buf.shape[0] else out

    return (
        _trim(inter, int(counts[0])),
        _trim(a_only, int(counts[1])),
        _trim(b_only, int(counts[2])),
    )


def intersect_size(a: np.ndarray, b: np.ndarray):
    """|a ∩ b| of sorted-unique int64 arrays — kmerio_sorted_algebra in
    count-only mode (NULL outputs), the similarity-sketch kernel
    (reference sorted-merge loop, lib/core/kmer_set_set.h:158-184).
    Returns None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    _bind_sorted_algebra(lib)
    a = np.ascontiguousarray(a, dtype=np.int64)
    b = np.ascontiguousarray(b, dtype=np.int64)
    counts = np.zeros(3, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    null = ctypes.cast(None, i64p)
    lib.kmerio_sorted_algebra(
        a.ctypes.data_as(i64p), a.size,
        b.ctypes.data_as(i64p), b.size,
        null, null, null,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
    )
    return int(counts[0])


def _bind_merge_counts(lib) -> None:
    if not hasattr(lib, "_mc_ready"):
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.kmerio_merge_counts.restype = ctypes.c_long
        lib.kmerio_merge_counts.argtypes = [
            i64p, i64p, ctypes.c_long, i64p, i64p, ctypes.c_long, i64p, i64p,
        ]
        lib._mc_ready = True


def merge_counts(
    ak: np.ndarray, ac: np.ndarray, bk: np.ndarray, bc: np.ndarray
):
    """One-pass merge of two sorted-unique (key, count) runs, summing
    counts of equal keys (the out-of-core chunk combiner; reference's
    bucket merge, lib/core/kmer_counter.h:105-126), or None."""
    lib = get_lib()
    if lib is None:
        return None
    _bind_merge_counts(lib)
    ak = np.ascontiguousarray(ak, dtype=np.int64)
    ac = np.ascontiguousarray(ac, dtype=np.int64)
    bk = np.ascontiguousarray(bk, dtype=np.int64)
    bc = np.ascontiguousarray(bc, dtype=np.int64)
    ok = np.empty(max(ak.size + bk.size, 1), dtype=np.int64)
    oc = np.empty(max(ak.size + bk.size, 1), dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    m = lib.kmerio_merge_counts(
        ak.ctypes.data_as(i64p), ac.ctypes.data_as(i64p), ak.size,
        bk.ctypes.data_as(i64p), bc.ctypes.data_as(i64p), bk.size,
        ok.ctypes.data_as(i64p), oc.ctypes.data_as(i64p),
    )
    return ok[:m], oc[:m]


def merge_keys(ak: np.ndarray, bk: np.ndarray):
    """Sorted union of two sorted-unique int64 arrays (keys-only mode of
    kmerio_merge_counts — the decode-direction chunk combiner), or None."""
    lib = get_lib()
    if lib is None:
        return None
    _bind_merge_counts(lib)
    ak = np.ascontiguousarray(ak, dtype=np.int64)
    bk = np.ascontiguousarray(bk, dtype=np.int64)
    ok = np.empty(max(ak.size + bk.size, 1), dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    m = lib.kmerio_merge_counts(
        ak.ctypes.data_as(i64p), None, ak.size,
        bk.ctypes.data_as(i64p), None, bk.size,
        ok.ctypes.data_as(i64p), None,
    )
    return ok[:m]


def gather_ranges(src: np.ndarray, lo: np.ndarray, hi: np.ndarray):
    """Concatenation of src[lo[i]:hi[i]] slices (uint8 or int64), or None."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_gr_ready"):
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.kmerio_gather_ranges_u8.restype = None
        lib.kmerio_gather_ranges_u8.argtypes = [u8p, i64p, i64p, ctypes.c_long, u8p]
        lib.kmerio_gather_ranges_i64.restype = None
        lib.kmerio_gather_ranges_i64.argtypes = [i64p, i64p, i64p, ctypes.c_long, i64p]
        lib._gr_ready = True
    lo = np.ascontiguousarray(lo, dtype=np.int64)
    hi = np.ascontiguousarray(hi, dtype=np.int64)
    total = int((hi - lo).sum())
    i64p = ctypes.POINTER(ctypes.c_int64)
    if src.dtype == np.uint8:
        src = np.ascontiguousarray(src)
        out = np.empty(max(total, 1), dtype=np.uint8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.kmerio_gather_ranges_u8(
            src.ctypes.data_as(u8p), lo.ctypes.data_as(i64p),
            hi.ctypes.data_as(i64p), lo.size, out.ctypes.data_as(u8p),
        )
    else:
        src = np.ascontiguousarray(src, dtype=np.int64)
        out = np.empty(max(total, 1), dtype=np.int64)
        lib.kmerio_gather_ranges_i64(
            src.ctypes.data_as(i64p), lo.ctypes.data_as(i64p),
            hi.ctypes.data_as(i64p), lo.size, out.ctypes.data_as(i64p),
        )
    return out[:total]


def unitig_succ_from_tables(tables) -> Optional[Tuple]:
    """(succ, term_l, term_r, both) from side tables, in one C pass."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_us_ready"):
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.kmerio_unitig_succ.restype = None
        lib.kmerio_unitig_succ.argtypes = [
            i32p, i32p, u8p, i32p, i32p, u8p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int64), u8p, u8p, u8p,
        ]
        lib._us_ready = True
    (rdeg, rnbr, rsame), (ldeg, lnbr, lsame) = tables
    n = rdeg.shape[0]
    args32 = [
        np.ascontiguousarray(x, dtype=np.int32) for x in (rdeg, rnbr, ldeg, lnbr)
    ]
    argsu8 = [
        np.ascontiguousarray(x, dtype=np.uint8) for x in (rsame, lsame)
    ]
    succ = np.empty(2 * n, dtype=np.int64)
    term_l = np.empty(n, dtype=np.uint8)
    term_r = np.empty(n, dtype=np.uint8)
    both = np.empty(n, dtype=np.uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.kmerio_unitig_succ(
        args32[0].ctypes.data_as(i32p), args32[1].ctypes.data_as(i32p),
        argsu8[0].ctypes.data_as(u8p),
        args32[2].ctypes.data_as(i32p), args32[3].ctypes.data_as(i32p),
        argsu8[1].ctypes.data_as(u8p), n,
        succ.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        term_l.ctypes.data_as(u8p), term_r.ctypes.data_as(u8p),
        both.ctypes.data_as(u8p),
    )
    return succ, term_l.view(bool), term_r.view(bool), both.view(bool)


def pack_rows(codes: np.ndarray, offsets: np.ndarray, k: int, from_end: bool):
    """Packed k-prefix/suffix of every string, or None."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_pr_ready"):
        lib.kmerio_pack_rows.restype = None
        lib.kmerio_pack_rows.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_long,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib._pr_ready = True
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n = offsets.shape[0] - 1
    out = np.empty(max(n, 1), dtype=np.int64)
    lib.kmerio_pack_rows(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, k, 1 if from_end else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out[:n]


def emit_string_chains(
    codes: np.ndarray,
    uoffsets: np.ndarray,
    k: int,
    nodes: np.ndarray,
    groups: np.ndarray,
    oriented: bool,
):
    """Native SPSS string emission (reference GetStringFromPath,
    lib/core/spss.h:1186-1206); returns (codes, offsets) or None."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_esc_ready"):
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.kmerio_emit_string_chains.restype = None
        lib.kmerio_emit_string_chains.argtypes = [
            u8p, i64p, ctypes.c_int, i64p, i64p, ctypes.c_long,
            ctypes.c_int, i64p, u8p,
        ]
        lib._esc_ready = True
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    uoffsets = np.ascontiguousarray(uoffsets, dtype=np.int64)
    nodes = np.ascontiguousarray(nodes, dtype=np.int64)
    groups = np.ascontiguousarray(groups, dtype=np.int64)
    n_groups = groups.shape[0] - 1
    ent = (nodes >> 1) if oriented else nodes
    lens = uoffsets[ent + 1] - uoffsets[ent]
    n_skips = int(np.maximum(np.diff(groups) - 1, 0).sum())
    total = int(lens.sum()) - n_skips * (k - 1)
    out = np.empty(max(total, 1), dtype=np.uint8)
    offsets = np.empty(n_groups + 1, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.kmerio_emit_string_chains(
        codes.ctypes.data_as(u8p), uoffsets.ctypes.data_as(i64p), k,
        nodes.ctypes.data_as(i64p), groups.ctypes.data_as(i64p), n_groups,
        1 if oriented else 0, offsets.ctypes.data_as(i64p),
        out.ctypes.data_as(u8p),
    )
    return out[:total], offsets


def cycle_leaders(succ: np.ndarray, oriented: bool):
    """Min-label leader of every cycle of the matched port graph, or None
    (native one-pass walk replacing pointer-doubling leader election,
    reference union-find loop removal: lib/core/spss.h:877-933,1541-1647)."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_cl_ready"):
        try:
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.kmerio_cycle_leaders.restype = ctypes.c_long
            lib.kmerio_cycle_leaders.argtypes = [
                i64p,
                ctypes.c_long,
                ctypes.c_int,
                i64p,
            ]
        except AttributeError:  # stale libkmerio.so without this symbol
            return None
        lib._cl_ready = True
    succ = np.ascontiguousarray(succ, dtype=np.int64)
    # one leader per cycle; cycles have length >= 1 so n bounds the count
    out = np.empty(max(succ.size, 1), dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    cnt = lib.kmerio_cycle_leaders(
        succ.ctypes.data_as(i64p), succ.size, int(oriented),
        out.ctypes.data_as(i64p),
    )
    if cnt < 0:
        return None
    return out[:cnt]


def delta_decode(
    d: np.ndarray, exc: np.ndarray, n_exc: int
) -> Optional[np.ndarray]:
    """Patched-cumsum reconstruction of a gap-encoded sorted key array
    (ops/deltas.py wire format; kmerio_delta_decode).  d: (n,) uint8 or
    uint16 deltas; exc: (m, 2) int64 ascending (position, true delta)
    rows, first n_exc rows live.  Returns the int64 keys, or None
    (unbuilt lib / stale build / positions out of order / decoded
    sequence not strictly increasing — positional corruption)."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_dd_ready"):
        try:
            lib.kmerio_delta_decode.restype = ctypes.c_long
            lib.kmerio_delta_decode.argtypes = [
                ctypes.c_void_p,
                ctypes.c_int,
                ctypes.c_long,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_long,
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib._dd = True
        except AttributeError:  # stale build without the export
            lib._dd = False
        lib._dd_ready = True
    if not lib._dd:
        return None
    if d.dtype == np.uint8:
        width = 1
    elif d.dtype == np.uint16:
        width = 2
    else:
        return None
    d = np.ascontiguousarray(d)
    exc = np.ascontiguousarray(exc[:n_exc], dtype=np.int64)
    out = np.empty(d.shape[0], dtype=np.int64)
    rc = lib.kmerio_delta_decode(
        d.ctypes.data_as(ctypes.c_void_p),
        width,
        d.shape[0],
        exc.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_exc,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        return None
    return out
